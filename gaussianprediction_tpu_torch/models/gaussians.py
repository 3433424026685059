"""Gaussian model state and activations.

Torch twin of gaussianprediction_tpu/models/gaussians.py. The state keeps
the JAX package's capacity padding: `params` holds [C, ...] tensors (and
the deform MLP as a list of {"w", "b"} layers) and `alive` marks the live
rows. Conventions are the reference's: scaling stored as log (exp
activation), opacity as logit (sigmoid), rotation unnormalized wxyz,
SH split into dc/rest; the keypoints ("super Gaussians") of stages 2/3
sit in a second padded buffer with their own mask, `kpt_alive`. The
densification statistics ride on the state as in the JAX package;
create_from_pcd builds the parameters from a point cloud, the blend-weight
model of stages 2/3 (hash tables and weight MLP) included, and convert.py
builds states from the JAX package's arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from gaussianprediction_tpu_torch.config import Config

STATS = ("xyz_gradient_accum", "xyz_gradient_accum_max", "denom",
         "max_radii2D", "xyz_motion_accum_max", "motion_denom")


@dataclasses.dataclass
class GaussianState:
    """Params, alive masks and the densification statistics ([C] each,
    zeros when not given; max_radii2D int32, the rest float32)."""

    params: Dict[str, Any]
    alive: torch.Tensor                      # [C] bool
    kpt_alive: Optional[torch.Tensor] = None  # [Ck] bool (stages 2/3)
    xyz_gradient_accum: Optional[torch.Tensor] = None
    xyz_gradient_accum_max: Optional[torch.Tensor] = None
    denom: Optional[torch.Tensor] = None
    max_radii2D: Optional[torch.Tensor] = None
    xyz_motion_accum_max: Optional[torch.Tensor] = None
    motion_denom: Optional[torch.Tensor] = None

    def __post_init__(self):
        for name in STATS:
            if getattr(self, name) is None:
                dt = torch.int32 if name == "max_radii2D" else torch.float32
                setattr(self, name, torch.zeros(
                    self.alive.shape, dtype=dt, device=self.alive.device))

    def replace(self, **changes) -> "GaussianState":
        return dataclasses.replace(self, **changes)

    @property
    def capacity(self) -> int:
        return self.params["xyz"].shape[0]

    @property
    def kpt_capacity(self) -> int:
        return self.params["super_xyz"].shape[0]

    @property
    def device(self) -> torch.device:
        return self.params["xyz"].device

    def n_alive(self):
        return torch.sum(self.alive)

    def n_kpts(self):
        return torch.sum(self.kpt_alive)


def scaling_act(s):
    return torch.exp(s)


def opacity_act(o):
    return torch.sigmoid(o)


def rotation_act(q):
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True),
                           min=1e-12)


def get_shs(params):
    """[C, 3, B] SH coefficients from the dc/rest split (coefficient axis
    last, as eval_sh takes them)."""
    feats = torch.cat([params["features_dc"], params["features_rest"]], dim=1)
    return feats.transpose(1, 2)


def deform_input_dims(cfg: Config):
    time_dim = 2 * cfg.opt.time_freq
    xyz_dim = 6 * cfg.opt.xyz_freq
    return time_dim, xyz_dim


def deform_mlp_sizes(cfg: Config):
    """Layer widths of the deform MLP: [time+xyz+feature] + [w]*d + [7|8]."""
    time_dim, xyz_dim = deform_input_dims(cfg)
    delta_dim = 8 if cfg.model.step_opacity else 7
    return ([time_dim + xyz_dim + cfg.model.feature_dim]
            + [cfg.model.w] * cfg.model.d + [delta_dim])


def weight_model(cfg: Config, rng: np.random.Generator):
    """The blend-weight model of stages 2/3, drawn with numpy: (hash
    tables {"level_l": [size_l, F]}, weight MLP [L*F] + [64]*2 + [2K]).
    Only the `hashgrid` encoder is ported; `brick` and `fourier` raise."""
    from gaussianprediction_tpu_torch.ops.hashgrid import init_hashgrid
    from gaussianprediction_tpu_torch.ops.mlp import init_mlp

    m = cfg.model
    if m.weight_encoder != "hashgrid":
        raise NotImplementedError(
            f"weight_encoder={m.weight_encoder!r} is not ported yet "
            "(ROADMAP.md, Queue 1)")
    tables = init_hashgrid(rng, n_levels=m.hash_levels,
                           n_features=m.hash_features, log2_T=m.hash_log2_T,
                           n_min=m.hash_min_res, max_res=m.hash_max_res)
    n_feat = sum(t.shape[1] for t in tables.values())
    mlp = init_mlp(rng, [n_feat] + [m.weight_mlp_width] * m.weight_mlp_depth
                   + [2 * m.nearest_num])
    return tables, mlp


def create_from_pcd(cfg: Config, points: np.ndarray, colors: np.ndarray,
                    generator: Optional[torch.Generator] = None,
                    motion_feature=None, df_mlp=None, hash_tables=None,
                    weight_mlp=None, device=None) -> GaussianState:
    """The model from a point cloud, padded to capacity (the JAX package's
    create_from_pcd): the first min(len(points), C) rows alive, scales
    log(sqrt(mean squared distance to the 3 nearest points)), SH dc from
    the colours, identity rotations, opacity 0.1 (dead rows -15, scale
    -10); keypoint rows of ones, none alive; the blend-weight model.

    The random parts, motion_feature ([C, F], U(-1e-3, 1e-3)), the deform
    MLP, the hash tables and the weight MLP, are drawn from `generator` (a
    torch.Generator on the host) unless given: tests pass the JAX
    package's draws."""
    from gaussianprediction_tpu_torch.device import resolve_device
    from gaussianprediction_tpu_torch.ops.knn import mean_knn_sq_dist
    from gaussianprediction_tpu_torch.ops.mlp import init_mlp
    from gaussianprediction_tpu_torch.utils.math import inverse_sigmoid
    from gaussianprediction_tpu_torch.utils.sh import rgb_to_sh

    dev = resolve_device(device)
    f32 = torch.float32
    C = cfg.model.padded_capacity()
    Ck = cfg.model.kpt_capacity()
    N0 = min(len(points), C)
    F = cfg.model.feature_dim
    B = (cfg.model.sh_degree + 1) ** 2

    pts = torch.zeros((C, 3), dtype=f32, device=dev)
    pts[:N0] = torch.as_tensor(np.asarray(points[:N0], np.float32),
                               device=dev)
    alive = torch.zeros((C,), dtype=torch.bool, device=dev)
    alive[:N0] = True
    dist2 = torch.clamp(mean_knn_sq_dist(pts, k=3, valid=alive), min=1e-7)
    scales = torch.log(torch.sqrt(dist2))[:, None].repeat(1, 3)
    scales = torch.where(alive[:, None], scales,
                         torch.full_like(scales, -10.0))
    features_dc = torch.zeros((C, 1, 3), dtype=f32, device=dev)
    features_dc[:N0, 0] = rgb_to_sh(torch.as_tensor(
        np.asarray(colors[:N0], np.float32), device=dev))
    rots = torch.zeros((C, 4), dtype=f32, device=dev)
    rots[:, 0] = 1.0
    opac = torch.where(alive[:, None],
                       inverse_sigmoid(torch.tensor(0.1, dtype=f32)).to(dev),
                       torch.tensor(-15.0, device=dev)).expand(C, 1)

    if generator is None:
        generator = torch.Generator().manual_seed(0)
    if motion_feature is None:
        motion_feature = 1e-3 * (2.0 * torch.rand((C, F), generator=generator)
                                 - 1.0)
    if df_mlp is None:
        seed = int(torch.randint(0, 2**31 - 1, (1,), generator=generator))
        df_mlp = init_mlp(np.random.default_rng(seed), deform_mlp_sizes(cfg))
    if hash_tables is None or weight_mlp is None:
        seed = int(torch.randint(0, 2**31 - 1, (1,), generator=generator))
        tables, wmlp = weight_model(cfg, np.random.default_rng(seed))
        hash_tables = tables if hash_tables is None else hash_tables
        weight_mlp = wmlp if weight_mlp is None else weight_mlp
    to = lambda x: torch.as_tensor(np.array(x, np.float32),  # noqa: E731
                                   device=dev)
    params = {
        "xyz": pts,
        "features_dc": features_dc,
        "features_rest": torch.zeros((C, B - 1, 3), dtype=f32, device=dev),
        "scaling": scales,
        "rotation": rots,
        "opacity": opac.contiguous(),
        "motion_feature": to(motion_feature),
        "opacity_thres": torch.full((C, 1), -2.0, dtype=f32, device=dev),
        "super_xyz": torch.ones((Ck, 3), dtype=f32, device=dev),
        "super_feature": torch.ones((Ck, F), dtype=f32, device=dev),
        "df_mlp": [{k: to(v) for k, v in layer.items()} for layer in df_mlp],
        "hash_tables": {k: to(v) for k, v in hash_tables.items()},
        "weight_mlp": [{k: to(v) for k, v in layer.items()}
                       for layer in weight_mlp],
    }
    return GaussianState(params=params, alive=alive,
                         kpt_alive=torch.zeros((Ck,), dtype=torch.bool,
                                               device=dev))
