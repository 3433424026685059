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

    def to(self, device) -> "GaussianState":
        """The state (params, masks, statistics) on `device`: copies,
        except of the tensors already there."""
        from gaussianprediction_tpu_torch.train.optimizer import tree_map

        moved = {f.name: getattr(self, f.name)
                 for f in dataclasses.fields(self)}
        return GaussianState(**tree_map(
            lambda x: None if x is None else x.to(device), moved))

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
    """The blend-weight model of stages 2/3, drawn with numpy: (tables,
    weight MLP [n_feat] + [64]*2 + [2K]). The tables by encoder:
    `hashgrid` {"level_l": [size_l, F]}, `brick` {"level_l": [n_bricks_l,
    64 F]}, `fourier` None (its frequency matrix is a constant)."""
    from gaussianprediction_tpu_torch.ops.hashgrid import (
        init_brickgrid, init_hashgrid,
    )
    from gaussianprediction_tpu_torch.ops.mlp import init_mlp

    m = cfg.model
    if m.weight_encoder == "fourier":
        from gaussianprediction_tpu_torch.ops.fourier_enc import (
            fourier_feature_dim,
        )

        tables = None
        n_feat = fourier_feature_dim(m.hash_levels, m.fourier_per_level)
    elif m.weight_encoder == "brick":
        tables = init_brickgrid(rng, n_levels=m.hash_levels,
                                n_features=m.hash_features,
                                log2_Tb=m.hash_log2_Tb, n_min=m.hash_min_res,
                                max_res=m.hash_max_res)
        n_feat = m.hash_levels * m.hash_features
    elif m.weight_encoder == "hashgrid":
        tables = init_hashgrid(rng, n_levels=m.hash_levels,
                               n_features=m.hash_features,
                               log2_T=m.hash_log2_T, n_min=m.hash_min_res,
                               max_res=m.hash_max_res)
        n_feat = sum(t.shape[1] for t in tables.values())
    else:
        raise ValueError(f"unknown weight_encoder {m.weight_encoder!r}")
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
    MLP, the weight model's tables (none for `fourier`) and its MLP, are
    drawn from `generator` (a
    torch.Generator on any device) unless given: tests pass the JAX
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
    gdev = generator.device
    if motion_feature is None:
        motion_feature = 1e-3 * (2.0 * torch.rand(
            (C, F), generator=generator, device=gdev) - 1.0)
    if df_mlp is None:
        seed = int(torch.randint(0, 2**31 - 1, (1,), generator=generator,
                                 device=gdev))
        df_mlp = init_mlp(np.random.default_rng(seed), deform_mlp_sizes(cfg))
    has_tables = cfg.model.weight_encoder != "fourier"
    if (has_tables and hash_tables is None) or weight_mlp is None:
        seed = int(torch.randint(0, 2**31 - 1, (1,), generator=generator,
                                 device=gdev))
        tables, wmlp = weight_model(cfg, np.random.default_rng(seed))
        hash_tables = tables if hash_tables is None else hash_tables
        weight_mlp = wmlp if weight_mlp is None else weight_mlp
    def to(x):
        if isinstance(x, torch.Tensor):
            return x.to(device=dev, dtype=f32)
        return torch.as_tensor(np.array(x, np.float32), device=dev)

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
        "weight_mlp": [{k: to(v) for k, v in layer.items()}
                       for layer in weight_mlp],
    }
    if has_tables:   # the fourier model has none (the JAX layout)
        params["hash_tables"] = {k: to(v) for k, v in hash_tables.items()}
    return GaussianState(params=params, alive=alive,
                         kpt_alive=torch.zeros((Ck,), dtype=torch.bool,
                                               device=dev))


PLY_SH_ORDER = ["x", "y", "z", "nx", "ny", "nz"]


def save_ply(state: GaussianState, path: str):
    """The live Gaussians (canonical) as a PLY file with the reference's
    attribute layout (x, y, z, nx, ny, nz, f_dc_*, f_rest_* channel-major,
    opacity, scale_*, rot_*; all float32), so third-party 3DGS viewers read
    it; the JAX package's save_ply."""
    from gaussianprediction_tpu_torch.utils import ply

    p = state.params
    alive = state.alive.cpu().numpy()

    def host(x):
        return x.detach().cpu().numpy()[alive]

    xyz = host(p["xyz"])
    f_dc, f_rest = host(p["features_dc"]), host(p["features_rest"])
    n = len(xyz)
    arrays = {"x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2],
              "nx": np.zeros(n, np.float32), "ny": np.zeros(n, np.float32),
              "nz": np.zeros(n, np.float32)}
    order = list(PLY_SH_ORDER)
    for prefix, f in (("f_dc", f_dc), ("f_rest", f_rest)):
        flat = np.transpose(f, (0, 2, 1)).reshape(n, -1)
        for i in range(flat.shape[1]):
            arrays[f"{prefix}_{i}"] = flat[:, i]
            order.append(f"{prefix}_{i}")
    arrays["opacity"] = host(p["opacity"])[:, 0]
    order.append("opacity")
    for name, key, k in (("scale", "scaling", 3), ("rot", "rotation", 4)):
        x = host(p[key])
        for i in range(k):
            arrays[f"{name}_{i}"] = x[:, i]
            order.append(f"{name}_{i}")
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    ply.write_ply(path, arrays, order=order)


def load_ply_params(path: str, cfg: Config, device=None):
    """A reference-layout Gaussian PLY (save_ply's) read into
    capacity-padded params and the alive mask, as the JAX package's
    load_ply_params reads it: the file's n rows first, the rest dead
    (zeros, opacity -15). Returns (params, alive) on `device` (None: the
    card)."""
    from gaussianprediction_tpu_torch.device import resolve_device
    from gaussianprediction_tpu_torch.utils import ply

    dev = resolve_device(device)
    v = ply.read_ply(path)
    n = len(v["x"])
    C = cfg.model.padded_capacity()
    B = (cfg.model.sh_degree + 1) ** 2

    def padded(a, shape):
        out = np.zeros((C,) + shape, np.float32)
        out[:n] = a
        return out

    def stacked(prefix, k):
        return np.stack([v[f"{prefix}_{i}"] for i in range(k)], 1)

    n_dc = len([k for k in v if k.startswith("f_dc_")])
    n_rest = len([k for k in v if k.startswith("f_rest_")])
    f_dc = stacked("f_dc", n_dc).reshape(n, 3, 1).transpose(0, 2, 1)
    f_rest = stacked("f_rest", n_rest).reshape(n, 3, B - 1).transpose(0, 2,
                                                                      1)
    # the JAX twin adds 0 to the live rows and -15 to the dead ones
    dead = np.where(np.arange(C)[:, None] < n, np.float32(0.0),
                    np.float32(-15.0))
    out = {
        "xyz": padded(np.stack([v["x"], v["y"], v["z"]], 1), (3,)),
        "features_dc": padded(f_dc, (1, 3)),
        "features_rest": padded(f_rest, (B - 1, 3)),
        "opacity": padded(v["opacity"][:, None], (1,)) + dead,
        "scaling": padded(stacked("scale", 3), (3,)),
        "rotation": padded(stacked("rot", 4), (4,)),
    }
    params = {k: torch.as_tensor(a, device=dev) for k, a in out.items()}
    return params, torch.arange(C, device=dev) < n
