"""Deformation of the canonical Gaussians for stages 0 and 1.

Torch twin of gaussianprediction_tpu/models/deform.py:

  warm-up (iter <  jointly_iteration): canonical Gaussians, no deformation
  stage 1 (iter <= second_stage_iteration): per-Gaussian deformation —
          MLP([motion_feature, PE(xyz + annealed noise), PE(t)])
          -> (Δxyz, Δq[, Δo])

Stages 2/3 (keypoint blending through KNN and the hash grid) wait for a
later slice of the port.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gaussianprediction_tpu_torch.config import Config
from gaussianprediction_tpu_torch.models.gaussians import (
    GaussianState,
    deform_input_dims,
    opacity_act,
    rotation_act,
    scaling_act,
)
from gaussianprediction_tpu_torch.ops.mlp import mlp_apply
from gaussianprediction_tpu_torch.utils.math import (
    positional_encoding,
    quat_mul,
    sharp_sigmoid,
    step_opacity_fn,
)
from gaussianprediction_tpu_torch.utils.schedules import linear_anneal


class DeformOut(NamedTuple):
    xyz: torch.Tensor
    rotation: torch.Tensor     # normalized quats
    scaling: torch.Tensor      # activated
    opacity: torch.Tensor      # activated [C, 1]
    kpts_xyz_motion: Optional[torch.Tensor] = None
    kpts_rotation_motion: Optional[torch.Tensor] = None
    delta_xyz: Optional[torch.Tensor] = None


def motion_delta(params, cfg: Config, xyz_embed, motion_feature, t_pe):
    """Deform-MLP evaluation: (Δxyz, Δq, Δo or None)."""
    n = motion_feature.shape[0]
    t_rep = t_pe[None, :].expand(n, t_pe.shape[-1])
    inp = torch.cat([motion_feature, xyz_embed, t_rep], dim=-1)
    delta = mlp_apply(params["df_mlp"], inp)
    delta_o = delta[..., 7:8] if cfg.model.step_opacity else None
    return delta[..., 0:3], delta[..., 3:7], delta_o


def time_encode(cfg: Config, t):
    time_dim, _ = deform_input_dims(cfg)
    return positional_encoding(torch.reshape(t, (1,)), time_dim // 2)


def xyz_encode(cfg: Config, xyz):
    _, xyz_dim = deform_input_dims(cfg)
    return positional_encoding(xyz, xyz_dim // 6)


def _apply_deltas(params, delta_xyz, delta_q):
    xyz = params["xyz"] + delta_xyz
    q = rotation_act(quat_mul(rotation_act(delta_q), params["rotation"]))
    return xyz, q


def _lifecycle_opacity(params, cfg: Config, t, t_pe, iteration: int):
    """Step-opacity lifecycle: re-evaluates the MLP on canonical inputs
    for Δo once step opacity is on."""
    base = opacity_act(params["opacity"])
    if (not cfg.model.step_opacity
            or iteration <= cfg.model.step_opacity_iteration):
        return base
    xyz_embed = xyz_encode(cfg, params["xyz"])
    _, _, delta_o = motion_delta(
        params, cfg, xyz_embed, params["motion_feature"], t_pe
    )
    if cfg.model.opacity_type == "explicit":
        return base * step_opacity_fn(t, params["opacity_thres"],
                                      cfg.model.beta)
    return base * sharp_sigmoid(delta_o, cfg.model.beta)


def deform_warmup(params, cfg: Config) -> DeformOut:
    """Warm-up: static 3DGS."""
    return DeformOut(
        xyz=params["xyz"],
        rotation=rotation_act(params["rotation"]),
        scaling=scaling_act(params["scaling"]),
        opacity=opacity_act(params["opacity"]),
    )


def deform_stage1(params, cfg: Config, state: GaussianState, t, iteration,
                  generator: Optional[torch.Generator] = None,
                  noise=None) -> DeformOut:
    """Stage 1: per-Gaussian deformation.

    The xyz jitter sigma anneals to 0 at xyz_noise_iteration; past it no
    noise is drawn. Otherwise `noise` (N(0,1) [C, 3], before the anneal)
    is taken as given or drawn from `generator`: the draws differ from
    jax.random's, so tests that compare with the JAX package pass the
    same pre-drawn noise to both."""
    t_pe = time_encode(cfg, t)
    sigma = float(linear_anneal(iteration, 0.1, cfg.train.xyz_noise_iteration))
    xyz_in = params["xyz"].detach()
    if sigma != 0.0 or noise is not None:
        if noise is None:
            gdev = generator.device if generator is not None \
                else xyz_in.device
            noise = torch.randn(xyz_in.shape, generator=generator,
                                device=gdev).to(xyz_in.device)
        xyz_in = xyz_in + sigma * noise
    xyz_embed = xyz_encode(cfg, xyz_in)
    delta_xyz, delta_q, _ = motion_delta(
        params, cfg, xyz_embed, params["motion_feature"], t_pe
    )
    if cfg.model.norm_rotation:
        delta_q = rotation_act(delta_q)
    xyz, q = _apply_deltas(params, delta_xyz, delta_q)
    return DeformOut(
        xyz=xyz, rotation=q, scaling=scaling_act(params["scaling"]),
        opacity=_lifecycle_opacity(params, cfg, t, t_pe, iteration),
        kpts_xyz_motion=delta_xyz, kpts_rotation_motion=delta_q,
        delta_xyz=delta_xyz,
    )


def motion_feature_reg(params, stage: int):
    """1e-5 * mean|motion_feature| (the reference's get_loss); stages 2/3
    regularize the keypoint features instead."""
    if stage >= 2:
        raise NotImplementedError(
            "stages 2/3 are not ported yet (ROADMAP.md)")
    return 1e-5 * torch.mean(torch.abs(params["motion_feature"]))
