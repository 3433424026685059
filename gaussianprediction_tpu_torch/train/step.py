"""Deform + render for stages 0 and 1: the single entry used by eval.

Torch twin of gaussianprediction_tpu/train/step.py:render_at_time and
deform_for_stage, and of train/loop.py:stage_of. The training step itself
(loss, backward, densification statistics, Adam) waits for the training
slice of the port, as do stages 2 and 3.
"""
from __future__ import annotations

from typing import Optional

import torch

from gaussianprediction_tpu_torch.config import Config
from gaussianprediction_tpu_torch.models import deform as D
from gaussianprediction_tpu_torch.models.gaussians import (
    GaussianState, get_shs,
)
from gaussianprediction_tpu_torch.ops import rasterize


def stage_of(cfg: Config, iteration: int) -> int:
    if iteration < cfg.train.jointly_iteration:
        return 0
    if iteration <= cfg.train.second_stage_iteration:
        return 1
    if iteration <= cfg.train.third_stage_iteration:
        return 2
    return 3


def deform_for_stage(params, cfg: Config, state: GaussianState, t,
                     iteration: int, generator: Optional[torch.Generator],
                     stage: int, noise=None):
    if stage == 0:
        assert noise is None, "pre-drawn noise only applies to stage 1"
        return D.deform_warmup(params, cfg)
    if stage == 1:
        return D.deform_stage1(params, cfg, state, t, iteration, generator,
                               noise=noise)
    raise NotImplementedError(
        f"stage {stage} (keypoint blending) is not ported yet (ROADMAP.md)"
    )


def render_at_time(params, cfg: Config, state: GaussianState, cam, t,
                   iteration: int, generator: Optional[torch.Generator],
                   stage: int, width: int, height: int, bg, sh_degree: int,
                   need_tidx: bool = False, active_sh_degree=None,
                   noise=None):
    """Deform + render one view at time t (a 0-d f32 tensor).

    active_sh_degree zeroes the coefficients beyond (deg+1)^2 under the
    max-degree basis, as the JAX twin does."""
    out = deform_for_stage(params, cfg, state, t, iteration, generator,
                           stage, noise=noise)
    shs = get_shs(params)          # [C, 3, K]
    if active_sh_degree is not None:
        kidx = torch.arange(shs.shape[-1], device=shs.device)
        shs = torch.where(kidx[None, None, :] < (active_sh_degree + 1) ** 2,
                          shs, torch.zeros_like(shs))
    pkg = rasterize.render(
        out.xyz, out.scaling, out.rotation, out.opacity, shs, cam, width,
        height, bg, sh_degree=sh_degree, alive=state.alive,
        capacity_multiplier=cfg.model.capacity_multiplier,
        need_tidx=need_tidx,
    )
    return pkg, out
