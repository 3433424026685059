"""Densification and pruning as masked writes over the static capacity.

Torch twin of the stage-0/1 part of gaussianprediction_tpu/train/
densify.py: clone copies selected rows into free slots (Adam moments
zeroed there), split writes two resampled children into free slots and
kills the parent, prune clears `alive`, reset_opacity clamps opacity and
zeroes its moments. Free slots are assigned by rank (a cumsum over the
free mask), so the result is deterministic. Functional: inputs are left as
they were. Keypoint growth (it needs FPS) waits for the stage-2/3 slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from gaussianprediction_tpu_torch.config import Config
from gaussianprediction_tpu_torch.models.gaussians import (
    GaussianState, opacity_act, scaling_act,
)
from gaussianprediction_tpu_torch.utils.math import (
    inverse_sigmoid, quat_to_rotmat,
)

PER_GAUSSIAN = (
    "xyz", "features_dc", "features_rest", "opacity", "scaling",
    "rotation", "motion_feature", "opacity_thres",
)


def _rank_to_slot(free):
    """[C] bool -> [C] int32: the slot of the r-th free slot at r (else C)."""
    C = free.shape[0]
    out = torch.full((C,), C, dtype=torch.int32, device=free.device)
    rank = torch.cumsum(free.to(torch.int64), 0) - 1
    out[rank[free]] = torch.nonzero(free).reshape(-1).to(torch.int32)
    return out


def _copy_rows(params, opt_state, src_idx, dst_idx, valid,
               keys=PER_GAUSSIAN):
    """Copy param rows src -> dst where valid; zero Adam moments at dst."""
    src = src_idx[valid].to(torch.int64)
    dst = dst_idx[valid].to(torch.int64)
    params = dict(params)
    opt_state = {**opt_state, "m": dict(opt_state["m"]),
                 "v": dict(opt_state["v"])}
    for k in keys:
        if k not in params:
            continue
        p = params[k].clone()
        p[dst] = params[k][src]
        params[k] = p
        for mom in ("m", "v"):
            m = opt_state[mom][k].clone()
            m[dst] = 0.0
            opt_state[mom][k] = m
    return params, opt_state


def _grads_from_stats(state: GaussianState):
    g = state.xyz_gradient_accum / torch.clamp(state.denom, min=1e-12)
    return torch.where(state.denom > 0, g, torch.zeros_like(g))


def densify_and_prune_clone_split(
        state: GaussianState, opt_state, cfg: Config, extent: float,
        generator: Optional[torch.Generator] = None, noise=None):
    """Clone small high-gradient Gaussians, split large ones into two
    children (the parent dies). noise: the split's N(0,1) draws [2, C, 3]
    (before the scale), drawn from `generator` when None. Clones and
    children beyond the free slots are dropped. The statistics reset.
    Returns (state, opt_state)."""
    params = state.params
    C = state.capacity
    dev = state.device
    grads = _grads_from_stats(state)
    scaling = scaling_act(params["scaling"])
    max_scale = torch.amax(scaling, dim=-1)
    dense_thr = cfg.opt.percent_dense * extent
    grad_ok = grads >= cfg.opt.densify_grad_threshold
    src = torch.arange(C, dtype=torch.int32, device=dev)

    # clone: small Gaussians
    clone_mask = state.alive & grad_ok & (max_scale <= dense_thr)
    free = ~state.alive
    rank2slot = _rank_to_slot(free)
    clone_rank = torch.cumsum(clone_mask.to(torch.int64), 0) - 1
    dst = rank2slot[torch.clamp(clone_rank, 0, C - 1)]
    valid = clone_mask & (clone_rank < free.sum()) & (dst < C)
    params, opt_state = _copy_rows(params, opt_state, src, dst, valid)
    alive = state.alive.clone()
    alive[dst[valid].to(torch.int64)] = True

    # split: large Gaussians -> 2 children, the parent pruned
    split_mask = state.alive & grad_ok & (max_scale > dense_thr)
    free2 = ~alive
    rank2slot2 = _rank_to_slot(free2)
    split_rank = torch.cumsum(split_mask.to(torch.int64), 0) - 1
    child_ok = split_mask & (2 * split_rank + 1 < free2.sum())
    if noise is None:
        gdev = generator.device if generator is not None else dev
        noise = torch.randn((2, C, 3), generator=generator,
                            device=gdev).to(dev)
    noise = noise * scaling[None]
    R = quat_to_rotmat(params["rotation"])
    offsets = torch.einsum("nij,cnj->cni", R, noise)     # [2, C, 3]
    new_scaling = torch.log(scaling / (0.8 * 2.0))
    for child in range(2):
        dst2 = rank2slot2[torch.clamp(2 * split_rank + child, 0, C - 1)]
        v2 = child_ok & (dst2 < C)
        params, opt_state = _copy_rows(params, opt_state, src, dst2, v2)
        d = dst2[v2].to(torch.int64)
        xyz = params["xyz"].clone()
        xyz[d] = params["xyz"][v2] + offsets[child][v2]
        sc = params["scaling"].clone()
        sc[d] = new_scaling[v2]
        params["xyz"], params["scaling"] = xyz, sc
        alive[d] = True
    alive = alive & ~child_ok

    zeros = lambda dt=torch.float32: torch.zeros(  # noqa: E731
        (C,), dtype=dt, device=dev)
    return state.replace(
        params=params, alive=alive, xyz_gradient_accum=zeros(),
        xyz_gradient_accum_max=zeros(), denom=zeros(),
        max_radii2D=zeros(torch.int32)), opt_state


def prune(state: GaussianState, cfg: Config, extent: float,
          max_screen_size: Optional[int]) -> GaussianState:
    """Kill transparent Gaussians (opacity < 0.005) and, with
    max_screen_size, those too large on screen or in the world."""
    opac = opacity_act(state.params["opacity"])[:, 0]
    mask = opac < 0.005
    if max_screen_size:
        big_vs = state.max_radii2D > max_screen_size
        big_ws = torch.amax(scaling_act(state.params["scaling"]),
                            dim=-1) > 0.1 * extent
        mask = mask | big_vs | big_ws
    return state.replace(alive=state.alive & ~mask)


def reset_opacity(state: GaussianState, opt_state):
    """Clamp live opacities to <= 0.01 and zero the opacity moments."""
    opac = opacity_act(state.params["opacity"])
    new = inverse_sigmoid(torch.clamp(opac, max=0.01))
    params = dict(state.params)
    params["opacity"] = torch.where(state.alive[:, None], new,
                                    state.params["opacity"])
    opt_state = {**opt_state, "m": dict(opt_state["m"]),
                 "v": dict(opt_state["v"])}
    for mom in ("m", "v"):
        opt_state[mom]["opacity"] = torch.zeros_like(
            opt_state[mom]["opacity"])
    return state.replace(params=params), opt_state
