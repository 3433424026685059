"""Densification and pruning as masked writes over the static capacity.

Torch twin of gaussianprediction_tpu/train/densify.py: clone copies
selected rows into free slots (Adam moments zeroed there), split writes
two resampled children into free slots and kills the parent, prune clears
`alive`, reset_opacity clamps opacity and zeroes its moments; keypoint
growth (stages 2/3) writes furthest-point samples of the Gaussians that
need motion detail into free keypoint rows. Free slots are assigned by
rank (a cumsum over the free mask), so the result is deterministic.
Functional: inputs are left as they were.
"""
from __future__ import annotations

from typing import Optional

import torch

from gaussianprediction_tpu_torch.config import Config
from gaussianprediction_tpu_torch.models.gaussians import (
    GaussianState, opacity_act, scaling_act,
)
from gaussianprediction_tpu_torch.ops.fps import furthest_point_sampling
from gaussianprediction_tpu_torch.utils.math import (
    inverse_sigmoid, quat_to_rotmat,
)

PER_GAUSSIAN = (
    "xyz", "features_dc", "features_rest", "opacity", "scaling",
    "rotation", "motion_feature", "opacity_thres",
)
PER_KPT = ("super_xyz", "super_feature")


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


def grow_keypoints_from_grads(state: GaussianState, opt_state, cfg: Config,
                              max_new: int, ratio: int = 100):
    """Gradient-driven keypoint growth (the reference's densify_kpts):
    furthest-point samples of the live Gaussians whose mean screen-space
    gradient passes densify_grad_threshold become new keypoints with
    their motion features. max_new: the sample budget."""
    mask = state.alive & (_grads_from_stats(state)
                          > cfg.opt.densify_grad_threshold)
    return _grow_keypoints(state, opt_state, max_new, mask, ratio)


def grow_keypoints_from_teaching(state: GaussianState, opt_state,
                                 cfg: Config, max_new: int,
                                 ratio: int = 100):
    """Teacher-guided keypoint growth: the same over the Gaussians whose
    blended motion strayed from their stage-1 motion by at least
    teaching_threshold (xyz_motion_accum_max, kept by the step)."""
    mask = state.alive & (state.xyz_motion_accum_max
                          >= cfg.train.teaching_threshold)
    return _grow_keypoints(state, opt_state, max_new, mask, ratio)


def _grow_keypoints(state: GaussianState, opt_state, max_new: int, mask,
                    ratio: int):
    """count // ratio new keypoints (at least 1 when any Gaussian is
    selected; at most the free keypoint rows and max_new) by FPS over the
    masked Gaussians' xyz, written into the free rows in rank order with
    their Adam moments zeroed. Every statistic resets."""
    params = state.params
    dev = state.device
    count = torch.sum(mask)
    select = torch.where(count > ratio, count // ratio,
                         torch.ones_like(count))
    kpt_free = ~state.kpt_alive
    select = torch.clamp(torch.minimum(select, torch.sum(kpt_free)),
                         max=max_new)
    select = torch.where(count >= 1, select, torch.zeros_like(select))

    fps_idx = furthest_point_sampling(params["xyz"], max_new,
                                      valid=mask).to(torch.int64)
    ar = torch.arange(max_new, device=dev)
    Ck = state.kpt_capacity
    dst = _rank_to_slot(kpt_free)[torch.clamp(ar, max=Ck - 1)]
    write = (ar < select) & (dst < Ck)
    src, dst = fps_idx[write], dst[write].to(torch.int64)
    params = dict(params)
    for k, from_k in (("super_xyz", "xyz"),
                      ("super_feature", "motion_feature")):
        rows = params[k].clone()
        rows[dst] = params[from_k][src]
        params[k] = rows
    opt_state = {**opt_state, "m": dict(opt_state["m"]),
                 "v": dict(opt_state["v"])}
    for mom in ("m", "v"):
        for k in PER_KPT:
            m = opt_state[mom][k].clone()
            m[dst] = 0.0
            opt_state[mom][k] = m
    kpt_alive = state.kpt_alive.clone()
    kpt_alive[dst] = True

    C = state.capacity
    zeros = lambda dt=torch.float32: torch.zeros(  # noqa: E731
        (C,), dtype=dt, device=dev)
    return state.replace(
        params=params, kpt_alive=kpt_alive, xyz_gradient_accum=zeros(),
        xyz_gradient_accum_max=zeros(), denom=zeros(),
        xyz_motion_accum_max=zeros(), motion_denom=zeros(),
        max_radii2D=zeros(torch.int32)), opt_state
