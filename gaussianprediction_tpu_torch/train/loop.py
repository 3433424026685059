"""The stage schedule and the stage transitions of training.

Torch twin of the functions of gaussianprediction_tpu/train/loop.py that
the stages need: stage_of, set_super_keypoints (the k-means keypoint
initialization) and the transitions into stages 2 and 3 as
Trainer._maybe_stage_transition makes them. The Trainer class itself, and
the blend-weight distillation at the stage-2 start (distill_init_steps,
off in every preset), wait for a later slice (ROADMAP.md).
"""
from __future__ import annotations

from typing import Optional

import torch

from gaussianprediction_tpu_torch.config import Config
from gaussianprediction_tpu_torch.models.gaussians import GaussianState
from gaussianprediction_tpu_torch.ops.kmeans import feature_kmeans
from gaussianprediction_tpu_torch.train import optimizer as opt_mod


def stage_of(cfg: Config, iteration: int) -> int:
    if iteration < cfg.train.jointly_iteration:
        return 0
    if iteration <= cfg.train.second_stage_iteration:
        return 1
    if iteration <= cfg.train.third_stage_iteration:
        return 2
    return 3


def set_super_keypoints(state: GaussianState, cfg: Config,
                        generator: Optional[torch.Generator] = None,
                        start_idx=None) -> GaussianState:
    """k-means keypoint init: cluster the live Gaussians' [xyz,
    motion_feature] into max_points clusters; keypoint k is the mean xyz
    of cluster k's members with the cluster's feature centroid. The first
    max_points keypoint rows become alive, the others die. start_idx (the
    k-means seed) is drawn from `generator` when None."""
    p = state.params
    feats = torch.cat([p["xyz"], p["motion_feature"]], dim=-1)
    k = cfg.model.max_points
    super_xyz, super_feats = feature_kmeans(
        p["xyz"], feats, k, generator, valid=state.alive,
        start_idx=start_idx)
    params = dict(p)
    params["super_xyz"] = p["super_xyz"].clone()
    params["super_xyz"][:k] = super_xyz
    params["super_feature"] = p["super_feature"].clone()
    params["super_feature"][:k] = super_feats[:, 3:]
    kpt_alive = torch.zeros_like(state.kpt_alive)
    kpt_alive[:k] = True
    return state.replace(params=params, kpt_alive=kpt_alive)


def stage_transition(state: GaussianState, opt_state, cfg: Config,
                     iteration: int,
                     generator: Optional[torch.Generator] = None,
                     start_idx=None):
    """The host event at the first iteration of a stage, as the JAX
    Trainer makes it: entering stage 2 (second_stage_iteration + 1) the
    keypoints are set by set_super_keypoints (when none is alive yet) and
    Adam starts afresh; entering stage 3 Adam starts afresh. At any other
    iteration nothing changes. Returns (state, opt_state)."""
    if iteration == cfg.train.second_stage_iteration + 1 \
            and int(state.n_kpts()) == 0:
        if cfg.train.distill_init_steps > 0:
            raise NotImplementedError(
                "distill_init_steps > 0 is not ported yet (ROADMAP.md)")
        state = set_super_keypoints(state, cfg, generator, start_idx)
        return state, opt_mod.init_adam(state.params)
    if iteration == cfg.train.third_stage_iteration + 1:
        return state, opt_mod.init_adam(state.params)
    return state, opt_state
