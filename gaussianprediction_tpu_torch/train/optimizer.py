"""Stage-aware per-group Adam with schedule-driven learning rates.

Torch twin of gaussianprediction_tpu/train/optimizer.py: Adam with betas
(0.9, 0.999) and eps 1e-15 per reference optimizer group; each stage
starts a fresh optimizer, learning rates are evaluated on the GLOBAL
iteration while bias correction uses the per-stage step. A functional
update: adam_step returns new params and moments and leaves its inputs as
they were. The param tree is the JAX layout: a dict of tensors, with the
MLPs as lists of {"w", "b"} dicts.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from gaussianprediction_tpu_torch.config import Config
from gaussianprediction_tpu_torch.utils.schedules import expon_lr

BETA1, BETA2, EPS = 0.9, 0.999, 1e-15

# param-tree key -> reference optimizer group name
GROUP_OF_PARAM = {
    "xyz": "xyz",
    "features_dc": "f_dc",
    "features_rest": "f_rest",
    "opacity": "opacity",
    "scaling": "scaling",
    "rotation": "rotation",
    "motion_feature": "motion_feature",
    "opacity_thres": "opacity_thres",
    "super_xyz": "s_xyz",
    "super_feature": "s_motion_feature",
    "df_mlp": "df_mlp",
    "hash_tables": "weight_mlp",
    "weight_mlp": "weight_mlp",
}

# groups optimized per stage
STAGE_GROUPS = {
    1: ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation",
        "df_mlp", "motion_feature", "opacity_thres"),
    2: ("s_xyz", "s_motion_feature", "weight_mlp", "df_mlp"),
    3: ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation",
        "s_xyz", "s_motion_feature", "weight_mlp", "df_mlp",
        "opacity_thres"),
}


def tree_map(fn, *trees):
    """fn over the tensors of equally shaped dict/list trees, dict keys in
    sorted order (as jax.tree flattens them)."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(fn, *[t[k] for t in trees]) for k in sorted(t0)}
    if isinstance(t0, (list, tuple)):
        return [tree_map(fn, *xs) for xs in zip(*trees)]
    return fn(*trees)


def tree_leaves(tree):
    """The tensors of a dict/list tree in tree_map's order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def _pick(tree, i):
    """The i-th entry of every tuple leaf of a dict/list tree."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_pick(v, i) for v in tree]
    return tree[i]


def active_groups(cfg: Config, stage: int):
    groups = STAGE_GROUPS[stage]
    if not cfg.model.step_opacity:
        groups = tuple(g for g in groups if g != "opacity_thres")
    return groups


def group_lr(group: str, cfg: Config, spatial_scale: float, iteration):
    """The group's f32 learning rate at a global iteration."""
    o = cfg.opt
    if group == "xyz":
        return expon_lr(iteration, o.position_lr_init * spatial_scale,
                        o.position_lr_final * spatial_scale,
                        lr_delay_mult=o.position_lr_delay_mult,
                        max_steps=o.position_lr_max_steps)
    if group == "df_mlp":
        return expon_lr(iteration, o.mlp_lr, o.position_lr_final,
                        lr_delay_mult=o.position_lr_delay_mult,
                        max_steps=o.position_lr_max_steps)
    if group == "s_xyz":
        return expon_lr(iteration, o.kpts_lr, o.kpts_lr_final,
                        lr_delay_steps=o.position_lr_max_steps,
                        max_steps=o.iterations)
    if group == "weight_mlp":
        return expon_lr(iteration, o.hash_lr, o.hash_lr_final,
                        lr_delay_steps=o.position_lr_max_steps,
                        max_steps=o.iterations)
    if group in ("motion_feature", "s_motion_feature"):
        return expon_lr(iteration, o.mfeature_lr, o.mfeature_lr_final,
                        lr_delay_steps=o.position_lr_max_steps,
                        max_steps=o.position_lr_max_steps)
    const = {
        "f_dc": o.feature_lr,
        "f_rest": o.feature_lr / 20.0,
        "opacity": o.opacity_lr,
        "opacity_thres": o.opacity_lr,
        "scaling": o.scaling_lr,
        "rotation": o.rotation_lr,
    }
    return torch.tensor(const[group], dtype=torch.float32)


def init_adam(params) -> Dict[str, Any]:
    zeros = lambda p: torch.zeros_like(p)  # noqa: E731
    dev = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def stage_start(cfg: Config, stage: int) -> int:
    if stage <= 1:
        return 0
    if stage == 2:
        return cfg.train.second_stage_iteration
    return cfg.train.third_stage_iteration


def adam_step(params, grads, opt_state, cfg: Config, stage: int, lrs):
    """One Adam update of the stage's groups; the other params and their
    moments pass through. grads needs entries for the active groups only.
    lrs: {group: 0-d f32 learning rate on the params' device}, a row of
    the training steps' per-iteration table (train/step.py:row_lrs). The
    bias corrections come from opt_state["step"] on its device. Returns
    (new params, new opt_state)."""
    active = active_groups(cfg, stage)
    step = opt_state["step"] + 1
    stepf = step.to(torch.float32)
    dev = stepf.device
    # torch.full fills on the device: no copy from the host
    bc1 = 1.0 - torch.pow(torch.full((), BETA1, device=dev), stepf)
    bc2 = 1.0 - torch.pow(torch.full((), BETA2, device=dev), stepf)

    new_params, new_m, new_v = {}, {}, {}
    for key, p in params.items():
        group = GROUP_OF_PARAM[key]
        m, v = opt_state["m"][key], opt_state["v"][key]
        if group not in active:
            new_params[key], new_m[key], new_v[key] = p, m, v
            continue
        lr = lrs[group]

        def upd(p_, g, m_, v_):
            m2 = BETA1 * m_ + (1 - BETA1) * g
            v2 = BETA2 * v_ + (1 - BETA2) * g * g
            mh = m2 / bc1
            vh = v2 / bc2
            return p_ - lr * mh / (torch.sqrt(vh) + EPS), m2, v2

        out = tree_map(upd, p, grads[key], m, v)   # leaves: (p, m, v)
        new_params[key], new_m[key], new_v[key] = (_pick(out, i)
                                                   for i in range(3))
    return new_params, {"m": new_m, "v": new_v, "step": step}
