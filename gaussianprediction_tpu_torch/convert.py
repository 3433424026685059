"""Carry the JAX package's Gaussian state across to the port.

state_from_params takes `GaussianState.params` as a nested dict of numpy
arrays (xyz, features_dc, features_rest, scaling, rotation, opacity,
motion_feature, df_mlp=[{w, b}, ...], the keypoints super_xyz and
super_feature, the weight model hash_tables={level_l: ...} and
weight_mlp=[{w, b}, ...]) or with the flattened "a/b/0/w" names of
gaussianprediction_tpu/train/checkpoint.py:_flatten, plus the `alive`
mask, optionally `kpt_alive` and the densification statistics, and
returns the port's GaussianState on a device. opt_state_from_arrays
carries the JAX Adam state ({"m", "v", "step"}) across the same way.
load_jax_checkpoint reads a .npz checkpoint of the JAX package directly:
params, optimizer state, statistics and iteration. Arrays keep the JAX
layout (the MLP's w is [fan_in, fan_out]), so nothing is transposed.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from gaussianprediction_tpu_torch.device import resolve_device
from gaussianprediction_tpu_torch.models.gaussians import (
    STATS, GaussianState,
)


def unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    """{"df_mlp/0/w": a, "xyz": b} -> {"df_mlp": [{"w": a}], "xyz": b};
    a path component of digits indexes a list."""
    root: Dict[str, Any] = {}
    for path, value in flat.items():
        parts = path.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        out = {k: listify(v) for k, v in node.items()}
        if out and all(k.isdigit() for k in out):
            return [out[str(i)] for i in range(len(out))]
        return out

    return listify(root)


def _to_tensor(x, device):
    arr = np.asarray(x)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    return torch.as_tensor(np.ascontiguousarray(arr), device=device)


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_to(v, device) for v in tree]
    return _to_tensor(tree, device)


def state_from_params(params: Dict[str, Any], alive, kpt_alive=None,
                      device=None, stats=None) -> GaussianState:
    """stats: optional {name: array} of the densification statistics
    (models/gaussians.py:STATS); missing ones start at zero."""
    if any("/" in k for k in params):
        params = unflatten(params)
    dev = resolve_device(device)
    stats = {k: _to_tensor(v, dev) for k, v in (stats or {}).items()
             if k in STATS}
    return GaussianState(
        params=_tree_to(params, dev),
        alive=_to_tensor(np.asarray(alive, bool), dev),
        kpt_alive=(None if kpt_alive is None
                   else _to_tensor(np.asarray(kpt_alive, bool), dev)),
        **stats,
    )


def opt_state_from_arrays(opt: Dict[str, Any], device=None):
    """The JAX package's Adam state {"m": tree, "v": tree, "step": int}
    (nested or with flattened "m/xyz" names) -> the port's."""
    if any("/" in k for k in opt):
        opt = unflatten(opt)
    dev = resolve_device(device)
    return {"m": _tree_to(opt["m"], dev), "v": _tree_to(opt["v"], dev),
            "step": torch.as_tensor(np.asarray(opt["step"]),
                                    dtype=torch.int32, device=dev)}


def load_jax_checkpoint(path: str, device=None):
    """A JAX package .npz checkpoint -> (GaussianState, opt_state,
    iteration); opt_state is None when the checkpoint holds none."""
    with np.load(path) as f:
        flat = {k: f[k] for k in f.files}

    def under(prefix):
        return {k[len(prefix):]: v for k, v in flat.items()
                if k.startswith(prefix)}

    meta = under("meta/")
    state = state_from_params(under("params/"), meta["alive"],
                              meta.get("kpt_alive"), device, stats=meta)
    opt = under("opt/")
    opt_state = opt_state_from_arrays(opt, device) if opt else None
    return state, opt_state, int(meta["iteration"])
