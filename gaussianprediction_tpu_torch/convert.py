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
gcn_from_arrays builds the port's motion-extrapolation GCN
(models/gcn.py:GCNxyzr) from the JAX package's GCN params and batch-norm
state, and gcn_to_arrays turns it back into the flat keys of the JAX GCN
checkpoint (motion/gcn_train.py reads and writes that layout).
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


def flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """unflatten's inverse: nested dicts and lists -> {"a/0/b": leaf},
    the leaves as numpy arrays (tensors copied to the host); the JAX
    package's train/checkpoint.py:_flatten layout."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = (tree.detach().cpu().numpy()
                            if isinstance(tree, torch.Tensor)
                            else np.asarray(tree))
    return out


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


def _gcn_tensors(model) -> Dict[str, torch.Tensor]:
    """The port's GCNxyzr's parameters and batch-norm buffers under the
    flat keys of the JAX package's GCN checkpoint (train/checkpoint.py:
    _flatten of {"params": ..., "bn": ...}): params/xyz/gc1/weight,
    params/xyz/blocks/0/bn1/scale, params/rot/out_mlp/1/w,
    bn/xyz/bn1/mean, bn/rot/block0_bn2/var, ..."""
    out = {f"params/{name.replace('.', '/')}": p
           for name, p in model.named_parameters()}
    for name, b in model.named_buffers():
        net, *mid, stat = name.split(".")
        if mid[0] == "blocks":          # blocks.i.bn1 -> block{i}_bn1
            mid = [f"block{mid[1]}_{mid[2]}"]
        out[f"bn/{net}/{'/'.join(mid)}/{stat}"] = b
    return out


def gcn_to_arrays(model) -> Dict[str, np.ndarray]:
    """The port's GCNxyzr -> {flat JAX checkpoint key: numpy array}."""
    return flatten(_gcn_tensors(model))


def gcn_from_arrays(params: Dict[str, Any], bn_state: Dict[str, Any],
                    device=None):
    """The JAX package's GCN_xyzr tree (params {"xyz": ..., "rot": ...}
    and bn_state {"xyz": {"bn1": {"mean", "var"}, "block0_bn1": ...},
    ...}, nested with lists for blocks and out_mlp, or with flattened
    "xyz/blocks/0/gc1/att" names) -> the port's GCNxyzr on a device. The
    widths are read from the arrays' shapes."""
    from gaussianprediction_tpu_torch.models.gcn import GCNxyzr

    flat = flatten({"params": params, "bn": bn_state})
    dev = resolve_device(device)
    input_f, hidden_f = flat["params/xyz/gc1/weight"].shape
    node_n = flat["params/xyz/gc1/att"].shape[0] // 3
    no_mapping = "params/xyz/out_gc/weight" in flat
    head = flat["params/xyz/out_gc/weight" if no_mapping
                else "params/xyz/out_mlp/1/w"]
    num_stage = len({k.split("/")[3] for k in flat
                     if k.startswith("params/xyz/blocks/")})
    model = GCNxyzr(input_f, hidden_f, head.shape[1], num_stage, node_n,
                    no_mapping, generator=torch.Generator().manual_seed(0),
                    device=dev)
    targets = _gcn_tensors(model)
    if set(flat) != set(targets):
        raise ValueError("GCN tree keys differ from the model's: "
                         f"{sorted(set(flat) ^ set(targets))}")
    with torch.no_grad():
        for k, dst in targets.items():
            src = flat[k]
            if src.shape != tuple(dst.shape):
                raise ValueError(f"{k}: shape {src.shape}, the model's "
                                 f"{tuple(dst.shape)}")
            dst.copy_(torch.from_numpy(np.array(src, np.float32)))
    return model
