"""Furthest point sampling.

Torch twin of gaussianprediction_tpu/ops/fps.py (the pointops
`furthestsampling` the reference uses for keypoint growth): a serial loop
of parallel distance reductions, each step taking the first point of
largest distance to the chosen set (torch.argmax, like jnp.argmax, returns
the first maximum). The loop stays on the device: no step reads a value
back to the host.
"""
from __future__ import annotations

import torch


def furthest_point_sampling(points, n_samples: int, valid=None,
                            start_idx=0):
    """Select n_samples indices by iterative furthest-point sampling.

    points: [N, D]; valid: [N] bool (invalid points are never selected and
    do not move the distances); start_idx: an int or a 0-d tensor, the
    first valid point at or after it is the seed. Returns idx
    [n_samples] int32. With fewer valid points than n_samples the extra
    entries repeat a chosen point (callers mask by count)."""
    N = points.shape[0]
    dev = points.device
    if valid is None:
        valid = torch.ones((N,), dtype=torch.bool, device=dev)
    ar = torch.arange(N, device=dev)
    first = torch.argmax((valid & (ar >= start_idx)).to(torch.int32))
    idx = torch.zeros((n_samples,), dtype=torch.int64, device=dev)
    idx[0] = first
    min_d = torch.full((N,), 1e10, dtype=torch.float32, device=dev)
    neg = torch.tensor(-1.0, device=dev)
    for i in range(1, n_samples):
        last = points.index_select(0, idx[i - 1:i])
        d = torch.sum((points - last) ** 2, dim=-1)
        min_d = torch.minimum(min_d, d)
        idx[i] = torch.argmax(torch.where(valid, min_d, neg))
    return idx.to(torch.int32)
