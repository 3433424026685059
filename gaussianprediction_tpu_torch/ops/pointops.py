"""The pointops library's secondary ops as gathers and reductions.

Torch twin of gaussianprediction_tpu/ops/pointops.py: grouping,
queryandgroup, subtraction, aggregation and inverse-distance
interpolation over ops/knn.py:knn (the reference vendors them as the
PointTransformer CUDA library; its training path uses only furthest-point
sampling, ops/fps.py). Autograd gives the gradients. No training path
calls these.
"""
from __future__ import annotations

import torch

from gaussianprediction_tpu_torch.ops.knn import knn


def _rows(x, idx):
    """x [n, c] gathered by idx [m, k] -> [m, k, c]."""
    return x[idx.to(torch.int64)]


def grouping(input, idx):
    """input [n, c], idx [m, k] -> [m, k, c] gathered rows."""
    return _rows(input, idx)


def queryandgroup(nsample: int, xyz, new_xyz, feat, idx=None,
                  use_xyz: bool = True):
    """KNN-group features around query points: xyz [n, 3], new_xyz [m, 3]
    (None: xyz), feat [n, c] -> [m, k, 3 + c] (use_xyz) or [m, k, c];
    the grouped xyz are relative to their query."""
    if new_xyz is None:
        new_xyz = xyz
    if idx is None:
        _, idx = knn(new_xyz, xyz, nsample)
    grouped_xyz = _rows(xyz, idx) - new_xyz[:, None, :]
    grouped_feat = _rows(feat, idx)
    if use_xyz:
        return torch.cat([grouped_xyz, grouped_feat], dim=-1)
    return grouped_feat


def subtraction(input1, input2, idx):
    """out[i, j] = input1[i] - input2[idx[i, j]]: [n, c], [n, c], [n, k]
    -> [n, k, c]."""
    return input1[:, None, :] - _rows(input2, idx)


def aggregation(input, position, weight, idx):
    """out[i, c] = sum_j (input[idx[i, j], c] + position[i, j, c]) *
    weight[i, j, c % w_c]: the weight's w_c channels shared cyclically
    over the c feature channels."""
    c = position.shape[2]
    w_c = weight.shape[-1]
    reps = -(-c // w_c)
    w_full = weight.repeat(1, 1, reps)[:, :, :c]
    return torch.sum((_rows(input, idx) + position) * w_full, dim=1)


def interpolation(xyz, new_xyz, feat, k: int = 3, eps: float = 1e-8):
    """Inverse-distance-weighted interpolation: xyz [m, 3] sources,
    new_xyz [n, 3] targets, feat [m, c] -> [n, c], each target's k
    nearest sources weighted by 1 / (distance + eps)."""
    d, idx = knn(new_xyz, xyz, k)
    recip = 1.0 / (torch.sqrt(d) + eps)
    w = recip / torch.sum(recip, dim=1, keepdim=True)
    return torch.sum(_rows(feat, idx) * w[:, :, None], dim=1)
