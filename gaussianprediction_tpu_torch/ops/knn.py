"""K-nearest neighbours by blocked brute force.

Torch twin of gaussianprediction_tpu/ops/knn.py (knn, mean_knn_sq_dist):
squared distances as ||q||^2 + ||p||^2 - 2 q.p clamped at 0 (the JAX
package's formula, so the values agree to f32 roundoff), invalid points
at +inf, the k smallest by torch.topk, blocked over query rows; and the
35-d hybrid KNN of stages 2/3 (hybrid_knn). lax.top_k breaks ties toward
the lower index and torch.topk makes no promise: the two agree wherever
neighbouring distances differ by more than roundoff.
"""
from __future__ import annotations

import torch


def _sq_dists(q, p):
    qn = torch.sum(q * q, dim=-1, keepdim=True)
    pn = torch.sum(p * p, dim=-1, keepdim=True)
    return torch.clamp(qn + pn.T - 2.0 * (q @ p.T), min=0.0)


def knn(queries, points, k: int, query_valid=None, point_valid=None,
        block: int = 4096):
    """Exact k nearest neighbours: (sq_dists [Nq, k], idx [Nq, k] int32).
    Invalid points are never chosen; invalid queries get dist inf and
    index 0."""
    inf = float("inf")
    ds, ids = [], []
    for i in range(0, queries.shape[0], block):
        d = _sq_dists(queries[i:i + block], points)
        if point_valid is not None:
            d = torch.where(point_valid[None, :], d, inf)
        dk, ik = torch.topk(d, k, dim=1, largest=False, sorted=True)
        ds.append(dk)
        ids.append(ik.to(torch.int32))
    d, idx = torch.cat(ds), torch.cat(ids)
    if query_valid is not None:
        d = torch.where(query_valid[:, None], d, inf)
        idx = torch.where(query_valid[:, None], idx, torch.zeros_like(idx))
    return d, idx


def mean_knn_sq_dist(points, k: int = 3, valid=None, block: int = 4096):
    """Mean squared distance to the k nearest other points (the reference's
    distCUDA2): the k+1 nearest, the first (the point itself) dropped."""
    d, _ = knn(points, points, k + 1, query_valid=valid, point_valid=valid,
               block=block)
    return torch.mean(d[:, 1:], dim=-1)


def hybrid_knn(xyz, feat, kpt_xyz, kpt_feat, k: int, feature_amplify: float,
               point_valid=None, query_valid=None, block: int = 4096):
    """The reference's "hybird" KNN: the k nearest keypoints in the
    concatenated space [xyz, motion_feature * amplify]."""
    q = torch.cat([xyz, feat * feature_amplify], dim=-1)
    p = torch.cat([kpt_xyz, kpt_feat * feature_amplify], dim=-1)
    return knn(q, p, k, query_valid=query_valid, point_valid=point_valid,
               block=block)
