"""Feature k-means for the keypoint initialization of stage 2.

Torch twin of gaussianprediction_tpu/ops/kmeans.py (kmeans,
feature_kmeans; the reference's `feature_kmeans`): Lloyd's k-means over
[xyz, motion_feature], seeded by furthest-point sampling from a start
index, then each cluster's mean member xyz as its keypoint. The JAX
package sums each cluster with segment_sum; on the card index_add_ sums
with atomics in an order that changes from run to run, so here each
cluster's sum is a one-hot [k, N] @ [N, D] product, which is
deterministic (and at k = 100, N = 204,800, D = 35 cheap). Counts are
exact either way; the sums agree with segment_sum to f32 roundoff.
"""
from __future__ import annotations

from typing import Optional

import torch

from gaussianprediction_tpu_torch.ops.fps import furthest_point_sampling
from gaussianprediction_tpu_torch.ops.knn import _sq_dists


def _cluster_sums(x, assign, valid, k: int):
    """(Σ x over each cluster's valid members [k, D], member counts [k])."""
    onehot = ((assign[None, :] == torch.arange(k, device=x.device)[:, None])
              & valid[None, :]).to(torch.float32)
    return onehot @ torch.where(valid[:, None], x, torch.zeros_like(x)), \
        onehot.sum(dim=1)


def _assign(features, centroids, valid):
    d = _sq_dists(features, centroids)
    d = torch.where(valid[:, None], d, torch.full_like(d, float("inf")))
    return torch.argmin(d, dim=-1)


def kmeans(features, k: int, generator: Optional[torch.Generator] = None,
           n_iters: int = 50, valid=None, start_idx=None):
    """Lloyd's k-means: (centroids [k, D], assignment [N] int32).

    Seeded by furthest-point sampling from start_idx (an int or 0-d
    tensor), drawn uniformly in [0, N) from `generator` when None (the JAX
    package draws it with jax.random.randint; tests hand its draw over).
    Empty clusters keep their centroid."""
    N = features.shape[0]
    dev = features.device
    if valid is None:
        valid = torch.ones((N,), dtype=torch.bool, device=dev)
    if start_idx is None:
        gdev = generator.device if generator is not None else dev
        start_idx = torch.randint(0, N, (), generator=generator,
                                  device=gdev).to(dev)
    init_idx = furthest_point_sampling(features, k, valid=valid,
                                       start_idx=start_idx)
    centroids = features.index_select(0, init_idx)
    for _ in range(n_iters):
        sums, counts = _cluster_sums(features, _assign(features, centroids,
                                                       valid), valid, k)
        centroids = torch.where(counts[:, None] > 0,
                                sums / torch.clamp(counts[:, None], min=1.0),
                                centroids)
    return centroids, _assign(features, centroids, valid).to(torch.int32)


def feature_kmeans(xyz, features, k: int,
                   generator: Optional[torch.Generator] = None,
                   n_iters: int = 50, valid=None, start_idx=None):
    """Cluster `features` (= [xyz, motion_feature]); return (super_xyz
    [k, 3], the mean xyz of each cluster's members, or its centroid's xyz
    where it has none, and the feature centroids [k, D])."""
    centroids, assign = kmeans(features, k, generator, n_iters=n_iters,
                               valid=valid, start_idx=start_idx)
    if valid is None:
        valid = torch.ones((xyz.shape[0],), dtype=torch.bool,
                           device=xyz.device)
    xyz_sum, counts = _cluster_sums(xyz, assign, valid, k)
    super_xyz = torch.where(counts[:, None] > 0,
                            xyz_sum / torch.clamp(counts[:, None], min=1.0),
                            centroids[:, :3])
    return super_xyz, centroids
