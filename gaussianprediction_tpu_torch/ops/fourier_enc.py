"""Multi-scale Fourier position encoder (the `fourier` weight encoder).

Torch twin of gaussianprediction_tpu/ops/fourier_enc.py:

    feat(x) = [sin, cos](x_norm @ B),   B [3, L*D]

where column block l of B holds D random unit directions scaled by 2π
times the hash grid's resolution ladder (n_min to max_res over L levels),
so the encoding spans the same spatial frequencies. B is a constant drawn
from a fixed seed, not a parameter: the encoder has no tables, and the
model's capacity is in its weight MLP.

The JAX package draws B with jax.random.normal(PRNGKey(20240519), ...);
fourier_dirs makes the same matrix with numpy (utils/jax_random.py), to a
few f32 ulps, so a JAX `fourier` checkpoint encodes the same here.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from gaussianprediction_tpu_torch.utils import jax_random

SEED = 20240519


@functools.lru_cache(maxsize=None)
def _dirs_np(n_levels: int, per_level: int, n_min: int, max_res: int,
             seed: int) -> np.ndarray:
    b = math.exp(math.log(max_res / n_min) / (n_levels - 1))
    dirs = jax_random.normal(jax_random.key_data(seed),
                             (3, n_levels * per_level))
    norm = np.sqrt(np.sum(dirs * dirs, axis=0, keepdims=True,
                          dtype=np.float32)).astype(np.float32)
    dirs = (dirs / norm).astype(np.float32)
    res = np.asarray([n_min * (b ** l) for l in range(n_levels)
                      for _ in range(per_level)], np.float32)
    # one period spans 1/res_l of the normalized [0, 1] domain
    return (dirs * (np.float32(2.0 * math.pi) * res)[None, :]).astype(
        np.float32)


def fourier_dirs(n_levels: int = 16, per_level: int = 4, n_min: int = 16,
                 max_res: int = 2048, bound: float = 1.6,
                 seed: int = SEED) -> np.ndarray:
    """The frequency matrix B [3, n_levels * per_level] (float32 numpy).
    `bound` is unused, as in the JAX package (the encode normalizes)."""
    return _dirs_np(n_levels, per_level, n_min, max_res, seed).copy()


@functools.lru_cache(maxsize=None)
def _dirs_on(n_levels: int, per_level: int, n_min: int, max_res: int,
             device: torch.device) -> torch.Tensor:
    """B on a device, made once per (ladder, device): a host-to-device copy
    on every encode would block the host."""
    return torch.as_tensor(_dirs_np(n_levels, per_level, n_min, max_res,
                                    SEED), device=device)


def model_dirs(m, device) -> torch.Tensor:
    """The model's B (cfg.model's ladder) on `device`."""
    return _dirs_on(m.hash_levels, m.fourier_per_level, m.hash_min_res,
                    m.hash_max_res, torch.device(device))


def fourier_encode(B, xyz, bound: float = 1.6):
    """xyz [N, 3] -> [N, 2 * cols] features: sin then cos of the phases."""
    x = torch.clamp((xyz + bound) / (2.0 * bound), 0.0, 1.0)
    phase = x @ B
    return torch.cat([torch.sin(phase), torch.cos(phase)], dim=-1)


def fourier_feature_dim(n_levels: int, per_level: int) -> int:
    return 2 * n_levels * per_level
