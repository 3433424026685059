"""Checkpoint save and restore: the whole training state in one .npz.

Torch twin of gaussianprediction_tpu/train/checkpoint.py, in its layout:
path-flattened keys "params/<name>/...", "opt/m/...", "opt/v/...",
"opt/step", and under "meta/" the alive masks (alive, kpt_alive), the
densification statistics and the iteration. The JAX package stores its
PRNG key as meta/rng_key; the port stores the state of its
torch.Generator as meta/torch_generator (uint8), and beside it a
meta/rng_key so that the JAX package's loader reads the port's
checkpoints too: the key data of PRNGKey(2024 * seed) (uint32[2], the
high and low 32 bits), the key the JAX Trainer starts from. It is a fresh
key, not a continuation of the torch stream: a JAX run resumed from it
draws other numbers than the port's run would have. A checkpoint of
either package loads here (convert.load_jax_checkpoint reads the arrays;
the port's own generator state is preferred to the key); the port's own
round-trips bit for bit.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from gaussianprediction_tpu_torch.convert import (
    flatten as _flatten, load_jax_checkpoint,
)
from gaussianprediction_tpu_torch.models.gaussians import (
    STATS, GaussianState,
)
from gaussianprediction_tpu_torch.utils.jax_random import key_data

GENERATOR_KEY = "meta/torch_generator"


def jax_key_data(seed: int) -> np.ndarray:
    """The key data of the JAX package's PRNGKey(2024 * seed), computed
    without JAX: threefry's key is the seed's high and low 32 bits (JAX
    with 64-bit integers off keeps the low word only; the two agree for
    0 <= 2024 * seed < 2^32)."""
    return key_data(2024 * int(seed))


def save_checkpoint(path: str, state: GaussianState, opt_state,
                    iteration: int,
                    generator: Optional[torch.Generator] = None,
                    seed: int = 0):
    """Write params, Adam state, masks, statistics, the iteration, the JAX
    key of `seed` and the generator's state to `path` (.npz)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    meta = {"alive": state.alive, "kpt_alive": state.kpt_alive,
            **{k: getattr(state, k) for k in STATS},
            "iteration": np.int64(iteration), "rng_key": jax_key_data(seed)}
    if generator is not None:
        meta["torch_generator"] = generator.get_state()
    np.savez(path, **_flatten({"params": state.params, "opt": opt_state,
                               "meta": meta}))


def load_checkpoint(path: str, device=None
                    ) -> Tuple[GaussianState, dict, int,
                               Optional[torch.Tensor]]:
    """(state, opt_state, iteration, generator state or None) from a
    checkpoint of either package; the generator state is None for a JAX
    checkpoint (its PRNG key has no torch counterpart)."""
    state, opt_state, iteration = load_jax_checkpoint(path, device)
    with np.load(path) as f:
        gen = (torch.from_numpy(f[GENERATOR_KEY].copy())
               if GENERATOR_KEY in f.files else None)
    return state, opt_state, iteration, gen
