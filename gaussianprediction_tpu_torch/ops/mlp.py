"""The small ReLU MLPs of the deformation field and the blend weights.

Torch twin of gaussianprediction_tpu/ops/hashgrid.py:init_mlp and
mlp_apply (the hash-grid encoder is ops/hashgrid.py). Layers are
a list of {"w": [fan_in, fan_out], "b": [fan_out]} dicts, the JAX layout,
so weights carry across without transposes.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch


def init_mlp(rng: np.random.Generator, sizes: Sequence[int]):
    """torch.nn.Linear-style init, U(±1/sqrt(fan_in)) for W and b, drawn
    with numpy on the host; returns float32 numpy layers (convert.py puts
    them on the device with the rest of the state)."""
    layers = []
    for i in range(len(sizes) - 1):
        lim = 1.0 / math.sqrt(sizes[i])
        layers.append({
            "w": rng.uniform(-lim, lim, (sizes[i], sizes[i + 1])).astype(
                np.float32),
            "b": rng.uniform(-lim, lim, (sizes[i + 1],)).astype(np.float32),
        })
    return layers


def mlp_apply(layers, x):
    """x @ W + b per layer with ReLU between layers (none after the last)."""
    for i, layer in enumerate(layers):
        x = x @ layer["w"] + layer["b"]
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x
