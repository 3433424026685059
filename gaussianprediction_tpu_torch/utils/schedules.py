"""Noise-decay schedule of the deformation stages.

Torch twin of gaussianprediction_tpu/utils/schedules.py:linear_anneal (the
learning-rate schedules wait for the training port)."""
from __future__ import annotations

import torch


def linear_anneal(step, init: float, end_step: int):
    """init * (1 - min(1, step/end_step)) in f32, as the JAX twin."""
    step = torch.as_tensor(step, dtype=torch.float32)
    return init * (1.0 - torch.clamp(step / end_step, max=1.0))
