"""Learning-rate and noise-decay schedules.

Torch twin of gaussianprediction_tpu/utils/schedules.py (expon_lr,
linear_anneal): f32 functions of the step, in the JAX package's order of
operations."""
from __future__ import annotations

import math

import torch


def expon_lr(step, lr_init: float, lr_final: float, lr_delay_steps: int = 0,
             lr_delay_mult: float = 1.0, max_steps: int = 1_000_000):
    """Log-linear decay from lr_init to lr_final over max_steps with an
    optional sine delay ramp; 0 when both rates are 0 or step < 0."""
    f32 = torch.float32
    step = torch.as_tensor(step, dtype=f32)
    if lr_init == 0.0 and lr_final == 0.0:
        return torch.zeros_like(step)
    if lr_delay_steps > 0:
        delay_rate = lr_delay_mult + (1 - lr_delay_mult) * torch.sin(
            0.5 * math.pi * torch.clamp(step / lr_delay_steps, 0.0, 1.0))
    else:
        delay_rate = 1.0
    t = torch.clamp(step / max_steps, 0.0, 1.0)
    log_init = torch.log(torch.tensor(lr_init, dtype=f32))
    log_final = torch.log(torch.tensor(lr_final, dtype=f32))
    lr = delay_rate * torch.exp(log_init * (1 - t) + log_final * t)
    return torch.where(step < 0, torch.zeros_like(lr), lr)


def linear_anneal(step, init: float, end_step: int):
    """init * (1 - min(1, step/end_step)) in f32, as the JAX twin."""
    step = torch.as_tensor(step, dtype=torch.float32)
    return init * (1.0 - torch.clamp(step / end_step, max=1.0))
