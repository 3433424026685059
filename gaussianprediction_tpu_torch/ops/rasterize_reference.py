"""Slow, exact torch rasterizer: the correctness oracle of the tests.

Torch twin of gaussianprediction_tpu/ops/rasterize_reference.py: a loop
over the depth-sorted Gaussians carrying per-pixel (T, done, accumulators)
with the reference CUDA rasterizer's semantics — per-tile rect test, the
0.99 alpha clamp and 1/255 cutoff, front-to-back blending with the 1e-4
done latch, background composite, expected depth and the most-contributing
Gaussian's id (tidx). O(N·H·W): for tests at small sizes only.
"""
from __future__ import annotations

import torch

from gaussianprediction_tpu_torch.ops.projection import TILE, Projected

ALPHA_CLAMP = 0.99
ALPHA_MIN = 1.0 / 255.0
T_EPS = 1e-4


def rasterize_pixels_reference(proj: Projected, colors, opacity, bg,
                               width: int, height: int):
    """Returns (rgb [H, W, 3], depth [H, W], alpha [H, W], tidx [H, W])."""
    dev = colors.device
    opacity = opacity.reshape(-1)
    order = torch.argsort(proj.depth, stable=True)
    gx, gy = torch.meshgrid(
        torch.arange(width, dtype=torch.float32, device=dev),
        torch.arange(height, dtype=torch.float32, device=dev),
        indexing="xy",
    )
    tile_x = (gx / TILE).to(torch.int32)
    tile_y = (gy / TILE).to(torch.int32)
    H, W = height, width
    T = torch.ones((H, W), device=dev)
    done = torch.zeros((H, W), dtype=torch.bool, device=dev)
    rgb = torch.zeros((H, W, 3), device=dev)
    dep = torch.zeros((H, W), device=dev)
    w_max = torch.zeros((H, W), device=dev)
    best = torch.full((H, W), -1, dtype=torch.int32, device=dev)
    zero = torch.zeros((), device=dev)
    for g in order.tolist():
        if not bool(proj.visible[g]):
            continue
        m2d, con = proj.mean2d[g], proj.conic[g]
        tn, tx = proj.tiles_min[g], proj.tiles_max[g]
        dx = gx - m2d[0]
        dy = gy - m2d[1]
        power = -0.5 * (con[0] * dx * dx + con[2] * dy * dy) \
            - con[1] * dx * dy
        alpha = torch.clamp(opacity[g] * torch.exp(power), max=ALPHA_CLAMP)
        in_rect = ((tile_x >= tn[0]) & (tile_x < tx[0])
                   & (tile_y >= tn[1]) & (tile_y < tx[1]))
        valid = in_rect & (power <= 0.0) & (alpha >= ALPHA_MIN) & ~done
        test_T = T * (1.0 - alpha)
        newly_done = valid & (test_T < T_EPS)
        contrib = valid & ~newly_done
        w = torch.where(contrib, alpha * T, zero)
        rgb = rgb + w[..., None] * colors[g][None, None, :]
        dep = dep + w * proj.depth[g]
        T = torch.where(contrib, test_T, T)
        done = done | newly_done
        better = w > w_max
        w_max = torch.where(better, w, w_max)
        best = torch.where(better, torch.full_like(best, g), best)
    bg = torch.as_tensor(bg, dtype=torch.float32, device=dev)
    return rgb + T[..., None] * bg, dep, 1.0 - T, best
