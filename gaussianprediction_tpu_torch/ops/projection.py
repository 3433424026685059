"""Gaussian projection: 3D -> 2D screen-space (EWA splatting preprocess).

Torch twin of gaussianprediction_tpu/ops/projection.py: view transform,
z-cull at 0.2, clamped-frustum EWA Jacobian, Σ2D = J W Σ Wᵀ Jᵀ with +0.3
low-pass on the diagonal, conic inversion, 3σ radius from the max
eigenvalue, ndc2pix, and the exact-support tile rects. Same formulas in
the same order, so the integer rects match the JAX package's exactly on
the same floats. Matrices follow the row-vector convention of
utils/camera.py (stored transposed; points multiply on the left).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from gaussianprediction_tpu_torch.utils.math import (
    cov6_to_mat, covariance_from_scaling_rotation,
)

TILE = 16          # pixels per tile side
NEAR_CULL = 0.2    # z threshold of preprocessCUDA's in_frustum

_I32_HI = 2147483520.0   # largest f32 below 2^31


class Projected(NamedTuple):
    """Per-Gaussian screen-space quantities (all [N, ...])."""

    mean2d: torch.Tensor     # [N, 2] pixel coords (ndc2pix)
    conic: torch.Tensor      # [N, 3] inverse 2D covariance (a, b, c)
    depth: torch.Tensor      # [N] view-space z
    radius: torch.Tensor     # [N] int32 pixel radius (0 => culled)
    tiles_min: torch.Tensor  # [N, 2] int32 inclusive tile rect min (x, y)
    tiles_max: torch.Tensor  # [N, 2] int32 exclusive tile rect max (x, y)
    visible: torch.Tensor    # [N] bool


def f32_to_i32(x):
    """f32 -> int32 truncating toward zero and saturating, NaN -> 0: XLA's
    convert semantics (a bare .to(int32) is undefined out of range)."""
    x = torch.nan_to_num(x, nan=0.0)
    return x.clamp(-2147483648.0, _I32_HI).to(torch.int32)


def transform_point(M_rowvec, p):
    """p @ M for homogeneous 4x4 stored row-vector style. p: [N,3]."""
    return p @ M_rowvec[:3, :] + M_rowvec[3, :]


def compute_cov2d(xyz, cov6, view_rowvec, tanfovx, tanfovy, focal_x,
                  focal_y):
    """EWA 2D covariance [N, 3] (xx, xy, yy) with the +0.3 blur added."""
    t = transform_point(view_rowvec, xyz)
    limx = 1.3 * tanfovx
    limy = 1.3 * tanfovy
    tz = t[:, 2]
    txtz = torch.clamp(t[:, 0] / tz, -limx, limx)
    tytz = torch.clamp(t[:, 1] / tz, -limy, limy)
    tx = txtz * tz
    ty = tytz * tz
    zero = torch.zeros_like(tz)
    J = torch.stack(
        [
            torch.stack([focal_x / tz, zero, -(focal_x * tx) / (tz * tz)], -1),
            torch.stack([zero, focal_y / tz, -(focal_y * ty) / (tz * tz)], -1),
        ],
        dim=-2,
    )  # [N, 2, 3]
    W = view_rowvec[:3, :3].T
    Sigma = cov6_to_mat(cov6)
    M = J @ W
    cov = M @ Sigma @ M.transpose(-1, -2)
    return torch.stack(
        [cov[:, 0, 0] + 0.3, cov[:, 0, 1], cov[:, 1, 1] + 0.3], dim=-1
    )


def ndc2pix(v, size):
    return ((v + 1.0) * size - 1.0) * 0.5


def _clip(x, lo, hi):
    return torch.clamp(x, lo, hi)


def project_gaussians(xyz, cov6, view_rowvec, full_proj_rowvec, tanfovx,
                      tanfovy, width: int, height: int, alive=None,
                      opacity=None) -> Projected:
    """Project Gaussians into screen space and compute tile footprints.

    `alive` masks dead capacity rows (radius 0, never binned). `opacity`
    (activated) enables the exact-support tile rects of the JAX package:
    the intersection of the ellipse {d: dᵀΣ⁻¹d = 2·ln(255·op)}'s bounding
    box with the reference's 3σ circle rect; `radius` and `visible` keep
    the circle semantics."""
    focal_x = width / (2.0 * tanfovx)
    focal_y = height / (2.0 * tanfovy)

    p_view = transform_point(view_rowvec, xyz)
    depth = p_view[:, 2]
    in_front = depth > NEAR_CULL

    p_hom = xyz @ full_proj_rowvec[:3, :] + full_proj_rowvec[3, :]
    p_w = 1.0 / (p_hom[:, 3] + 1e-7)
    p_proj = p_hom[:, :3] * p_w[:, None]

    cov2d = compute_cov2d(xyz, cov6, view_rowvec, tanfovx, tanfovy,
                          focal_x, focal_y)
    det = cov2d[:, 0] * cov2d[:, 2] - cov2d[:, 1] ** 2
    det_ok = det != 0.0
    det_inv = 1.0 / torch.where(det_ok, det, torch.ones_like(det))
    conic = torch.stack(
        [cov2d[:, 2] * det_inv, -cov2d[:, 1] * det_inv,
         cov2d[:, 0] * det_inv],
        dim=-1,
    )

    mid = 0.5 * (cov2d[:, 0] + cov2d[:, 2])
    lambda1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius_f = torch.ceil(3.0 * torch.sqrt(lambda1))

    mean2d = torch.stack(
        [ndc2pix(p_proj[:, 0], width), ndc2pix(p_proj[:, 1], height)], dim=-1
    )

    grid_x = (width + TILE - 1) // TILE
    grid_y = (height + TILE - 1) // TILE
    r = radius_f
    mx, my = mean2d[:, 0], mean2d[:, 1]
    if opacity is not None:
        op = torch.clamp(opacity.reshape(-1), 0.0, 1.0)
        tau = torch.clamp(
            2.0 * torch.log(torch.clamp(255.0 * op, min=1e-12)), min=0.0
        )
        rx = torch.ceil(torch.minimum(torch.sqrt(tau * cov2d[:, 0]), radius_f))
        ry = torch.ceil(torch.minimum(torch.sqrt(tau * cov2d[:, 2]), radius_f))
        empty = torch.full_like(rx, -float(TILE))
        rx = torch.where(tau > 0.0, rx, empty)
        ry = torch.where(tau > 0.0, ry, empty)
    else:
        rx = r
        ry = r
    tmin = torch.stack(
        [_clip(f32_to_i32((mx - rx) / TILE), 0, grid_x),
         _clip(f32_to_i32((my - ry) / TILE), 0, grid_y)], dim=-1
    )
    if opacity is not None:
        # exclusive max = floor((p + r)/TILE) + 1 (exact-support rects)
        tmax = torch.stack(
            [_clip(f32_to_i32(torch.floor((mx + rx) / TILE)) + 1, 0, grid_x),
             _clip(f32_to_i32(torch.floor((my + ry) / TILE)) + 1, 0, grid_y)],
            dim=-1,
        )
    else:
        tmax = torch.stack(
            [_clip(f32_to_i32((mx + rx + TILE - 1) / TILE), 0, grid_x),
             _clip(f32_to_i32((my + ry + TILE - 1) / TILE), 0, grid_y)],
            dim=-1,
        )
    # visibility from the reference's circle rect
    tmin_v = torch.stack(
        [_clip(f32_to_i32((mx - r) / TILE), 0, grid_x),
         _clip(f32_to_i32((my - r) / TILE), 0, grid_y)], dim=-1
    )
    tmax_v = torch.stack(
        [_clip(f32_to_i32((mx + r + TILE - 1) / TILE), 0, grid_x),
         _clip(f32_to_i32((my + r + TILE - 1) / TILE), 0, grid_y)], dim=-1
    )
    tiles_touched = ((tmax_v[:, 0] - tmin_v[:, 0])
                     * (tmax_v[:, 1] - tmin_v[:, 1]))

    visible = in_front & det_ok & (tiles_touched > 0)
    if alive is not None:
        visible = visible & alive
    radius = f32_to_i32(
        torch.where(visible, radius_f, torch.zeros_like(radius_f)))
    if opacity is not None:
        tmax = torch.minimum(tmax, tmax_v)
        tmin = torch.maximum(tmin, tmin_v)
    tmax = torch.maximum(tmax, tmin)
    zero = torch.zeros_like(tmin)
    return Projected(
        mean2d=mean2d,
        conic=conic,
        depth=depth,
        radius=radius,
        tiles_min=torch.where(visible[:, None], tmin, zero),
        tiles_max=torch.where(visible[:, None], tmax, zero),
        visible=visible,
    )


def project_from_params(xyz, scaling, rotation, cam, width, height,
                        scaling_modifier=1.0, alive=None,
                        opacity=None) -> Projected:
    """Activated scale/rot -> covariance -> project."""
    cov6 = covariance_from_scaling_rotation(scaling, rotation,
                                            scaling_modifier)
    return project_gaussians(
        xyz, cov6, cam["world_view"], cam["full_proj"],
        cam["tanfovx"], cam["tanfovy"], width, height, alive=alive,
        opacity=opacity,
    )
