"""Public render API: one view of Gaussians -> image, depth, alpha, tidx.

Torch twin of gaussianprediction_tpu/ops/rasterize.py:render: projection +
covariance (ops/projection.py), SH color (utils/sh.py), the fused instance
stream (ops/instance_stream.py) and the tile blend
(ops/rasterize_kernels.py), then tile -> image assembly. The returned dict
has the JAX package's keys.

When any input needs a gradient, the stream and the blend run through
their autograd Functions, so gradients reach xyz, scaling, rotation,
opacity, shs (or colors_precomp) and means2d_dummy; otherwise (eval, under
torch.no_grad) the kernels are called directly.
"""
from __future__ import annotations

import torch

from gaussianprediction_tpu_torch.ops import instance_stream, projection
from gaussianprediction_tpu_torch.ops import rasterize_kernels as rk
from gaussianprediction_tpu_torch.ops.projection import TILE
from gaussianprediction_tpu_torch.utils import sh as shlib

CHUNK = 128        # capacity rounding of the JAX package's render


def _assemble(per_tile, grid_x, grid_y, height, width):
    """[T, 256, C] tile buffers -> [H, W, C] image (crop off tile padding)."""
    C = per_tile.shape[-1]
    img = per_tile.reshape(grid_y, grid_x, 16, 16, C)
    img = img.permute(0, 2, 1, 3, 4).reshape(grid_y * 16, grid_x * 16, C)
    return img[:height, :width]


def render(xyz, scaling, rotation, opacity, shs, cam: dict, width: int,
           height: int, bg, sh_degree: int = 3, colors_precomp=None,
           alive=None, scaling_modifier: float = 1.0,
           capacity_multiplier=24, tile_band=None,
           fast_binning: bool = True, max_tiles: int = 1024,
           need_tidx: bool = True, means2d_dummy=None):
    """Render one view. scaling and opacity are activated, rotation
    unnormalized, shs [N, 3, K] (or colors_precomp [N, 3]).

    means2d_dummy ([N, 2] zeros, optional) is the NDC-scale gradient
    carrier of the reference CUDA rasterizer: it enters the projected means
    as dummy * (W/2, H/2), so its gradient is the screen-space gradient in
    NDC units that the densification thresholds assume.

    capacity_multiplier * N bounds the instance buffer; drops are reported
    in "n_dropped" so callers can size it for exact renders. Tile rects are
    always the exact-support ones (the JAX default, tight_rects=True); the
    JAX render's cov3d_precomp and tight_rects=False await a caller."""
    if tile_band is not None or not fast_binning:
        raise NotImplementedError(
            "tile_band and fast_binning=False are not ported yet "
            "(ROADMAP.md, Queue 1)"
        )
    N = xyz.shape[0]
    dev = xyz.device
    grid_x = (width + TILE - 1) // TILE
    grid_y = (height + TILE - 1) // TILE
    bg = torch.as_tensor(bg, dtype=torch.float32, device=dev)

    if N == 0:
        zeros = torch.zeros((height, width), device=dev)
        return {
            "render": bg.expand(height, width, 3).clone(),
            "depth": zeros,
            "alpha": zeros,
            "tidx": torch.full((height, width), -1, dtype=torch.int32,
                               device=dev),
            "radii": torch.zeros((0,), dtype=torch.int32, device=dev),
            "visibility_filter": torch.zeros((0,), dtype=torch.bool,
                                             device=dev),
            "n_dropped": torch.zeros((), dtype=torch.int32, device=dev),
            "n_instances": torch.zeros((), dtype=torch.int32, device=dev),
            "proj": None,
        }

    rotation = rotation / torch.linalg.norm(rotation, dim=-1, keepdim=True)
    # exact-support tile rects: the opacity drives integer rects only
    proj = projection.project_from_params(
        xyz, scaling, rotation, cam, width, height,
        scaling_modifier=scaling_modifier, alive=alive,
        opacity=opacity.detach(),
    )
    mean2d = proj.mean2d
    if means2d_dummy is not None:
        mean2d = mean2d + means2d_dummy * torch.tensor(
            [width * 0.5, height * 0.5], dtype=torch.float32, device=dev)

    if colors_precomp is None:
        dirs = xyz - cam["camera_center"][None, :]
        dirs = dirs / torch.clamp(
            torch.linalg.norm(dirs, dim=-1, keepdim=True), min=1e-12)
        colors, _ = shlib.sh_to_rgb_clamped(sh_degree, shs, dirs)
    else:
        colors = colors_precomp

    capacity = max(int(capacity_multiplier * N), CHUNK)
    capacity = ((capacity + CHUNK - 1) // CHUNK) * CHUNK
    feat = torch.cat(
        [mean2d, proj.conic, (opacity.reshape(-1) * 1.0)[:, None],
         colors, proj.depth[:, None]],
        dim=-1,
    ).to(torch.float32)  # [N, 10]
    if feat.requires_grad:
        stream = instance_stream.build_instances(
            feat, proj.tiles_min, proj.tiles_max, proj.visible, grid_x,
            grid_y, capacity, max_tiles,
        )
        out_f = rk.RasterizeBinned.apply(stream.inst, stream.tile_start,
                                         stream.tile_end, grid_x, grid_y,
                                         need_tidx)
    else:
        stream = instance_stream.build_instances_fwd(
            feat, proj.tiles_min, proj.tiles_max, proj.visible, grid_x,
            grid_y, capacity, max_tiles,
        )
        out_f = rk.rasterize_binned(stream.inst, stream.tile_start,
                                    stream.tile_end, grid_x, grid_y,
                                    need_tidx)

    img = _assemble(out_f, grid_x, grid_y, height, width)  # [H, W, 8]
    T_final = img[..., rk.O_T]
    rgb = img[..., rk.O_R:rk.O_R + 3] + T_final[..., None] * bg
    tidx = torch.where(img[..., rk.O_WMAX] > 0.0, img[..., rk.O_GID],
                       torch.full_like(T_final, -1.0)).to(torch.int32)
    return {
        "render": rgb,
        "depth": img[..., rk.O_Z],
        "alpha": 1.0 - T_final,
        "tidx": tidx,
        "radii": proj.radius,
        "visibility_filter": proj.radius > 0,
        "n_dropped": stream.n_dropped,
        "n_instances": stream.n_total,
        "proj": proj,
    }
