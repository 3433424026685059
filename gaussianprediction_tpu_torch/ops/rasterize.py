"""Public render API: one view of Gaussians -> image, depth, alpha, tidx.

Torch twin of gaussianprediction_tpu/ops/rasterize.py:render: projection +
covariance (ops/projection.py), SH color (utils/sh.py), the instance
stream and the tile blend (ops/rasterize_kernels.py), then tile -> image
assembly. The returned dict has the JAX package's keys. The stream comes
from the fused instance stream (ops/instance_stream.py, the default) or,
with fast_binning=False, from the classic binning (ops/binning.py), whose
CHUNK-aligned segments the blend reads as they are.

When any input needs a gradient, the stream and the blend run through
their autograd Functions, so gradients reach xyz, scaling, rotation,
opacity, shs (or colors_precomp), cov3d_precomp and means2d_dummy;
otherwise (eval, under torch.no_grad) the kernels are called directly.
"""
from __future__ import annotations

import functools

import torch

from gaussianprediction_tpu_torch.ops import (
    binning, instance_stream, projection,
)
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


@functools.lru_cache(maxsize=None)
def _ndc_half_extent(width: int, height: int, device: torch.device):
    """[2] f32 (width / 2, height / 2), made once per (size, device): a
    copy from the host on every step would block the host."""
    return torch.tensor([width * 0.5, height * 0.5], dtype=torch.float32,
                        device=device)


def binned_instances(feat, gauss_id):
    """The classic path's [16, P] instance SoA: feat rows gathered by
    gauss_id (zero on the padding rows, gauss_id -1), then the gid row,
    the valid row and four zero rows (the JAX render's layout)."""
    valid = (gauss_id >= 0).to(torch.float32)
    gid = torch.clamp(gauss_id, min=0).to(torch.int64)
    rows = feat.T.index_select(1, gid) * valid
    P = gauss_id.shape[0]
    return torch.cat([rows, gauss_id.to(torch.float32)[None], valid[None],
                      feat.new_zeros((rk.NCH - 12, P))], dim=0)


class _BinnedInstances(torch.autograd.Function):
    """binned_instances with its gradient w.r.t. feat. The JAX package
    differentiates the gather feat[gid]; here the cotangent columns are
    reduced per Gaussian by instance_stream.build_instances_bwd (a sort by
    gid and cumsum differences, GPT_BWD_REDUCE's modes), so no atomics run
    and a step repeats bit for bit. Padding slots (gid -1) sort into its
    negative prefix; each Gaussian's kept count is its number of slots."""

    @staticmethod
    def forward(ctx, feat, gauss_id):
        inst = binned_instances(feat.detach(), gauss_id)
        kept = torch.zeros((feat.shape[0] + 1,), dtype=torch.int32,
                           device=feat.device)
        kept.scatter_add_(0, (gauss_id.to(torch.int64) + 1),
                          torch.ones_like(gauss_id, dtype=torch.int32))
        ctx.save_for_backward(inst, kept[1:])
        return inst

    @staticmethod
    def backward(ctx, d_inst):
        inst, kept = ctx.saved_tensors
        dfeat = instance_stream.build_instances_bwd(
            inst[instance_stream.C_GID_ROW], kept, d_inst)
        return dfeat, None


def render(xyz, scaling, rotation, opacity, shs, cam: dict, width: int,
           height: int, bg, sh_degree: int = 3, colors_precomp=None,
           alive=None, scaling_modifier: float = 1.0,
           capacity_multiplier=24, tile_band=None,
           fast_binning: bool = True, max_tiles: int = 1024,
           need_tidx: bool = True, means2d_dummy=None, cov3d_precomp=None,
           tight_rects: bool = True):
    """Render one view. scaling and opacity are activated, rotation
    unnormalized, shs [N, 3, K] (or colors_precomp [N, 3]).

    means2d_dummy ([N, 2] zeros, optional) is the NDC-scale gradient
    carrier of the reference CUDA rasterizer: it enters the projected means
    as dummy * (W/2, H/2), so its gradient is the screen-space gradient in
    NDC units that the densification thresholds assume.

    cov3d_precomp ([N, 6] packed upper triangle, optional) replaces the
    covariance of scaling and rotation (the reference's
    compute_cov3D_python path). tight_rects=True bins each Gaussian over
    the exact support of its ellipse at alpha 1/255 (the opacity drives
    integer rects only); False over the reference's 3-sigma circle rect.

    capacity_multiplier * N bounds the instance buffer; drops are reported
    in "n_dropped" so callers can size it for exact renders.
    fast_binning=False bins through ops/binning.py (a depth sort, a
    stable tile sort, CHUNK-aligned segments) in place of the fused
    stream; the outputs are the same where neither drops.

    tile_band=(ty0, n_band) renders only the band of tile rows [ty0, ty0 +
    n_band), the framebuffer split of the sharded step
    (parallel/shard.py): rects are clamped to the band's rows (a rect the
    clamp empties is invisible there), the means shift up by ty0 * 16
    pixels, and the band renders as a standalone grid_x x n_band grid.
    "render", "depth", "alpha" and "tidx" are the band's n_band * 16 rows
    (past `height` for a band that reaches below the image: callers
    crop); "radii", "visibility_filter" and "proj" stay those of the whole
    view. The max-tiles cap applies after the clamp, so a band equals the
    same rows of the whole render where no rect is capped."""
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
    op_rect = opacity.detach() if tight_rects else None
    if cov3d_precomp is not None:
        proj = projection.project_gaussians(
            xyz, cov3d_precomp, cam["world_view"], cam["full_proj"],
            cam["tanfovx"], cam["tanfovy"], width, height, alive=alive,
            opacity=op_rect)
    else:
        proj = projection.project_from_params(
            xyz, scaling, rotation, cam, width, height,
            scaling_modifier=scaling_modifier, alive=alive, opacity=op_rect)
    full_proj = proj
    mean2d = proj.mean2d
    if means2d_dummy is not None:
        mean2d = mean2d + means2d_dummy * _ndc_half_extent(width, height,
                                                          dev)
    band_height = height
    if tile_band is not None:
        ty0, n_band = int(tile_band[0]), int(tile_band[1])
        bmin_y = torch.clamp(proj.tiles_min[:, 1], ty0, ty0 + n_band) - ty0
        bmax_y = torch.clamp(proj.tiles_max[:, 1], ty0, ty0 + n_band) - ty0
        visible_b = proj.visible & (bmax_y > bmin_y)
        mean2d = mean2d - torch.tensor([0.0, ty0 * TILE],
                                       dtype=torch.float32, device=dev)
        proj = projection.Projected(
            mean2d=mean2d, conic=proj.conic, depth=proj.depth,
            radius=torch.where(visible_b, proj.radius,
                               torch.zeros_like(proj.radius)),
            tiles_min=torch.stack([proj.tiles_min[:, 0], bmin_y], dim=-1),
            tiles_max=torch.stack([proj.tiles_max[:, 0], bmax_y], dim=-1),
            visible=visible_b)
        grid_y = n_band
        band_height = n_band * TILE

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
    if not fast_binning:
        with torch.no_grad():
            bins = binning.bin_gaussians(proj._replace(
                mean2d=mean2d.detach()), width, band_height, capacity,
                align=CHUNK)
        inst = (_BinnedInstances.apply(feat, bins.gauss_id)
                if feat.requires_grad
                else binned_instances(feat, bins.gauss_id))
        stream = instance_stream.InstanceStream(
            inst, bins.tile_start, bins.tile_end, bins.n_dropped,
            ((bins.tile_end - bins.tile_start).sum()
             + bins.n_dropped).to(torch.int32))
    elif feat.requires_grad:
        stream = instance_stream.build_instances(
            feat, proj.tiles_min, proj.tiles_max, proj.visible, grid_x,
            grid_y, capacity, max_tiles,
        )
    else:
        stream = instance_stream.build_instances_fwd(
            feat, proj.tiles_min, proj.tiles_max, proj.visible, grid_x,
            grid_y, capacity, max_tiles,
        )
    if feat.requires_grad:
        out_f = rk.RasterizeBinned.apply(stream.inst, stream.tile_start,
                                         stream.tile_end, grid_x, grid_y,
                                         need_tidx)
    else:
        out_f = rk.rasterize_binned(stream.inst, stream.tile_start,
                                    stream.tile_end, grid_x, grid_y,
                                    need_tidx)

    img = _assemble(out_f, grid_x, grid_y, band_height, width)  # [h, W, 8]
    T_final = img[..., rk.O_T]
    rgb = img[..., rk.O_R:rk.O_R + 3] + T_final[..., None] * bg
    tidx = torch.where(img[..., rk.O_WMAX] > 0.0, img[..., rk.O_GID],
                       torch.full_like(T_final, -1.0)).to(torch.int32)
    return {
        "render": rgb,
        "depth": img[..., rk.O_Z],
        "alpha": 1.0 - T_final,
        "tidx": tidx,
        "radii": full_proj.radius,
        "visibility_filter": full_proj.radius > 0,
        "n_dropped": stream.n_dropped,
        "n_instances": stream.n_total,
        "proj": full_proj,
    }
