"""Tile binning: depth-ordered per-tile Gaussian instance lists.

Torch twin of gaussianprediction_tpu/ops/binning.py (Binning,
_inverse_ranges, bin_gaussians), the classic render path
(render(fast_binning=False)). Every layout step is a sort, a scan, a
binary search or a gather:

1. the Gaussians sorted once by view depth (stable; the depth keyed by
   instance_stream.orderable_bits, so -0.0 / +0.0 ties and NaNs order as
   lax.sort orders them);
2. in depth order Gaussian g owns count[g] consecutive slots (the
   exclusive cumsum of its capped rect's area); slot j belongs to
   g(j) = searchsorted(offsets, j, right) - 1, at in-rect index
   k(j) = j - offsets[g(j)];
3. one stable sort of the slots by tile id keeps depth order inside each
   tile;
4. per-tile [start, end) by searchsorted over the sorted tile ids;
5. align > 1 pads each tile's segment to a multiple of `align` slots (a
   gather too): padded slot j of tile t holds source instance
   tile_start[t] + (j - padded_start[t]). The segments are then ordered
   but not contiguous: tile_end[t] <= tile_start[t + 1].

Instances past capacity, and rect tiles past max_tiles_per_gaussian, are
dropped and counted in n_dropped. No kernel runs here.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from gaussianprediction_tpu_torch.ops.instance_stream import orderable_bits
from gaussianprediction_tpu_torch.ops.projection import (
    TILE, Projected, f32_to_i32,
)


class Binning(NamedTuple):
    gauss_id: torch.Tensor     # [P] int32 Gaussian index (-1: padding slot)
    tile_id: torch.Tensor      # [P] int32 owning tile (T: unused)
    tile_start: torch.Tensor   # [T] int32 first instance of each tile
    tile_end: torch.Tensor     # [T] int32 one past the last
    n_instances: torch.Tensor  # [] int32 instances before any drop
    n_dropped: torch.Tensor    # [] int32 instances lost to capacity / cap


def _inverse_ranges(starts, queries):
    """For nondecreasing `starts` [M], the range each query falls in:
    searchsorted(starts, q, right) - 1 (int32)."""
    return torch.searchsorted(starts.contiguous(), queries.contiguous(),
                              right=True, out_int32=True) - 1


def bin_gaussians(proj: Projected, width: int, height: int, capacity: int,
                  max_tiles_per_gaussian: int = 1024,
                  align: int = 1) -> Binning:
    """The per-tile instance list of a projection. align > 1 pads each
    tile's segment to a multiple of `align` slots (padding rows: gauss_id
    -1, tile_id T)."""
    dev = proj.depth.device
    i32 = torch.int32
    grid_x = (width + TILE - 1) // TILE
    grid_y = (height + TILE - 1) // TILE
    num_tiles = grid_x * grid_y
    N = proj.depth.shape[0]

    # 1. global depth order
    order = torch.sort(orderable_bits(proj.depth), stable=True
                       ).indices.to(i32)
    o64 = order.to(torch.int64)
    tmin = proj.tiles_min[o64]
    tmax = proj.tiles_max[o64]
    vis = proj.visible[o64]
    zero = torch.zeros_like(tmin[:, 0])

    rect_w = torch.clamp(tmax[:, 0] - tmin[:, 0], min=0)
    rect_h = torch.clamp(tmax[:, 1] - tmin[:, 1], min=0)
    count_full = torch.where(vis, rect_w * rect_h, zero)
    # the footprint cap: a sub-rect of <= max tiles centred on the mean
    rw_c = torch.clamp(rect_w, max=max_tiles_per_gaussian)
    rh_c = torch.minimum(rect_h, torch.clamp(
        max_tiles_per_gaussian // torch.clamp(rw_c, min=1), min=1))
    rh_c = torch.where(rect_w > 0, rh_c, zero)
    ctx = f32_to_i32(proj.mean2d[o64, 0] / TILE)
    cty = f32_to_i32(proj.mean2d[o64, 1] / TILE)
    x0 = torch.minimum(torch.maximum(ctx - rw_c // 2, tmin[:, 0]),
                       tmax[:, 0] - rw_c)
    y0 = torch.minimum(torch.maximum(cty - rh_c // 2, tmin[:, 1]),
                       tmax[:, 1] - rh_c)
    count = torch.where(vis, rw_c * rh_c, zero)
    offsets = (torch.cumsum(count, 0) - count).to(i32)
    total = (offsets[-1] + count[-1]).to(i32)

    # 2. compact expansion by inverse lookup
    j = torch.arange(capacity, dtype=i32, device=dev)
    g = _inverse_ranges(offsets, torch.minimum(j, total - 1))
    g = torch.clamp(g, 0, N - 1).to(torch.int64)
    k = j - offsets[g]
    rw = torch.clamp(rw_c[g], min=1)
    ty = y0[g] + torch.div(k, rw, rounding_mode="floor")
    tx = x0[g] + torch.remainder(k, rw)
    valid = j < torch.clamp(total, max=capacity)
    sentinel = torch.full_like(j, num_tiles)
    tile_id = torch.where(valid, (ty * grid_x + tx).to(i32), sentinel)
    gauss_id = torch.where(valid, order[g], torch.zeros_like(j))

    # 3. a stable sort by tile id keeps depth order inside tiles
    perm = torch.sort(tile_id, stable=True).indices
    tile_id = tile_id[perm]
    gauss_id = gauss_id[perm]

    # 4. per-tile ranges
    tids = torch.arange(num_tiles, dtype=i32, device=dev)
    tile_start = torch.searchsorted(tile_id, tids, out_int32=True)
    tile_end = torch.searchsorted(tile_id, tids, right=True, out_int32=True)

    n_valid = (tile_id < num_tiles).sum()
    n_dropped = count_full.sum() - n_valid

    if align > 1:
        # 5. the chunk-aligned re-layout, as a gather
        counts = tile_end - tile_start
        padded_counts = torch.div(counts + align - 1, align,
                                  rounding_mode="floor") * align
        padded_start = (torch.cumsum(padded_counts, 0) - padded_counts
                        ).to(i32)
        padded_total = padded_start[-1] + padded_counts[-1]
        t_of = _inverse_ranges(padded_start,
                               torch.minimum(j, padded_total - 1))
        t_of = torch.clamp(t_of, 0, num_tiles - 1).to(torch.int64)
        in_tile = j - padded_start[t_of]
        src = tile_start[t_of] + in_tile
        real = (in_tile < counts[t_of]) & (j < padded_total)
        src = torch.clamp(src, 0, capacity - 1).to(torch.int64)
        new_tile = torch.where(real, tile_id[src], sentinel)
        new_gid = torch.where(real, gauss_id[src], torch.full_like(j, -1))
        # instances whose padded position falls past capacity are lost
        over = padded_start + counts - capacity
        lost = torch.where(over > 0, torch.minimum(counts, over),
                           torch.zeros_like(counts)).sum()
        tile_id, gauss_id = new_tile, new_gid
        # ranges clamped into the buffer (capacity is a multiple of align
        # at the render, so clamped starts stay aligned)
        tile_start = torch.clamp(padded_start, max=capacity)
        tile_end = torch.clamp(padded_start + counts, max=capacity)
        n_dropped = n_dropped + lost

    return Binning(gauss_id=gauss_id, tile_id=tile_id,
                   tile_start=tile_start.to(i32), tile_end=tile_end.to(i32),
                   n_instances=total, n_dropped=n_dropped.to(i32))
