"""Instance-stream construction (binning + packing) and its gradient.

Torch twin of gaussianprediction_tpu/ops/instance_stream.py
(build_instances_fwd, build_instances_bwd, the build_instances custom VJP,
_capped_rect, probe_slot_need). The forward:

1. every Gaussian's tile rect is capped to <= max_tiles tiles (a centred
   sub-rect), and every Gaussian owns >= 1 slot: empty ones get one
   singleton slot that is emitted invalid and sorts past every segment;
2. slot offsets are the exclusive cumsum of the per-Gaussian slot counts;
3. the stack kernel builds the [16, N] permat in original order, and the
   expand kernel expands it to one column per slot with the rect walk's
   tile key (ops/expand.py);
4. per-tile counts come from the separable rects, counts = Rᵀ @ C over
   the 0/1 row/column tile-interval indicators, as the JAX package counts
   them (so once slots drop they over-count exactly as it does);
5. one stable sort by the packed int64 key (tile << 32 | orderable bits
   of the depth) orders the slots by (tile, depth) with ties in slot
   order. The key's low half is the sign-flipped bit pattern of the
   depth, canonicalized as lax.sort canonicalizes its float keys (-0.0
   equal to +0.0, NaNs equal and last), so the order inside segments is
   the JAX package's bit for bit;
6. the interleave kernel assembles the sorted [16, P] instance SoA.

Capacity policy (the JAX package's): slots >= capacity are invalid;
n_dropped counts rect-capping losses plus slots past capacity. The buffer
lengths round up as the JAX package's do (ALIGN, then ILV_BLK), so the
segment bounds, clamped to the buffer, match its values exactly.

The backward (build_instances_bwd) reduces the [16, P] instance cotangent
to per-Gaussian gradients [N, 10]: one stable sort of the cotangent
columns by gid, then per-Gaussian sums as differences of inclusive
cumsums at the run boundaries, which come from the KEPT per-Gaussian
counts (slots past capacity dropped), not the raw ones. GPT_BWD_REDUCE
picks how the cumsums run, as in the JAX package: "serial" (default, the
per-channel cumsums of the [10, P] rows), "batched" (the interleave
kernel, then the scan kernel's cumsum_rows of the [16, P] matrix;
GPT_BWD_BATCHED_CUMSUM=1 also selects it) or "pallas" (the scan kernel's
cumsum_channels, the stack fused with the scan; ops/scan.py). Every step is
a sort, gather or scan: no atomics, so the result is deterministic.
"""
from __future__ import annotations

from typing import NamedTuple

import os

import torch

from gaussianprediction_tpu_torch.ops import expand, scan
from gaussianprediction_tpu_torch.ops.projection import TILE, f32_to_i32

C_GID_ROW = 10     # gid row of the packed instance SoA
ALIGN = 8192       # slot-buffer rounding of the JAX expand kernels
ILV_BLK = 32768    # stream rounding of the JAX interleave kernel
Z_PAD = 3e38       # depth of the rounding pad slots


class InstanceStream(NamedTuple):
    inst: torch.Tensor        # [16, P] packed sorted instance SoA
    tile_start: torch.Tensor  # [T] int32
    tile_end: torch.Tensor    # [T] int32
    n_dropped: torch.Tensor   # [] int32
    n_total: torch.Tensor     # [] int32 pre-drop slot count


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _capped_rect(tmin, tmax, center_px, max_tiles: int):
    """Cap a tile rect to <= max_tiles tiles while staying a rect, centred
    on the projected mean's tile. Uncapped rects come back unchanged."""
    rw = torch.clamp(tmax[:, 0] - tmin[:, 0], min=0)
    rh = torch.clamp(tmax[:, 1] - tmin[:, 1], min=0)
    rw_c = torch.clamp(rw, max=max_tiles)
    rh_c = torch.minimum(
        rh, torch.clamp(max_tiles // torch.clamp(rw_c, min=1), min=1))
    rh_c = torch.where(rw > 0, rh_c, torch.zeros_like(rh_c))
    ctx = f32_to_i32(center_px[:, 0] / TILE)
    cty = f32_to_i32(center_px[:, 1] / TILE)
    x0 = torch.minimum(torch.maximum(ctx - rw_c // 2, tmin[:, 0]),
                       tmax[:, 0] - rw_c)
    y0 = torch.minimum(torch.maximum(cty - rh_c // 2, tmin[:, 1]),
                       tmax[:, 1] - rh_c)
    return x0, y0, rw_c, rh_c


def probe_slot_need(xyz, scaling, rotation, opacity, cam, width: int,
                    height: int, alive=None, max_tiles: int = 1024):
    """Projection-only slot count for one camera: the slots
    build_instances_fwd would emit (capped exact-support rects plus the
    >= 1 singleton every Gaussian owns). scaling/opacity activated;
    rotation may be unnormalized."""
    from gaussianprediction_tpu_torch.ops import projection as PJ

    rot = rotation / torch.clamp(
        torch.linalg.norm(rotation, dim=-1, keepdim=True), min=1e-12)
    proj = PJ.project_from_params(xyz, scaling, rot, cam, width, height,
                                  alive=alive, opacity=opacity)
    _, _, rw, rh = _capped_rect(proj.tiles_min, proj.tiles_max, proj.mean2d,
                                max_tiles)
    zero = torch.zeros_like(rw)
    rw = torch.where(proj.visible, rw, zero)
    rh = torch.where(proj.visible, rh, zero)
    return torch.clamp(rw * rh, min=1).sum()


def orderable_bits(z):
    """f32 -> int64 in [0, 2^32) that orders as lax.sort orders the floats:
    -0.0 and +0.0 compare equal and every NaN equal and last (JAX
    canonicalizes float sort keys so), the rest by value."""
    z = torch.where(z == 0.0, torch.zeros_like(z), z)
    z = torch.where(torch.isnan(z), torch.full_like(z, float("nan")), z)
    b = z.contiguous().view(torch.int32)
    u = torch.where(b < 0, ~b, b | torch.iinfo(torch.int32).min)
    return u.to(torch.int64) & 0xFFFFFFFF


def build_instances_fwd(feat, tiles_min, tiles_max, visible, grid_x: int,
                        grid_y: int, capacity: int, max_tiles: int = 1024,
                        with_kept: bool = False):
    """feat: [N, 10] (mx, my, ca, cb, cc, op, r, g, b, z); channel 9, z, is
    the depth that orders instances inside a tile. Returns the
    InstanceStream, and with with_kept=True also the [N] int32 counts of
    each Gaussian's slots that stayed under capacity (the backward's run
    lengths)."""
    N = feat.shape[0]
    dev = feat.device
    num_tiles = grid_x * grid_y
    i32 = torch.int32

    x0c, y0c, rw0, rh0 = _capped_rect(tiles_min, tiles_max, feat[:, 0:2],
                                      max_tiles)
    zero = torch.zeros_like(rw0)
    rw = torch.where(visible, rw0, zero)
    rh = torch.where(visible, rh0, zero)
    gidx = torch.arange(N, dtype=i32, device=dev)

    count = rw * rh
    count1 = torch.clamp(count, min=1)
    offsets = (torch.cumsum(count1, 0) - count1).to(i32)
    total1 = (offsets[-1] + count1[-1]).to(i32)
    total_real = count.sum()

    cap_buf = _round_up(capacity, ALIGN)
    featT = feat.T.contiguous()                      # [10, N] rows
    permat = expand.stack_rows(
        [featT[c] for c in range(10)]
        + [offsets.to(torch.float32), x0c.to(torch.float32),
           y0c.to(torch.float32), rw.to(torch.float32),
           gidx.to(torch.float32)],
        nch=16,
    )                                                # [16, N]
    total = torch.clamp(total1, max=capacity).reshape(1)
    emitted = expand.expand_emit(permat, offsets, total, cap_buf, grid_x,
                                 num_tiles)          # [12, cap_buf]

    # per-tile counts from the separable rects (exact in f32 below 2^24)
    tyv = torch.arange(grid_y, dtype=i32, device=dev)[None, :]
    txv = torch.arange(grid_x, dtype=i32, device=dev)[None, :]
    live = ((rw > 0) & (rh > 0))[:, None]
    r_ind = ((y0c[:, None] <= tyv) & (tyv < (y0c + rh)[:, None])
             & live).to(torch.float32)               # [N, gy]
    c_ind = ((x0c[:, None] <= txv)
             & (txv < (x0c + rw)[:, None])).to(torch.float32)  # [N, gx]
    counts_t = (r_ind.T @ c_ind).to(i32).reshape(-1)  # [T]

    # rounding pad (sentinel key, z = 3e38, gid -1), then ONE stable sort
    Pp = _round_up(cap_buf, ILV_BLK)
    rows = emitted[:11]
    key = emitted[11].to(torch.int64)
    if Pp > cap_buf:
        pad = torch.zeros((11, Pp - cap_buf), dtype=torch.float32,
                          device=dev)
        pad[9] = Z_PAD
        pad[10] = -1.0
        rows = torch.cat([rows, pad], dim=1)
        key = torch.cat([key, torch.full((Pp - cap_buf,), num_tiles,
                                         dtype=torch.int64, device=dev)])
    key64 = (key << 32) | orderable_bits(rows[9])
    perm = torch.sort(key64, stable=True).indices
    srt = rows.index_select(1, perm)                 # [11, Pp]
    inst = expand.interleave_rows([srt[c] for c in range(11)])

    pstart = torch.cumsum(counts_t, 0) - counts_t
    tile_start = torch.clamp(pstart, max=Pp).to(i32)
    tile_end = torch.clamp(pstart + counts_t, max=Pp).to(i32)

    area_full = torch.where(
        visible,
        torch.clamp(tiles_max[:, 0] - tiles_min[:, 0], min=0)
        * torch.clamp(tiles_max[:, 1] - tiles_min[:, 1], min=0),
        zero,
    )
    area_drop = area_full.sum() - total_real
    n_dropped = (area_drop + torch.clamp(total1 - capacity, min=0)).to(i32)
    stream = InstanceStream(inst, tile_start, tile_end, n_dropped,
                            (total1 + area_drop).to(i32))
    if not with_kept:
        return stream
    # empty Gaussians' singleton slots carry gid -1: their kept count is 0
    kept = torch.where(
        count > 0,
        torch.clamp(offsets + count, max=capacity)
        - torch.clamp(offsets, max=capacity),
        zero,
    ).to(i32)
    return stream, kept


def reduce_mode() -> str:
    mode = os.environ.get("GPT_BWD_REDUCE") or (
        "batched" if os.environ.get("GPT_BWD_BATCHED_CUMSUM", "0") == "1"
        else "serial")
    if mode not in ("serial", "batched", "pallas"):
        raise ValueError(f"GPT_BWD_REDUCE={mode!r}: serial, batched or pallas")
    return mode


def build_instances_bwd(gid_row, kept, d_inst, mode=None):
    """Per-Gaussian gradients [N, 10] from the instance cotangent d_inst
    [16, P]. gid_row: the stream's sorted gid row (inst[10], -1 for
    invalid slots); kept: [N] int32 kept slot counts."""
    P = gid_row.shape[0]
    mode = mode or reduce_mode()
    gid = gid_row.to(torch.int32)
    order = torch.sort(gid, stable=True).indices
    b = d_inst[:10].index_select(1, order)             # [10, P] by gid
    counts = kept.to(torch.int64)
    ends = (P - counts.sum()) + torch.cumsum(counts, 0)  # invalid slots first
    starts = ends - counts
    if mode == "serial":
        # the ten per-channel cumsums as ONE row-wise cumsum of [10, P]: a
        # 1-d torch.cumsum on the card runs a decoupled look-back scan whose
        # f32 sums differ from run to run; the row-wise scan does not
        cs = torch.cat([b.new_zeros((10, 1)), torch.cumsum(b, dim=1)], dim=1)
        return (cs[:, ends] - cs[:, starts]).T
    if mode == "pallas":
        cs = scan.cumsum_channels([b[c] for c in range(10)])
    else:
        mat = expand.interleave_rows(
            [b[c] for c in range(10)]
            + [gid.index_select(0, order).to(torch.float32)])
        cs = scan.cumsum_rows(mat)
    e1 = torch.clamp(ends - 1, min=0)
    s1 = torch.clamp(starts - 1, min=0)
    zero = b.new_zeros(())
    cols = []
    for c in range(10):
        lo = torch.where(starts > 0, cs[c][s1], zero)
        cols.append(torch.where(counts > 0, cs[c][e1] - lo, zero))
    return torch.stack(cols, dim=1)


class _BuildInstances(torch.autograd.Function):
    """build_instances_fwd with its gradient w.r.t. feat (the JAX
    build_instances custom VJP); the rects and visibility carry none."""

    @staticmethod
    def forward(ctx, feat, tiles_min, tiles_max, visible, grid_x, grid_y,
                capacity, max_tiles):
        stream, kept = build_instances_fwd(
            feat.detach(), tiles_min, tiles_max, visible, grid_x, grid_y,
            capacity, max_tiles, with_kept=True)
        ctx.save_for_backward(stream.inst, kept)
        ctx.mark_non_differentiable(stream.tile_start, stream.tile_end,
                                    stream.n_dropped, stream.n_total)
        return tuple(stream)

    @staticmethod
    def backward(ctx, d_inst, *_):
        inst, kept = ctx.saved_tensors
        dfeat = build_instances_bwd(inst[C_GID_ROW], kept, d_inst)
        return dfeat, None, None, None, None, None, None, None


def build_instances(feat, tiles_min, tiles_max, visible, grid_x: int,
                    grid_y: int, capacity: int, max_tiles: int = 1024):
    """Differentiable build_instances_fwd: gradients flow to feat only."""
    return InstanceStream(*_BuildInstances.apply(
        feat, tiles_min, tiles_max, visible, grid_x, grid_y, capacity,
        max_tiles))
