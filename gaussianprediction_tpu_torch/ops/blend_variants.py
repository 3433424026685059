"""The tile blend under three other launch geometries: a flat work list
of (tile, 256-instance block) items (GPT_BLEND_FLAT=1), one program per
smt consecutive tiles walked one after another (GPT_BLEND_SMT=smt) and
one program per tpb consecutive tiles streaming their union window
(GPT_BLEND_MT=1), with their CUDA kernels' wrappers and plain versions.

Torch twin of the FLAT, SMT and MT branches of
gaussianprediction_tpu/ops/rasterize_pallas.py (_build_worklist,
_fwd_kernel_flat, _bwd_kernel_flat, _fwd_kernel_smt, _bwd_kernel_smt,
_fwd_kernel_mt, _bwd_kernel_mt). Each
pixel walks its tile's segment in order whatever the geometry, so both
give ops/rasterize_kernels.py's classic outputs bit for bit: the plain
versions are that module's blend_fwd_walk / blend_bwd_walk under another
schedule, and the kernels share the classic kernels' per-pixel walks
(kernels/csrc/common.cuh). The TPU's knobs of these paths
(GPT_KCHUNK_X_FLAT, GPT_KCHUNK_X_MT, GPT_FLAT_NOSKIP) schedule the TPU and
change no output; the port's block is 256 instances, the JAX default.
"""
from __future__ import annotations

from typing import Optional

import torch

from gaussianprediction_tpu_torch.kernels import launch_counts
from gaussianprediction_tpu_torch.ops import rasterize_kernels as rk

PIX = rk.PIX
RANGES_PER_SM = 4   # flat kernels: work-list ranges (blocks) per SM


def build_worklist(tile_start, tile_end, kchunk: int, nblocks: int):
    """The flat work list, equal to the JAX _build_worklist's bit for bit.

    Item i covers instance block woff[i] (units of kchunk) of tile wt[i];
    items are tile-major, blocks ascending, and a tile with an empty
    segment has none. Returns (wt, woff, ft, nwork), int32, sized to the
    static bound NW = nblocks + T: ft[t] is tile t's first item, nwork [1]
    the number of real items; padding items alias the last real one."""
    T = tile_start.shape[0]
    dev = tile_start.device
    i32 = torch.int32
    NW = nblocks + T
    seg = tile_end - tile_start
    base = torch.div(tile_start, kchunk, rounding_mode="floor")
    nch = torch.where(
        seg > 0,
        torch.div(tile_end - base * kchunk + kchunk - 1, kchunk,
                  rounding_mode="floor"),
        torch.zeros_like(seg)).to(i32)
    cum = torch.cat([torch.zeros((1,), dtype=i32, device=dev),
                     torch.cumsum(nch, 0, dtype=i32)])        # [T + 1]
    nwork = cum[T]
    ii = torch.arange(NW, dtype=i32, device=dev)
    wt0 = torch.searchsorted(cum[1:].contiguous(), ii, right=True,
                             out_int32=True).clamp(0, T - 1)
    woff0 = (base[wt0] + (ii - cum[wt0])).clamp(0, nblocks - 1).to(i32)
    # a [1] index: a 0-d one would be read on the host (a device sync)
    last = (nwork - 1).clamp(min=0).reshape(1)
    pad = ii >= nwork
    wt = torch.where(pad, wt0[last], wt0)
    woff = torch.where(pad, woff0[last], woff0)
    return wt, woff, cum[:T], nwork.reshape(1)


def flat_ranges(ft, nwork, num_ranges: int):
    """Cut the work list into num_ranges contiguous ranges of about
    ceil(nwork / num_ranges) items, cut only where a tile's items begin:
    range r is tiles [cut[r], cut[r + 1]) (cut [num_ranges + 1] int32;
    an empty tile goes with the range of the next tile that has items,
    trailing ones with the last range)."""
    T = ft.shape[0]
    per = torch.div(nwork + num_ranges - 1, num_ranges,
                    rounding_mode="floor")
    targets = (torch.arange(num_ranges + 1, dtype=torch.int32,
                            device=ft.device) * per).to(torch.int32)
    cut = torch.searchsorted(ft, targets, out_int32=True)
    cut[-1] = T
    return cut


def worklist(inst, tile_start, tile_end):
    """build_worklist of the blend inputs (256-instance blocks)."""
    nblocks = max(-(-inst.shape[1] // PIX), 1)
    return build_worklist(tile_start, tile_end, PIX, nblocks)


def flat_schedule(inst, tile_start, tile_end):
    """The flat walk (a schedule of rk.blend_fwd_walk): item k of every
    tile at once, the 256 lanes of each item's block in order; each tile's
    state carries from item to item."""
    start = tile_start.to(torch.int64)
    end = tile_end.to(torch.int64)
    T = start.shape[0]
    _, woff, ft, nwork = worklist(inst, tile_start, tile_end)
    first = ft.to(torch.int64)
    nitems = torch.cat([first[1:], nwork.to(torch.int64)]) - first
    woff = woff.to(torch.int64)
    K = int(nitems.max()) if T else 0
    for k in range(K):
        has = k < nitems
        blk = woff[(first + k).clamp(max=woff.shape[0] - 1)] * PIX
        lo = int(torch.where(has, (start - blk).clamp(min=0), PIX).min())
        hi = int(torch.where(has, (end - blk).clamp(max=PIX), 0).max())
        for lane in range(lo, hi):
            idx = blk + lane
            pending = has & (idx < end)
            yield idx, pending & (idx >= start), pending


def smt_schedule(tile_start, tile_end, smt: int):
    """The SMT walk (a schedule of rk.blend_fwd_walk): program p owns tiles
    [p * smt, (p + 1) * smt) and walks their segments one after another,
    each tile from its own fresh state; all programs at once. The last
    program may own fewer than smt tiles."""
    start = tile_start.to(torch.int64)
    end = tile_end.to(torch.int64)
    T = start.shape[0]
    if T == 0:
        return
    seg = (end - start).clamp(min=0)
    nprog = -(-T // smt)
    segp = torch.nn.functional.pad(seg, (0, nprog * smt - T)).view(nprog,
                                                                    smt)
    # where each tile's walk begins in its program's sequence
    first = (torch.cumsum(segp, dim=1) - segp).reshape(-1)[:T]
    L = int(segp.sum(dim=1).max())
    for k in range(L):
        r = k - first
        pending = (r < seg) & (seg > 0)
        yield start + r, pending & (r >= 0), pending


def mt_schedule(tile_start, tile_end, tpb: int):
    """The multi-tile walk (a schedule of rk.blend_fwd_walk): program p
    owns tiles [p * tpb, (p + 1) * tpb) and walks their union window in
    order, each instance applied to the tile whose segment holds it; all
    programs at once."""
    start = tile_start.to(torch.int64)
    end = tile_end.to(torch.int64)
    T = start.shape[0]
    if T == 0:
        return
    nprog = -(-T // tpb)
    pad = nprog * tpb - T
    nonempty = end > start
    far = int(end.max()) + 1
    ws = torch.nn.functional.pad(torch.where(nonempty, start, far), (0, pad),
                                 value=far).view(nprog, tpb).amin(dim=1)
    we = torch.nn.functional.pad(torch.where(nonempty, end, 0), (0, pad),
                                 value=0).view(nprog, tpb).amax(dim=1)
    W = int((we - ws).clamp(min=0).max())
    ws = ws.repeat_interleave(tpb)[:T]
    for q in range(W):
        idx = ws + q
        pending = nonempty & (idx < end)
        yield idx, pending & (idx >= start), pending


# --------------------------------------------------------------- flat


def rasterize_binned_flat_plain(inst, tile_start, tile_end, grid_x: int,
                                grid_y: int, with_tidx: bool = True,
                                aux: Optional[dict] = None):
    """Plain version of the flat forward: rk.blend_fwd_walk over
    flat_schedule; aux as rk.rasterize_binned_plain's."""
    return rk.blend_fwd_walk(inst, grid_x, grid_y, with_tidx,
                             flat_schedule(inst, tile_start, tile_end), aux)


def rasterize_binned_bwd_flat_plain(inst, tile_start, tile_end, grid_x: int,
                                    grid_y: int, dpix,
                                    aux: Optional[dict] = None,
                                    sums: str = "torch"):
    """Plain version of the flat backward: rk.blend_bwd_walk over
    flat_schedule (sums as rk.blend_bwd_walk's)."""
    return rk.blend_bwd_walk(
        inst, tile_start, tile_end, grid_x, grid_y, dpix,
        flat_schedule(inst, tile_start, tile_end), aux, sums)


def num_ranges(device, num_tiles: int) -> int:
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(num_tiles, RANGES_PER_SM * sms))


def rasterize_binned_flat(inst, tile_start, tile_end, grid_x: int,
                          grid_y: int, with_tidx: bool = True):
    """rk.rasterize_binned over the flat work list (kernel #14's twin,
    kernels/csrc/blend_fwd_flat.cu); the same bits."""
    rk.check_blend_args(inst, tile_start, tile_end, grid_x, grid_y)
    if not rk.on_card(inst, tile_start, tile_end):
        return rasterize_binned_flat_plain(inst, tile_start, tile_end,
                                           grid_x, grid_y, with_tidx)
    from gaussianprediction_tpu_torch.kernels import build

    T = grid_x * grid_y
    _, woff, ft, nwork = worklist(inst, tile_start, tile_end)
    R = num_ranges(inst.device, T)
    cut = flat_ranges(ft, nwork, R)
    out = torch.empty((T, PIX, 8), dtype=torch.float32, device=inst.device)
    build.launch("gpt_blend_fwd_flat", inst.data_ptr(), inst.shape[1],
                 tile_start.data_ptr(), tile_end.data_ptr(), T, grid_x,
                 woff.data_ptr(), ft.data_ptr(), nwork.data_ptr(),
                 cut.data_ptr(), R, int(with_tidx), out.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
    launch_counts["blend_fwd_flat"] += 1
    return out


def rasterize_binned_bwd_flat(inst, tile_start, tile_end, grid_x: int,
                              grid_y: int, dpix):
    """rk.rasterize_binned_bwd over the flat work list (kernel #15's twin,
    kernels/csrc/blend_bwd_flat.cu); the same bits."""
    rk.check_blend_args(inst, tile_start, tile_end, grid_x, grid_y)
    T = grid_x * grid_y
    rk.check_dpix(dpix, T)
    if not rk.on_card(inst, tile_start, tile_end, dpix):
        return rasterize_binned_bwd_flat_plain(inst, tile_start, tile_end,
                                               grid_x, grid_y, dpix)
    from gaussianprediction_tpu_torch.kernels import build

    _, woff, ft, nwork = worklist(inst, tile_start, tile_end)
    R = num_ranges(inst.device, T)
    cut = flat_ranges(ft, nwork, R)
    dinst = torch.zeros_like(inst)
    build.launch("gpt_blend_bwd_flat", inst.data_ptr(), inst.shape[1],
                 tile_start.data_ptr(), tile_end.data_ptr(), T, grid_x,
                 woff.data_ptr(), ft.data_ptr(), nwork.data_ptr(),
                 cut.data_ptr(), R, dpix.data_ptr(), dinst.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
    launch_counts["blend_bwd_flat"] += 1
    return dinst


def _check_tpb(tpb: int) -> None:
    if not isinstance(tpb, int) or tpb < 1:
        raise ValueError(f"tiles per program must be an int >= 1, not "
                         f"{tpb!r}")


# ---------------------------------------------------- sequential tiles


def rasterize_binned_smt_plain(inst, tile_start, tile_end, grid_x: int,
                               grid_y: int, smt: int, with_tidx: bool = True,
                               aux: Optional[dict] = None):
    """Plain version of the SMT forward: rk.blend_fwd_walk over
    smt_schedule; aux as rk.rasterize_binned_plain's."""
    _check_tpb(smt)
    return rk.blend_fwd_walk(inst, grid_x, grid_y, with_tidx,
                             smt_schedule(tile_start, tile_end, smt), aux)


def rasterize_binned_bwd_smt_plain(inst, tile_start, tile_end, grid_x: int,
                                   grid_y: int, smt: int, dpix,
                                   aux: Optional[dict] = None,
                                   sums: str = "torch"):
    """Plain version of the SMT backward: rk.blend_bwd_walk over
    smt_schedule (sums as rk.blend_bwd_walk's)."""
    _check_tpb(smt)
    return rk.blend_bwd_walk(inst, tile_start, tile_end, grid_x, grid_y,
                             dpix, smt_schedule(tile_start, tile_end, smt),
                             aux, sums)


def rasterize_binned_smt(inst, tile_start, tile_end, grid_x: int,
                         grid_y: int, smt: int, with_tidx: bool = True):
    """rk.rasterize_binned with one program per smt tiles walked in turn
    (kernel #12's twin, kernels/csrc/blend_fwd_smt.cu); the same bits."""
    rk.check_blend_args(inst, tile_start, tile_end, grid_x, grid_y)
    _check_tpb(smt)
    if not rk.on_card(inst, tile_start, tile_end):
        return rasterize_binned_smt_plain(inst, tile_start, tile_end,
                                          grid_x, grid_y, smt, with_tidx)
    from gaussianprediction_tpu_torch.kernels import build

    T = grid_x * grid_y
    out = torch.empty((T, PIX, 8), dtype=torch.float32, device=inst.device)
    build.launch("gpt_blend_fwd_smt", inst.data_ptr(), inst.shape[1],
                 tile_start.data_ptr(), tile_end.data_ptr(), T, grid_x, smt,
                 int(with_tidx), out.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
    launch_counts["blend_fwd_smt"] += 1
    return out


def rasterize_binned_bwd_smt(inst, tile_start, tile_end, grid_x: int,
                             grid_y: int, smt: int, dpix):
    """rk.rasterize_binned_bwd with one program per smt tiles walked in
    turn (kernel #13's twin, kernels/csrc/blend_bwd_smt.cu); the same
    bits."""
    rk.check_blend_args(inst, tile_start, tile_end, grid_x, grid_y)
    _check_tpb(smt)
    T = grid_x * grid_y
    rk.check_dpix(dpix, T)
    if not rk.on_card(inst, tile_start, tile_end, dpix):
        return rasterize_binned_bwd_smt_plain(inst, tile_start, tile_end,
                                              grid_x, grid_y, smt, dpix)
    from gaussianprediction_tpu_torch.kernels import build

    dinst = torch.zeros_like(inst)
    build.launch("gpt_blend_bwd_smt", inst.data_ptr(), inst.shape[1],
                 tile_start.data_ptr(), tile_end.data_ptr(), T, grid_x, smt,
                 dpix.data_ptr(), dinst.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
    launch_counts["blend_bwd_smt"] += 1
    return dinst


# ----------------------------------------------------------- multi-tile


def rasterize_binned_mt_plain(inst, tile_start, tile_end, grid_x: int,
                              grid_y: int, tpb: int, with_tidx: bool = True,
                              aux: Optional[dict] = None):
    """Plain version of the multi-tile forward: rk.blend_fwd_walk over
    mt_schedule; aux as rk.rasterize_binned_plain's."""
    _check_tpb(tpb)
    return rk.blend_fwd_walk(inst, grid_x, grid_y, with_tidx,
                             mt_schedule(tile_start, tile_end, tpb), aux)


def rasterize_binned_bwd_mt_plain(inst, tile_start, tile_end, grid_x: int,
                                  grid_y: int, tpb: int, dpix,
                                  aux: Optional[dict] = None,
                                  sums: str = "torch"):
    """Plain version of the multi-tile backward: rk.blend_bwd_walk over
    mt_schedule (sums as rk.blend_bwd_walk's)."""
    _check_tpb(tpb)
    return rk.blend_bwd_walk(inst, tile_start, tile_end, grid_x, grid_y,
                             dpix, mt_schedule(tile_start, tile_end, tpb),
                             aux, sums)


def rasterize_binned_mt(inst, tile_start, tile_end, grid_x: int,
                        grid_y: int, tpb: int, with_tidx: bool = True):
    """rk.rasterize_binned with one program per tpb tiles (kernel #10's
    twin, kernels/csrc/blend_fwd_mt.cu); the same bits."""
    rk.check_blend_args(inst, tile_start, tile_end, grid_x, grid_y)
    _check_tpb(tpb)
    if not rk.on_card(inst, tile_start, tile_end):
        return rasterize_binned_mt_plain(inst, tile_start, tile_end, grid_x,
                                         grid_y, tpb, with_tidx)
    from gaussianprediction_tpu_torch.kernels import build

    T = grid_x * grid_y
    out = torch.empty((T, PIX, 8), dtype=torch.float32, device=inst.device)
    build.launch("gpt_blend_fwd_mt", inst.data_ptr(), inst.shape[1],
                 tile_start.data_ptr(), tile_end.data_ptr(), T, grid_x, tpb,
                 int(with_tidx), out.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
    launch_counts["blend_fwd_mt"] += 1
    return out


def rasterize_binned_bwd_mt(inst, tile_start, tile_end, grid_x: int,
                            grid_y: int, tpb: int, dpix):
    """rk.rasterize_binned_bwd with one program per tpb tiles (kernel #11's
    twin, kernels/csrc/blend_bwd_mt.cu); the same bits."""
    rk.check_blend_args(inst, tile_start, tile_end, grid_x, grid_y)
    _check_tpb(tpb)
    T = grid_x * grid_y
    rk.check_dpix(dpix, T)
    if not rk.on_card(inst, tile_start, tile_end, dpix):
        return rasterize_binned_bwd_mt_plain(inst, tile_start, tile_end,
                                             grid_x, grid_y, tpb, dpix)
    from gaussianprediction_tpu_torch.kernels import build

    dinst = torch.zeros_like(inst)
    build.launch("gpt_blend_bwd_mt", inst.data_ptr(), inst.shape[1],
                 tile_start.data_ptr(), tile_end.data_ptr(), T, grid_x, tpb,
                 dpix.data_ptr(), dinst.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
    launch_counts["blend_bwd_mt"] += 1
    return dinst
