"""Tile blend, forward and backward: the CUDA kernels' wrappers, their
plain versions and the autograd Function that joins them.

Torch twin of gaussianprediction_tpu/ops/rasterize_pallas.py (its
constants, rasterize_binned with its custom VJP, and the classic _fwd_kernel
and _bwd_kernel branches). The blend follows the reference CUDA
rasterizer's semantics, as the oracle ops/rasterize_reference.py does: per
pixel, in segment order, alpha = min(0.99, op * exp(power)), skipped when
power > 0 or alpha < 1/255; T *= 1 - alpha; the pixel latches done (and the
instance does not contribute) once T would drop below 1e-4; tidx is the
gid of the first strict maximum of the blend weight.

The backward recomputes the forward per pixel and, with
Q = sum_c d_c * acc_c + dT * T_final, takes dalpha = T * v - (Q - S) /
(1 - alpha) for v = c . d_rgb + z * d_z and S the running inclusive sum of
w * v; the gradient flows through the unclamped alpha (dpower = op * G *
dalpha), as the CUDA backward does. Rows 10-15 of the instance gradient
are zero: w_max, gid and the pad rows get none.

The launch geometry follows the JAX package's environment variables, read
at call time (blend_variant): GPT_BLEND_FLAT=1 blends over a flat work list
of (tile, 256-instance block) items, GPT_BLEND_SMT=n (n > 1) one program
per n tiles walked one after another, GPT_BLEND_MT=1 one program per
GPT_BLEND_TPB tiles over their union window (ops/blend_variants.py); each
gives the classic outputs bit for bit.
"""
from __future__ import annotations

import os
from typing import NamedTuple, Optional

import torch

from gaussianprediction_tpu_torch.kernels import launch_counts

PIX = 256          # pixels per 16x16 tile
NCH = 16           # packed f32 channels per instance
T_EPS = 1e-4
ALPHA_CLAMP = 0.99
ALPHA_MIN = 1.0 / 255.0

# packed instance channel indices (rows of the [NCH, P] SoA)
C_MX, C_MY, C_CA, C_CB, C_CC, C_OP, C_R, C_G, C_B, C_Z, C_GID, C_VALID = \
    range(12)
# forward output channels (per tile, [PIX, 8])
O_R, O_G, O_B, O_Z, O_T, O_WMAX, O_GID, O_PAD = range(8)
# backward pixel-grad input channels (per tile, [PIX, 8]): d(r,g,b,z), Q
D_R, D_G, D_B, D_Z, D_Q = range(5)


class BlendVariant(NamedTuple):
    kind: str                  # "classic", "flat", "smt" or "mt"
    tpb: Optional[int] = None  # tiles per program ("smt", "mt")


CLASSIC = BlendVariant("classic")


def _env_int(name: str, default: str) -> int:
    raw = os.environ.get(name, default)
    try:
        return int(raw)
    except ValueError:
        raise ValueError(f"{name}={raw!r} is not an integer") from None


def blend_variant() -> BlendVariant:
    """The blend's launch geometry from the environment, read at each call
    as the JAX package reads it at trace time, with its precedence (FLAT
    over SMT over MT over classic): GPT_BLEND_FLAT=1 -> flat;
    GPT_BLEND_SMT=n -> smt with n tiles per program where
    max(1, n) > 1 (ValueError unless an integer; <= 1 is off);
    GPT_BLEND_MT=1 -> mt with GPT_BLEND_TPB tiles per program (default 4;
    ValueError unless an integer >= 1); else classic."""
    if os.environ.get("GPT_BLEND_FLAT", "0") == "1":
        return BlendVariant("flat")
    smt = max(1, _env_int("GPT_BLEND_SMT", "1"))
    if smt > 1:
        return BlendVariant("smt", smt)
    if os.environ.get("GPT_BLEND_MT", "0") == "1":
        tpb = _env_int("GPT_BLEND_TPB", "4")
        if tpb < 1:
            raise ValueError(f"GPT_BLEND_TPB={tpb}: tiles per program must "
                             "be >= 1")
        return BlendVariant("mt", tpb)
    return CLASSIC


def on_card(*tensors) -> bool:
    """True when every tensor is on a CUDA device, False when none is;
    raises on a mix."""
    on = [x.is_cuda for x in tensors]
    if all(on):
        return True
    if any(on):
        raise ValueError("tensors must all be on one device")
    return False


def check_blend_args(inst, tile_start, tile_end, grid_x, grid_y):
    if inst.dtype != torch.float32 or inst.dim() != 2 or \
            inst.shape[0] != NCH or not inst.is_contiguous():
        raise ValueError("inst must be a contiguous [16, P] float32")
    T = grid_x * grid_y
    for a in (tile_start, tile_end):
        if a.dtype != torch.int32 or a.shape != (T,) or \
                not a.is_contiguous():
            raise ValueError(f"tile bounds must be contiguous [{T}] int32")


def _pixel_coords(grid_x, grid_y, device):
    T = grid_x * grid_y
    tile = torch.arange(T, device=device)
    lin = torch.arange(PIX, device=device)
    px = ((tile % grid_x) * 16)[:, None] + (lin % 16)[None, :]
    py = ((tile // grid_x) * 16)[:, None] + (lin // 16)[None, :]
    return px.to(torch.float32), py.to(torch.float32)


# ------------------------------------------------- the forward warp cull
# The forward kernels give each warp an 8 x 4 patch of a tile's pixels,
# test each instance against the patch's rectangle of pixel centres and
# skip it for a warp where no pixel can pass the alpha test
# (kernels/csrc/common.cuh: fwd_tile_pixel, warp_keeps, fwd_walk). The
# outputs do not depend on it; the plain versions model it to count the
# pairs it keeps (aux "warp_pairs_kept"), and the tests hold the model to
# never culling a passing pair.
WARPS = PIX // 32


def _f32(x: float) -> float:
    return float(torch.tensor(x, dtype=torch.float32))


# the kernels' margins (common.cuh), as the f32 values they compare with
CULL_ALPHA_MIN = _f32(ALPHA_MIN)
CULL_OP_MIN = _f32(CULL_ALPHA_MIN * _f32(1.001))
CULL_R2_ABS = _f32(1e-4)
CULL_REL2 = _f32(1.002001)        # (1 + 1e-3)^2
CULL_THIN = 64.0 * 2.0 ** -24
CULL_PX = _f32(1e-2)
CULL_DET_MIN = _f32(1e-30)
CULL_FINITE = _f32(1e38)


def fwd_thread_pixels(device=None):
    """[256] int64: the tile pixel (row * 16 + column) of each forward
    thread; threads 32 w .. 32 w + 31 form warp w, columns 8 (w % 2) .. +7
    and rows 4 (w // 2) .. +3 of the tile."""
    lin = torch.arange(PIX, device=device)
    w, lane = lin // 32, lin % 32
    return ((w // 2) * 4 + lane // 8) * 16 + (w % 2) * 8 + lane % 8


def warp_rects(grid_x: int, grid_y: int, device=None):
    """(x0, x1, y0, y1), each [T, 8] float32: the span of each forward
    warp's pixel centres in each tile."""
    pix = fwd_thread_pixels(device).view(WARPS, 32)
    col, row = pix % 16, pix // 16
    tile = torch.arange(grid_x * grid_y, device=device)
    tx = ((tile % grid_x) * 16)[:, None]
    ty = ((tile // grid_x) * 16)[:, None]
    return tuple((b + v).to(torch.float32) for b, v in (
        (tx, col.amin(1)), (tx, col.amax(1)), (ty, row.amin(1)),
        (ty, row.amax(1))))


def warp_keep(ch, x0, x1, y0, y1):
    """The kernels' cull test (common.cuh: warp_keeps), its operations in
    the same f32 order and det in double: whether some pixel centre of
    [x0, x1] x [y0, y1] may pass the alpha test against the instance with
    channels ch ([16, ...] float32, broadcasting against the rectangle's
    bounds). False only for an invalid instance or one whose support
    ellipse Q <= 2 ln(op / a_min), widened by the margins, has a bounding
    box that misses the rectangle; True wherever a channel read is not
    finite, op <= CULL_OP_MIN, det <= 1e-30 or the conic is too thin for
    the margins."""
    mx, my, ca, cb, cc, op = (ch[c] for c in range(6))
    det = (ca.double() * cc.double() - cb.double() * cb.double()).float()
    tr = ca + cc
    thin = CULL_THIN * tr * tr
    always = ~((mx + my + ca + cb + cc + op).abs() < CULL_FINITE) \
        | ~(op > CULL_OP_MIN) | ~(ca > 0.0) | ~(det > CULL_DET_MIN) \
        | ~(2.0 * thin < det)
    rr = (2.0 * torch.log(op / CULL_ALPHA_MIN) + CULL_R2_ABS) \
        * (CULL_REL2 + thin / det)
    dx = torch.clamp(torch.maximum(x0 - mx, mx - x1) - CULL_PX, min=0.0)
    dy = torch.clamp(torch.maximum(y0 - my, my - y1) - CULL_PX, min=0.0)
    inside = (dx * dx * det <= rr * cc) & (dy * dy * det <= rr * ca)
    return (ch[C_VALID] > 0.5) & (always | inside)


def fwd_warp_keep(inst, tile_start, tile_end, grid_x: int, grid_y: int):
    """The cull over every entry of the tiles' segments, in order:
    (tile, col, keep), tile and col [N] int64 (the entry's tile and
    instance column), keep [N, 8] bool (whether warp w of that tile keeps
    the instance, warp_keep)."""
    dev = inst.device
    start = tile_start.to(torch.int64)
    seg = (tile_end.to(torch.int64) - start).clamp(min=0)
    tile = torch.repeat_interleave(
        torch.arange(grid_x * grid_y, device=dev), seg)
    first = torch.cumsum(seg, 0) - seg
    col = start[tile] + torch.arange(tile.shape[0], device=dev) - first[tile]
    rects = (r[tile] for r in warp_rects(grid_x, grid_y, dev))
    return tile, col, warp_keep(inst[:, col][:, :, None], *rects)


def classic_schedule(start, end):
    """The classic walk: step r hands every tile its segment's instance of
    rank r. Each schedule yields, per step, (idx [T] int64: the instance
    each tile is handed; live [T]: idx lies in the tile's segment; pending
    [T]: the tile has instances at or after this step)."""
    seg = (end - start).clamp(min=0)
    L = int(seg.max()) if seg.numel() else 0
    for r in range(L):
        live = r < seg
        yield start + r, live, live


def blend_fwd_walk(inst, grid_x: int, grid_y: int, with_tidx: bool,
                   schedule, aux: Optional[dict] = None):
    """The plain forward blend over a schedule (classic_schedule or one of
    ops/blend_variants.py): at each step every tile blends the instance it
    is handed into its 256 pixels with the kernel's per-instance arithmetic
    in the same order, vectorised over tiles and pixels. Any schedule that
    hands each tile its segment in order gives the same bits. Stops once
    every pixel is done or past its segment (checked every 64 steps)."""
    dev = inst.device
    T = grid_x * grid_y
    P = inst.shape[1]
    px, py = _pixel_coords(grid_x, grid_y, dev)
    Tr = torch.ones((T, PIX), dtype=torch.float32, device=dev)
    done = torch.zeros((T, PIX), dtype=torch.bool, device=dev)
    acc = [torch.zeros((T, PIX), dtype=torch.float32, device=dev)
           for _ in range(4)]
    wmax = torch.zeros((T, PIX), dtype=torch.float32, device=dev)
    bgid = torch.full((T, PIX), -1.0, dtype=torch.float32, device=dev)
    w2 = torch.zeros_like(wmax)
    pairs = torch.zeros((), dtype=torch.int64, device=dev)
    flops = torch.zeros((), dtype=torch.int64, device=dev)
    insts = torch.zeros((), dtype=torch.int64, device=dev)
    wpairs = torch.zeros((), dtype=torch.int64, device=dev)
    wkept = torch.zeros((), dtype=torch.int64, device=dev)
    if aux is not None:
        rects = warp_rects(grid_x, grid_y, dev)
        thread_pix = fwd_thread_pixels(dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for k, (idx, live, pending) in enumerate(schedule):
        if k % 64 == 0 and k and bool((done | ~pending[:, None]).all()):
            break
        active = live[:, None] & ~done
        d = inst[:, idx.clamp(0, P - 1)][:, :, None]          # [16, T, 1]
        if aux is not None:
            warp_live = active[:, thread_pix].view(T, WARPS, 32).any(-1)
            wpairs += warp_live.sum()
            wkept += (warp_live & warp_keep(d, *rects)).sum()
        dx = px - d[C_MX]
        dy = py - d[C_MY]
        power = -0.5 * (d[C_CA] * dx * dx + d[C_CC] * dy * dy) \
            - d[C_CB] * dx * dy
        alpha = torch.clamp(d[C_OP] * torch.exp(power), max=ALPHA_CLAMP)
        valid = active & (d[C_VALID] > 0.5) & (power <= 0.0) & \
            (alpha >= ALPHA_MIN)
        test_T = Tr * (1.0 - alpha)
        trigger = valid & (test_T < T_EPS)
        if aux is not None:
            live_pair = active & (d[C_VALID] > 0.5)
            pow_ok = live_pair & (power <= 0.0)
            pairs += active.sum()
            insts += active.any(dim=1).sum()
            flops += 11 * live_pair.sum() + 2 * pow_ok.sum() \
                + 2 * valid.sum() + 9 * (valid & ~trigger).sum()
        contrib = valid & ~trigger
        w = torch.where(contrib, alpha * Tr, zero)
        for c in range(4):
            acc[c] = torch.where(contrib, acc[c] + w * d[C_R + c], acc[c])
        Tr = torch.where(contrib, test_T, Tr)
        done = done | trigger
        if with_tidx:
            better = w > wmax
            if aux is not None:
                w2 = torch.where(better, wmax, torch.maximum(w2, w))
            wmax = torch.where(better, w, wmax)
            bgid = torch.where(better, d[C_GID], bgid)
    if aux is not None:
        aux["w2"] = w2
        aux["pairs"] = int(pairs)
        aux["flops"] = int(flops)
        aux["instances"] = int(insts)
        aux["warp_pairs"] = int(wpairs)
        aux["warp_pairs_kept"] = int(wkept)
    return torch.stack(acc + [Tr, wmax, bgid, torch.zeros_like(Tr)], dim=-1)


def rasterize_binned_plain(inst, tile_start, tile_end, grid_x: int,
                           grid_y: int, with_tidx: bool = True,
                           aux: Optional[dict] = None):
    """Plain PyTorch blend: blend_fwd_walk over the rank inside each tile's
    segment (classic_schedule).

    aux (a dict, optional) receives "w2", the runner-up blend weight of
    each pixel ([T, 256]; for tidx comparisons that skip near-ties), and
    the data-dependent work of the blend: "pairs", the (pixel, instance)
    evaluations up to each pixel's done latch; "flops", the f32
    arithmetic those evaluations need (11 for the conic of a valid
    instance, 2 more for exp and the opacity product where power <= 0, 2
    for 1 - alpha and the T product where alpha >= 1/255, 9 for the
    weight and the four sums where it contributes; compares and clamps not
    counted, exp counted as one); "instances", the segment instances read
    up to the rank at which every pixel of the tile is done;
    "warp_pairs", the (warp, instance) pairs up to each forward warp's
    last live pixel (fwd_thread_pixels), and
    "warp_pairs_kept", those the kernels' cull keeps (warp_keep)."""
    sched = classic_schedule(tile_start.to(torch.int64),
                             tile_end.to(torch.int64))
    return blend_fwd_walk(inst, grid_x, grid_y, with_tidx, sched, aux)


def rasterize_binned(inst, tile_start, tile_end, grid_x: int, grid_y: int,
                     with_tidx: bool = True,
                     variant: Optional[BlendVariant] = None):
    """Blend packed instances into per-tile buffers.

    inst: [16, P] float32 instance SoA; tile_start/tile_end: [T] int32
    segment bounds (unaligned, non-overlapping, ordered by tile). Returns
    [T, 256, 8] float32: r, g, b, depth, T_final, w_max, best gid, pad.
    with_tidx=False leaves w_max 0 and gid -1 (training never reads
    them). variant: the launch geometry (default blend_variant()); every
    variant gives the same bits."""
    check_blend_args(inst, tile_start, tile_end, grid_x, grid_y)
    variant = variant or blend_variant()
    if variant.kind != "classic":
        from gaussianprediction_tpu_torch.ops import blend_variants as bv

        if variant.kind == "flat":
            return bv.rasterize_binned_flat(inst, tile_start, tile_end,
                                            grid_x, grid_y, with_tidx)
        if variant.kind == "smt":
            return bv.rasterize_binned_smt(inst, tile_start, tile_end,
                                           grid_x, grid_y, variant.tpb,
                                           with_tidx)
        return bv.rasterize_binned_mt(inst, tile_start, tile_end, grid_x,
                                      grid_y, variant.tpb, with_tidx)
    T = grid_x * grid_y
    if not on_card(inst, tile_start, tile_end):
        return rasterize_binned_plain(inst, tile_start, tile_end, grid_x,
                                      grid_y, with_tidx)
    from gaussianprediction_tpu_torch.kernels import build

    out = torch.empty((T, PIX, 8), dtype=torch.float32, device=inst.device)
    build.launch("gpt_blend_fwd", inst.data_ptr(), inst.shape[1],
                 tile_start.data_ptr(), tile_end.data_ptr(), T, grid_x,
                 int(with_tidx), out.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
    launch_counts["blend_fwd"] += 1
    return out


# ------------------------------------------------------------- backward


def check_dpix(dpix, T):
    if dpix.dtype != torch.float32 or dpix.shape != (T, PIX, 8) or \
            not dpix.is_contiguous():
        raise ValueError(f"dpix must be a contiguous [{T}, {PIX}, 8] float32")


def pixel_grads(out, g):
    """Per-pixel backward inputs [T, 256, 8] from the forward output and its
    cotangent: d(r, g, b, z), then Q = sum_c d_c * acc_c + dT * T_final."""
    d_rgbz = g[..., O_R:O_R + 4]
    Q = (d_rgbz * out[..., O_R:O_R + 4]).sum(-1, keepdim=True) + \
        g[..., O_T:O_T + 1] * out[..., O_T:O_T + 1]
    return torch.cat([d_rgbz, Q, torch.zeros_like(d_rgbz[..., :3])],
                     dim=-1).contiguous()


SUB = 32   # instances per reduction sub-batch of the backward kernels


def _pixel_sums(x, sums: str):
    """[..., T, 256] -> [..., T]: each sum over a tile's pixels.

    sums="kernel": the backward kernels' order, so that the plain version
    can hold them bit for bit. Within each warp of 32 pixels, halves are
    added at offsets 16, 8, 4, 2, 1 (lanes l and l + o, the pairs of the
    kernels' warp reduce-scatter); then the eight warps' sums left to
    right. sums="torch" (the plain versions' default, the wrappers' CPU
    path): torch's own reduction. The CPU path trains in it because its
    trajectory is held to the JAX package's at tolerances measured in it:
    in the kernels' order the roundoff differs, and over 55 steps of the
    `test` preset one or two pixels cross a blend threshold at three
    steps."""
    if sums == "torch":
        return x.sum(dim=-1)
    if sums != "kernel":
        raise ValueError(f"sums must be 'kernel' or 'torch', not {sums!r}")
    x = x.unflatten(-1, (WARPS, 32))
    for o in (16, 8, 4, 2, 1):
        x = x[..., :o] + x[..., o:]
    x = x[..., 0]
    acc = x[..., 0]
    for w in range(1, WARPS):
        acc = acc + x[..., w]
    return acc


def blend_bwd_walk(inst, tile_start, tile_end, grid_x: int, grid_y: int,
                   dpix, schedule, aux: Optional[dict] = None,
                   sums: str = "torch"):
    """The plain backward blend over a schedule (as blend_fwd_walk): at each
    step every tile recomputes the forward for the instance it is handed,
    with the kernel's per-pixel arithmetic in the same order, and sums the
    ten per-pixel products over its 256 pixels in the order `sums` names
    (_pixel_sums: "kernel" gives the kernels' bits). A tile writes the
    columns of its segment up to the end of the sub-batch of 32 ranks in
    which its last pixel latched done, as the kernels do, so any schedule
    that hands each tile its segment in order writes the same columns with
    the same bits."""
    dev = inst.device
    T = grid_x * grid_y
    P = inst.shape[1]
    px, py = _pixel_coords(grid_x, grid_y, dev)
    start = tile_start.to(torch.int64)
    end = tile_end.to(torch.int64)
    d0, d1, d2, d3 = (dpix[..., c] for c in range(D_R, D_Z + 1))
    Q = dpix[..., D_Q]

    Tr = torch.ones((T, PIX), dtype=torch.float32, device=dev)
    done = torch.zeros((T, PIX), dtype=torch.bool, device=dev)
    S = torch.zeros((T, PIX), dtype=torch.float32, device=dev)
    stopped = torch.zeros((T,), dtype=torch.bool, device=dev)
    dinst = torch.zeros_like(inst)
    pairs = torch.zeros((), dtype=torch.int64, device=dev)
    flops = torch.zeros((), dtype=torch.int64, device=dev)
    insts = torch.zeros((), dtype=torch.int64, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for k, (idx, live, pending) in enumerate(schedule):
        if k % 64 == 0 and k and bool((stopped | ~pending).all()):
            break
        active = live[:, None] & ~done
        col = idx.clamp(0, P - 1)
        d = inst[:, col][:, :, None]                           # [16, T, 1]
        dx = px - d[C_MX]
        dy = py - d[C_MY]
        power = -0.5 * (d[C_CA] * dx * dx + d[C_CC] * dy * dy) \
            - d[C_CB] * dx * dy
        G = torch.exp(power)
        alpha = torch.clamp(d[C_OP] * G, max=ALPHA_CLAMP)
        valid = active & (d[C_VALID] > 0.5) & (power <= 0.0) & \
            (alpha >= ALPHA_MIN)
        test_T = Tr * (1.0 - alpha)
        trigger = valid & (test_T < T_EPS)
        contrib = valid & ~trigger
        if aux is not None:
            live_pair = active & (d[C_VALID] > 0.5)
            pairs += active.sum()
            insts += active.any(dim=1).sum()
            flops += 11 * live_pair.sum() \
                + 2 * (live_pair & (power <= 0.0)).sum() \
                + 2 * valid.sum() + 37 * contrib.sum()
        w = alpha * Tr
        v = d[C_R] * d0 + d[C_G] * d1 + d[C_B] * d2 + d[C_Z] * d3
        S = torch.where(contrib, S + w * v, S)
        dalpha = Tr * v - (Q - S) / (1.0 - alpha)
        dpower = d[C_OP] * G * dalpha
        gdx = dpower * dx
        gdy = dpower * dy
        terms = torch.stack([gdx, gdy, gdx * dx, gdx * dy, gdy * dy,
                             G * dalpha, d0 * w, d1 * w, d2 * w, d3 * w])
        sx, sy, sxx, sxy, syy, sop, sr, sg, sb, sz = _pixel_sums(
            torch.where(contrib, terms, zero), sums)
        ca, cb, cc = d[C_CA, :, 0], d[C_CB, :, 0], d[C_CC, :, 0]
        grads = torch.stack([ca * sx + cb * sy, cb * sx + cc * sy,
                             -0.5 * sxx, -sxy, -0.5 * syy, sop, sr, sg, sb,
                             sz])                              # [10, T]
        write = live & ~stopped
        dinst[:10, col[write]] = grads[:, write]
        Tr = torch.where(contrib, test_T, Tr)
        done = done | trigger
        edge = ((idx - start + 1) % SUB == 0) | (idx + 1 == end)
        stopped = stopped | (live & edge & done.all(dim=1))
    if aux is not None:
        aux["pairs"] = int(pairs)
        aux["flops"] = int(flops)
        aux["instances"] = int(insts)
    return dinst


def rasterize_binned_bwd_plain(inst, tile_start, tile_end, grid_x: int,
                               grid_y: int, dpix, aux: Optional[dict] = None,
                               sums: str = "torch"):
    """Plain PyTorch backward blend: blend_bwd_walk over the rank inside
    each tile's segment (classic_schedule), its pixel sums in the order
    `sums` names.

    aux (optional) receives the data-dependent work: "pairs", "instances"
    and "flops" as rasterize_binned_plain counts them, with 37 more f32
    operations for each contributing pair (w, v, S, dalpha, dpower, the
    ten products and their sums over the pixels)."""
    sched = classic_schedule(tile_start.to(torch.int64),
                             tile_end.to(torch.int64))
    return blend_bwd_walk(inst, tile_start, tile_end, grid_x, grid_y, dpix,
                          sched, aux, sums)


def rasterize_binned_bwd(inst, tile_start, tile_end, grid_x: int,
                         grid_y: int, dpix,
                         variant: Optional[BlendVariant] = None):
    """Instance gradients [16, P] (rows 0-9: d mx, my, ca, cb, cc, op, r,
    g, b, z; rows 10-15 zero) from the per-pixel inputs dpix [T, 256, 8]
    (pixel_grads). variant as rasterize_binned's."""
    check_blend_args(inst, tile_start, tile_end, grid_x, grid_y)
    T = grid_x * grid_y
    check_dpix(dpix, T)
    variant = variant or blend_variant()
    if variant.kind != "classic":
        from gaussianprediction_tpu_torch.ops import blend_variants as bv

        if variant.kind == "flat":
            return bv.rasterize_binned_bwd_flat(inst, tile_start, tile_end,
                                                grid_x, grid_y, dpix)
        if variant.kind == "smt":
            return bv.rasterize_binned_bwd_smt(inst, tile_start, tile_end,
                                               grid_x, grid_y, variant.tpb,
                                               dpix)
        return bv.rasterize_binned_bwd_mt(inst, tile_start, tile_end,
                                          grid_x, grid_y, variant.tpb, dpix)
    if not on_card(inst, tile_start, tile_end, dpix):
        return rasterize_binned_bwd_plain(inst, tile_start, tile_end, grid_x,
                                          grid_y, dpix)
    from gaussianprediction_tpu_torch.kernels import build

    dinst = torch.zeros_like(inst)
    build.launch("gpt_blend_bwd", inst.data_ptr(), inst.shape[1],
                 tile_start.data_ptr(), tile_end.data_ptr(), T, grid_x,
                 dpix.data_ptr(), dinst.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
    launch_counts["blend_bwd"] += 1
    return dinst


class RasterizeBinned(torch.autograd.Function):
    """rasterize_binned with its gradient w.r.t. the instance SoA (the
    twin of the JAX custom_vjp's _rasterize_fwd_rule/_rasterize_bwd_rule).
    Gradients of w_max and gid (output channels 5-6) are ignored. The
    forward's blend_variant() is kept for the backward."""

    @staticmethod
    def forward(ctx, inst, tile_start, tile_end, grid_x, grid_y,
                with_tidx=False):
        ctx.variant = blend_variant()
        out = rasterize_binned(inst, tile_start, tile_end, grid_x, grid_y,
                               with_tidx, variant=ctx.variant)
        ctx.save_for_backward(inst, tile_start, tile_end, out)
        ctx.grid = (grid_x, grid_y)
        return out

    @staticmethod
    def backward(ctx, g):
        inst, tile_start, tile_end, out = ctx.saved_tensors
        dpix = pixel_grads(out, g)
        dinst = rasterize_binned_bwd(inst, tile_start, tile_end, *ctx.grid,
                                     dpix, variant=ctx.variant)
        return dinst, None, None, None, None, None
