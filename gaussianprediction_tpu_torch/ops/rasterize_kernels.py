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

The env-gated variants (MT, SMT, FLAT) wait for a later slice.
"""
from __future__ import annotations

from typing import Optional

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


def _check(inst, tile_start, tile_end, grid_x, grid_y):
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


def rasterize_binned_plain(inst, tile_start, tile_end, grid_x: int,
                           grid_y: int, with_tidx: bool = True,
                           aux: Optional[dict] = None):
    """Plain PyTorch blend: a loop over the rank inside each tile's
    segment, vectorised over tiles and pixels, each step the kernel's
    per-instance arithmetic in the same order. Exits once every pixel is
    done or past its segment.

    aux (a dict, optional) receives "w2", the runner-up blend weight of
    each pixel ([T, 256]; for tidx comparisons that skip near-ties), and
    the data-dependent work of the blend: "pairs", the (pixel, instance)
    evaluations up to each pixel's done latch; "flops", the f32
    arithmetic those evaluations need (11 for the conic of a valid
    instance, 2 more for exp and the opacity product where power <= 0, 2
    for 1 - alpha and the T product where alpha >= 1/255, 9 for the
    weight and the four sums where it contributes; compares and clamps not
    counted, exp counted as one); "instances", the segment instances read
    up to the rank at which every pixel of the tile is done."""
    dev = inst.device
    T = grid_x * grid_y
    P = inst.shape[1]
    px, py = _pixel_coords(grid_x, grid_y, dev)
    start = tile_start.to(torch.int64)
    seg = (tile_end.to(torch.int64) - start).clamp(min=0)
    L = int(seg.max()) if T else 0

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
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for r in range(L):
        if r % 64 == 0 and r and bool((done | (r >= seg)[:, None]).all()):
            break
        active = (r < seg)[:, None] & ~done
        d = inst[:, (start + r).clamp(max=P - 1)][:, :, None]  # [16, T, 1]
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
            live = active & (d[C_VALID] > 0.5)
            pow_ok = live & (power <= 0.0)
            pairs += active.sum()
            insts += active.any(dim=1).sum()
            flops += 11 * live.sum() + 2 * pow_ok.sum() + 2 * valid.sum() \
                + 9 * (valid & ~trigger).sum()
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
    return torch.stack(acc + [Tr, wmax, bgid, torch.zeros_like(Tr)], dim=-1)


def rasterize_binned(inst, tile_start, tile_end, grid_x: int, grid_y: int,
                     with_tidx: bool = True):
    """Blend packed instances into per-tile buffers.

    inst: [16, P] float32 instance SoA; tile_start/tile_end: [T] int32
    segment bounds (unaligned, non-overlapping, ordered by tile). Returns
    [T, 256, 8] float32: r, g, b, depth, T_final, w_max, best gid, pad.
    with_tidx=False leaves w_max 0 and gid -1 (training never reads
    them)."""
    _check(inst, tile_start, tile_end, grid_x, grid_y)
    T = grid_x * grid_y
    if not (inst.is_cuda and tile_start.is_cuda and tile_end.is_cuda):
        if inst.is_cuda or tile_start.is_cuda or tile_end.is_cuda:
            raise ValueError("tensors must all be on one device")
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


def _check_dpix(dpix, T):
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


def rasterize_binned_bwd_plain(inst, tile_start, tile_end, grid_x: int,
                               grid_y: int, dpix, aux: Optional[dict] = None):
    """Plain PyTorch backward blend: the forward's loop over the rank inside
    each tile's segment, vectorised over tiles and pixels, with the
    kernel's per-pixel arithmetic in the same order and the ten per-pixel
    products of each instance summed over its tile's 256 pixels.

    aux (optional) receives the data-dependent work: "pairs", "instances"
    and "flops" as rasterize_binned_plain counts them, with 37 more f32
    operations for each contributing pair (w, v, S, dalpha, dpower, the
    ten products and their sums over the pixels)."""
    dev = inst.device
    T = grid_x * grid_y
    P = inst.shape[1]
    px, py = _pixel_coords(grid_x, grid_y, dev)
    start = tile_start.to(torch.int64)
    seg = (tile_end.to(torch.int64) - start).clamp(min=0)
    L = int(seg.max()) if T else 0
    d0, d1, d2, d3 = (dpix[..., c] for c in range(D_R, D_Z + 1))
    Q = dpix[..., D_Q]

    Tr = torch.ones((T, PIX), dtype=torch.float32, device=dev)
    done = torch.zeros((T, PIX), dtype=torch.bool, device=dev)
    S = torch.zeros((T, PIX), dtype=torch.float32, device=dev)
    dinst = torch.zeros_like(inst)
    pairs = torch.zeros((), dtype=torch.int64, device=dev)
    flops = torch.zeros((), dtype=torch.int64, device=dev)
    insts = torch.zeros((), dtype=torch.int64, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for r in range(L):
        if r % 64 == 0 and r and bool((done | (r >= seg)[:, None]).all()):
            break
        live_tile = r < seg
        active = live_tile[:, None] & ~done
        col = (start + r).clamp(max=P - 1)
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
            live = active & (d[C_VALID] > 0.5)
            pairs += active.sum()
            insts += active.any(dim=1).sum()
            flops += 11 * live.sum() + 2 * (live & (power <= 0.0)).sum() \
                + 2 * valid.sum() + 37 * contrib.sum()
        w = alpha * Tr
        v = d[C_R] * d0 + d[C_G] * d1 + d[C_B] * d2 + d[C_Z] * d3
        S = torch.where(contrib, S + w * v, S)
        dalpha = Tr * v - (Q - S) / (1.0 - alpha)
        dpower = d[C_OP] * G * dalpha
        gdx = dpower * dx
        gdy = dpower * dy
        terms = (gdx, gdy, gdx * dx, gdx * dy, gdy * dy, G * dalpha,
                 d0 * w, d1 * w, d2 * w, d3 * w)
        sx, sy, sxx, sxy, syy, sop, sr, sg, sb, sz = (
            torch.where(contrib, x, zero).sum(dim=1) for x in terms)
        ca, cb, cc = d[C_CA, :, 0], d[C_CB, :, 0], d[C_CC, :, 0]
        grads = torch.stack([ca * sx + cb * sy, cb * sx + cc * sy,
                             -0.5 * sxx, -sxy, -0.5 * syy, sop, sr, sg, sb,
                             sz])                              # [10, T]
        dinst[:10, col[live_tile]] = grads[:, live_tile]
        Tr = torch.where(contrib, test_T, Tr)
        done = done | trigger
    if aux is not None:
        aux["pairs"] = int(pairs)
        aux["flops"] = int(flops)
        aux["instances"] = int(insts)
    return dinst


def rasterize_binned_bwd(inst, tile_start, tile_end, grid_x: int,
                         grid_y: int, dpix):
    """Instance gradients [16, P] (rows 0-9: d mx, my, ca, cb, cc, op, r,
    g, b, z; rows 10-15 zero) from the per-pixel inputs dpix [T, 256, 8]
    (pixel_grads)."""
    _check(inst, tile_start, tile_end, grid_x, grid_y)
    T = grid_x * grid_y
    _check_dpix(dpix, T)
    on = [x.is_cuda for x in (inst, tile_start, tile_end, dpix)]
    if not all(on):
        if any(on):
            raise ValueError("tensors must all be on one device")
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
    Gradients of w_max and gid (output channels 5-6) are ignored."""

    @staticmethod
    def forward(ctx, inst, tile_start, tile_end, grid_x, grid_y,
                with_tidx=False):
        out = rasterize_binned(inst, tile_start, tile_end, grid_x, grid_y,
                               with_tidx)
        ctx.save_for_backward(inst, tile_start, tile_end, out)
        ctx.grid = (grid_x, grid_y)
        return out

    @staticmethod
    def backward(ctx, g):
        inst, tile_start, tile_end, out = ctx.saved_tensors
        dpix = pixel_grads(out, g)
        dinst = rasterize_binned_bwd(inst, tile_start, tile_end, *ctx.grid,
                                     dpix)
        return dinst, None, None, None, None, None
