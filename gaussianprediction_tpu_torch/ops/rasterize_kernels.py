"""Tile blend forward: the CUDA kernel's wrapper and its plain version.

Torch twin of the forward half of gaussianprediction_tpu/ops/
rasterize_pallas.py (its constants, rasterize_binned and the classic
_fwd_kernel branch). The blend follows the reference CUDA rasterizer's
semantics, as the oracle ops/rasterize_reference.py does: per pixel, in
segment order, alpha = min(0.99, op * exp(power)), skipped when power > 0
or alpha < 1/255; T *= 1 - alpha; the pixel latches done (and the
instance does not contribute) once T would drop below 1e-4; tidx is the
gid of the first strict maximum of the blend weight.

The backward kernel and the env-gated variants (MT, SMT, FLAT) wait for
the training slice of the port.
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
