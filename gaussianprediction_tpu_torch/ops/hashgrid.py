"""Multiresolution hash-grid encoding (the tiny-cuda-nn configuration the
reference's blend-weight model uses).

Torch twin of the `hashgrid` encoder of gaussianprediction_tpu/ops/
hashgrid.py: L levels of F features, resolutions n_min to max_res in a
geometric series, trilinear interpolation of the 8 corners of each
point's cell. Coarse levels whose dense grid fits in the table are stored
dense; finer ones use tcnn's xor-multiply spatial hash. Inputs are
normalized to [0, 1]^3 by a scene bound. Tables are a dict
{"level_l": [size_l, F]}, the JAX layout.

hashgrid_encode_fast is the one the model uses: the forward is one gather
of the concatenated tables, the backward recomputes keys and weights,
sorts each level's 8N contributions (stable, so each slot's order is the
same on every run) and reduces them with the scatter_add_sorted kernel.
No gradient reaches xyz: the model always encodes detached positions.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from gaussianprediction_tpu_torch.ops import hashgrid_kernels as HK

PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF
# the 8 corners of a cell, (i, j, k) with k fastest
CORNERS = [[i, j, k] for i in (0, 1) for j in (0, 1) for k in (0, 1)]


def level_resolutions(n_levels: int = 16, n_min: int = 16,
                      max_res: int = 2048) -> list:
    b = math.exp(math.log(max_res / n_min) / (n_levels - 1))
    return [int(round(n_min * (b**l))) for l in range(n_levels)]


def level_table_size(res: int, log2_T: int) -> int:
    return min((res + 1) ** 3, 2**log2_T)


def init_hashgrid(rng: np.random.Generator, n_levels: int = 16,
                  n_features: int = 4, log2_T: int = 19, n_min: int = 16,
                  max_res: int = 2048):
    """Per-level tables drawn U(-1e-4, 1e-4) (tcnn's init) with numpy on
    the host; float32 numpy arrays, put on the device with the state."""
    tables = {}
    for l, res in enumerate(level_resolutions(n_levels, n_min, max_res)):
        size = level_table_size(res, log2_T)
        tables[f"level_{l}"] = rng.uniform(
            -1e-4, 1e-4, (size, n_features)).astype(np.float32)
    return tables


def _corner_index(p, res1, size, dense):
    """Slot of each corner within its level: the dense index where the
    level's flag is set, else tcnn's xor-multiply hash modulo the table
    size. p [L, N, 8, 3] int64 corners clamped to [0, res]; res1 = res + 1,
    size and dense broadcast over [L, N, 8]. The JAX package hashes in
    uint32 and lets the products wrap; here each product is taken in int64
    (coordinates <= 2048, primes < 2^32) and cut to its low 32 bits, which
    is the same number."""
    px, py, pz = p[..., 0], p[..., 1], p[..., 2]
    h = ((px * PRIMES[0]) & _U32) ^ ((py * PRIMES[1]) & _U32) \
        ^ ((pz * PRIMES[2]) & _U32)
    return torch.where(dense, (px * res1 + py) * res1 + pz, h % size)


@functools.lru_cache(maxsize=None)
def _corners(device: torch.device):
    """[8, 3] int32 corner offsets, made once per device (a host-to-device
    copy on every call would block the host)."""
    return torch.tensor(CORNERS, dtype=torch.int32, device=device)


def _normalize(xyz, bound: float):
    return torch.clamp((xyz + bound) / (2.0 * bound), 0.0, 1.0)


def _corner_weights(frac, corners):
    """Trilinear weights of the corners: Π over axes of frac (corner bit
    1) or 1 - frac (bit 0). frac [..., 3], corners [8, 3] int32."""
    f = frac[..., None, :]
    sel = torch.where(corners == 1, f, 1.0 - f)
    return sel[..., 0] * sel[..., 1] * sel[..., 2]


def hashgrid_encode(tables: dict, xyz, bound: float = 1.6, n_min: int = 16,
                    max_res: int = 2048):
    """Encode xyz [N, 3] -> [N, L*F] with plain autograd through the
    gather (PyTorch's own backward of the indexing): the reference the
    tests hold hashgrid_encode_fast's backward to."""
    specs, _ = hashgrid_specs(tables, n_min, max_res)
    keys, w = hashgrid_keys_weights(xyz, specs, bound)
    return _interpolate(_flat_tables(tables)[keys.to(torch.int64)], w)


def hashgrid_specs(tables: dict, n_min: int, max_res: int):
    """(res, size, offset) per level and the total slot count."""
    resolutions = level_resolutions(len(tables), n_min, max_res)
    specs, off = [], 0
    for l, res in enumerate(resolutions):
        size = tables[f"level_{l}"].shape[0]
        specs.append((res, size, off))
        off += size
    return specs, off


@functools.lru_cache(maxsize=None)
def _level_consts(specs: tuple, device: torch.device):
    """Per-level constants shaped to broadcast over [L, N, 8]: the
    resolution (float32 and int64), res + 1, the table size, the dense
    flag and the offset, made once per (specs, device)."""
    res = torch.tensor([r for r, _, _ in specs], device=device)
    size = torch.tensor([s for _, s, _ in specs], device=device)
    dense = torch.tensor([(r + 1) ** 3 <= s for r, s, _ in specs],
                         device=device)
    off = torch.tensor([o for _, _, o in specs], device=device)
    col = lambda v: v[:, None, None]  # noqa: E731
    return (col(res.to(torch.float32)), col(res)[..., None], col(res + 1),
            col(size), col(dense), col(off))


def hashgrid_keys_weights(xyz, specs, bound: float):
    """Global corner slot ids and trilinear weights of every (level,
    corner): keys [L, N, 8] int32 (offset into the concatenated tables)
    and w [L, N, 8] float32, level-major, so that each level's 8N
    contributions sort on their own and the sorted rows, flattened in
    level order, are globally slot-sorted. All levels are computed at
    once (the dense index and the hash of every level, the level's flag
    picking one): the same integers and floats as level by level."""
    res_f, res_i, res1, size, dense, off = _level_consts(
        tuple(specs), xyz.device)
    corners = _corners(xyz.device)
    pos = _normalize(xyz, bound)[None] * res_f                  # [L, N, 3]
    p0 = torch.floor(pos).to(torch.int32)
    frac = pos - p0
    p = torch.minimum(torch.clamp(p0[:, :, None, :] + corners, min=0)
                      .to(torch.int64), res_i)                  # [L,N,8,3]
    idx = _corner_index(p, res1, size, dense) + off
    return idx.to(torch.int32), _corner_weights(frac, corners)


def _flat_tables(tables: dict):
    return torch.cat([tables[f"level_{l}"] for l in range(len(tables))])


# a table row of F float32 values as one element of this dtype
_ROW_DTYPES = {1: torch.float32, 2: torch.complex64, 4: torch.complex128}


def _gather_rows(flat, idx):
    """flat[idx] for a [S, F] float32 table, bit for bit. PyTorch gathers
    rows of a 2-d table one index at a time; with each row viewed as one
    8- or 16-byte element the same gather is an elementwise copy, many
    times faster on the card (PERF.md)."""
    dt = _ROW_DTYPES.get(flat.shape[1])
    if dt is None:
        return flat.index_select(0, idx)
    rows = flat.contiguous().view(dt).reshape(-1)
    return rows.index_select(0, idx).view(torch.float32).reshape(
        -1, flat.shape[1])


def _interpolate(g, w):
    """Corner rows g [L, N, 8, F] and weights w [L, N, 8] -> [N, L*F]."""
    feat = torch.sum(w[..., None] * g, dim=2)                  # [L, N, F]
    return feat.transpose(0, 1).reshape(g.shape[1], -1)


def _encode_from_flat(flat, keys, w):
    """[S, F] flat tables, [L, N, 8] keys/weights -> [N, L*F]."""
    g = _gather_rows(flat, keys.reshape(-1))
    return _interpolate(g.reshape(*keys.shape, -1), w)


def table_grads_sorted(keys, w, g, total: int):
    """The [total, F] gradient of the flat tables: vals = w * g per
    (level, point, corner), each level's 8N contributions sorted by slot
    (stable), then the sorted stream reduced by scatter_add_sorted."""
    L, n, _ = keys.shape
    F = g.shape[1] // L
    g_l = g.reshape(n, L, F).permute(2, 1, 0)                 # [F, L, N]
    vals = (w[None] * g_l[..., None]).reshape(F, L, n * 8)
    ks, perm = torch.sort(keys.reshape(L, n * 8), dim=1, stable=True)
    vs = torch.gather(vals, 2, perm[None].expand(F, L, n * 8))
    return HK.scatter_add_sorted(ks.reshape(-1), vs.reshape(F, L * n * 8),
                                 total).T


class _HashgridEncode(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xyz, specs, bound, flat):
        keys, w = hashgrid_keys_weights(xyz, specs, bound)
        ctx.save_for_backward(xyz)
        ctx.specs, ctx.bound, ctx.total = specs, bound, flat.shape[0]
        return _encode_from_flat(flat, keys, w)

    @staticmethod
    def backward(ctx, g):
        (xyz,) = ctx.saved_tensors
        keys, w = hashgrid_keys_weights(xyz, ctx.specs, ctx.bound)
        dflat = table_grads_sorted(keys, w, g.contiguous(), ctx.total)
        dxyz = torch.zeros_like(xyz) if ctx.needs_input_grad[0] else None
        return dxyz, None, None, dflat


def hashgrid_encode_fast(tables: dict, xyz, bound: float = 1.6,
                         n_min: int = 16, max_res: int = 2048):
    """hashgrid_encode with the sort-and-reduce table gradient. The
    gradient of xyz is zero (the caller encodes detached positions)."""
    specs, _ = hashgrid_specs(tables, n_min, max_res)
    return _HashgridEncode.apply(xyz, specs, bound, _flat_tables(tables))
