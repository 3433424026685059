"""Sorted-stream scatter-add into a flat feature table: the kernel's
wrapper and its plain version.

Torch twin of gaussianprediction_tpu/ops/hashgrid_pallas.py
(scatter_add_sorted), the table gradient of the hash-grid encoder. The
CUDA kernel (kernels/csrc/scatter_add_sorted.cu) is a segmented reduction
cut by stream position: tiles of TILE positions, each run's piece in a
tile summed from 0.0 in stream order, a run's pieces added from 0.0 in tile
order. Each slot's sum is written once, with no atomics, so two launches
are bit-identical, and the plain version takes the same order (on the CPU
bit for bit). Launches count under "scatter_add_sorted" in
kernels.launch_counts.
"""
from __future__ import annotations

import torch

from gaussianprediction_tpu_torch.kernels import launch_counts

MAX_F = 8
TILE = 1024   # stream positions a tile: kTile in scatter_add_sorted.cu


def _check(keys_sorted, vals_sorted, n_slots: int) -> bool:
    if keys_sorted.dtype != torch.int32 or keys_sorted.dim() != 1 \
            or not keys_sorted.is_contiguous():
        raise ValueError("keys_sorted must be a contiguous 1-d int32 tensor")
    if vals_sorted.dtype != torch.float32 or vals_sorted.dim() != 2 \
            or not vals_sorted.is_contiguous():
        raise ValueError("vals_sorted must be a contiguous [F, M] float32 "
                         "tensor")
    F, M = vals_sorted.shape
    if M != keys_sorted.shape[0]:
        raise ValueError("keys_sorted and vals_sorted differ in length")
    if not 1 <= F <= MAX_F:
        raise ValueError(f"need 1 <= F <= {MAX_F} value rows")
    if M >= 2**31 or not 0 <= n_slots < 2**31:
        raise ValueError("M and n_slots must fit in int32")
    if keys_sorted.is_cuda != vals_sorted.is_cuda:
        raise ValueError("tensors must all be on one device")
    return keys_sorted.is_cuda


def scatter_add_sorted_plain(keys_sorted, vals_sorted, n_slots: int):
    """out[f, s] = Σ vals[f, i] over keys[i] == s, in the kernel's order:
    each run of one key cut at multiples of TILE into pieces, each piece
    summed from 0.0 in stream order, the pieces' sums added from 0.0 in
    tile order. Two 1-d index_add_ passes a row give that order on the CPU,
    where a 1-d index_add_ is a serial loop (the 2-d form does one slice op
    per contribution); on the card they sum with atomics."""
    F, M = vals_sorted.shape
    out = vals_sorted.new_zeros((F, n_slots))
    if M == 0:
        return out
    pos = torch.arange(M, device=keys_sorted.device)
    cut = pos % TILE == 0
    cut[1:] |= keys_sorted[1:] != keys_sorted[:-1]
    piece = torch.cumsum(cut, 0) - 1
    piece_key = keys_sorted[cut]
    sums = vals_sorted.new_zeros((F, piece_key.shape[0]))
    for f in range(F):
        sums[f].index_add_(0, piece, vals_sorted[f])
        out[f].index_add_(0, piece_key, sums[f])
    return out


def scatter_add_sorted(keys_sorted, vals_sorted, n_slots: int):
    """Σ-reduce sorted contributions into a [F, n_slots] table.

    keys_sorted: [M] int32, ascending, all in [0, n_slots); vals_sorted:
    [F, M] float32 in the same order. Returns [F, n_slots] float32, 0
    where a slot receives nothing. CPU tensors take the plain version,
    CUDA tensors the kernel."""
    if not _check(keys_sorted, vals_sorted, n_slots):
        return scatter_add_sorted_plain(keys_sorted, vals_sorted, n_slots)
    from gaussianprediction_tpu_torch.kernels import build

    F, M = vals_sorted.shape
    dev = vals_sorted.device
    out = torch.empty((F, n_slots), dtype=torch.float32, device=dev)
    carry = torch.empty((max(-(-M // TILE), 1), 2, F), dtype=torch.float32,
                        device=dev)
    build.launch("gpt_scatter_add_sorted", keys_sorted.data_ptr(),
                 vals_sorted.data_ptr(), M, F, n_slots, carry.data_ptr(),
                 out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    launch_counts["scatter_add_sorted"] += 1
    return out
