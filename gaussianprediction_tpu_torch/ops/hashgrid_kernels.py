"""Sorted-stream scatter-add into a flat feature table: the kernel's
wrapper and its plain version.

Torch twin of gaussianprediction_tpu/ops/hashgrid_pallas.py
(scatter_add_sorted), the table gradient of the hash-grid encoder. The
CUDA kernel (kernels/csrc/scatter_add_sorted.cu) is a segmented reduction
over the sorted stream: each slot is written once, with no atomics and a
fixed order (each run summed in stream order), so two launches are
bit-identical. Launches count under "scatter_add_sorted" in
kernels.launch_counts.
"""
from __future__ import annotations

import torch

from gaussianprediction_tpu_torch.kernels import launch_counts

MAX_F = 8


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
    """out[f, s] = Σ vals[f, i] over keys[i] == s: index_add_ row by row,
    on the CPU a serial sum in stream order (each row as a 1-d index_add_,
    which takes a direct loop where the 2-d form does one slice op per
    contribution; the sums are the same)."""
    out = vals_sorted.new_zeros((vals_sorted.shape[0], n_slots))
    for f in range(vals_sorted.shape[0]):
        out[f].index_add_(0, keys_sorted, vals_sorted[f])
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
    starts = torch.empty((max(n_slots, 1),), dtype=torch.int32, device=dev)
    build.launch("gpt_scatter_add_sorted", keys_sorted.data_ptr(),
                 vals_sorted.data_ptr(), M, F, n_slots, starts.data_ptr(),
                 out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    launch_counts["scatter_add_sorted"] += 1
    return out
