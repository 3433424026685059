"""Inclusive row cumsums: the scan kernel's wrappers and plain versions.

Torch twin of gaussianprediction_tpu/ops/scan_pallas.py. One CUDA kernel
(kernels/csrc/cumsum_rows.cu) serves both of its functions, each counted
under its own name in kernels.launch_counts:

  cumsum_channels  k <= 16 rows of [P] -> [16, P] inclusive cumsums (rows
                   k..15 zero): the stack fused with the scan, used by the
                   instance stream's backward under GPT_BWD_REDUCE=pallas
  cumsum_rows      the same scan of an assembled [16, P] matrix, used
                   by that backward under GPT_BWD_REDUCE=batched (the
                   JAX package leaves this one to XLA's cumsum and calls
                   its kernel only from its test)

The kernel's association is fixed (per-block sums, a scan of those, a
block scan), so it is deterministic and matches the plain torch.cumsum to
f32 roundoff, not bit for bit.
"""
from __future__ import annotations

import torch

from gaussianprediction_tpu_torch.kernels import launch_counts

NCH = 16
BLK = 2048         # elements of one row per block of the kernel


def _check(chans):
    n = chans[0].shape[0]
    for r in chans:
        if r.dtype != torch.float32 or r.dim() != 1 or r.shape[0] != n \
                or not r.is_contiguous():
            raise ValueError("rows must be contiguous 1-d float32 tensors "
                             "of one length")
    cuda = [r.is_cuda for r in chans]
    if any(cuda) and not all(cuda):
        raise ValueError("tensors must all be on one device")
    return cuda[0]


def cumsum_channels_plain(chans):
    chans = list(chans)
    mat = torch.stack(chans, dim=0)
    if len(chans) < NCH:
        mat = torch.cat([mat, mat.new_zeros((NCH - len(chans),
                                             mat.shape[1]))])
    return torch.cumsum(mat, dim=1)


def _launch(chans, name):
    from gaussianprediction_tpu_torch.kernels import build

    n = chans[0].shape[0]
    dev = chans[0].device
    out = torch.empty((NCH, n), dtype=torch.float32, device=dev)
    scratch = torch.empty((NCH * max(1, -(-n // BLK)),), dtype=torch.float32,
                          device=dev)
    build.launch("gpt_cumsum_rows", build.row_pointers(chans), len(chans), n,
                 out.data_ptr(), scratch.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
    launch_counts[name] += 1
    return out


def cumsum_channels(chans):
    """k <= 16 rows of [P] f32 -> [16, P] inclusive cumsums along each row,
    rows k..15 zero."""
    chans = list(chans)
    if not 1 <= len(chans) <= NCH:
        raise ValueError(f"need 1 <= k <= {NCH} rows")
    if not _check(chans):
        return cumsum_channels_plain(chans)
    return _launch(chans, "cumsum_channels")


def cumsum_rows_plain(mat):
    return torch.cumsum(mat, dim=1)


def cumsum_rows(mat):
    """[16, P] f32 -> [16, P] inclusive cumsum along axis 1."""
    if mat.dim() != 2 or mat.shape[0] != NCH:
        raise ValueError("mat must be [16, P]")
    rows = [mat[c] for c in range(NCH)]
    if not _check(rows):
        return cumsum_rows_plain(mat)
    return _launch(rows, "cumsum_rows")
