"""Stack, expand and interleave: the three selection kernels of the
instance stream, each with its plain PyTorch version.

Torch twin of gaussianprediction_tpu/ops/expand_pallas.py. Each wrapper
launches its CUDA kernel (kernels/csrc) for a CUDA tensor and takes the
plain version only for a tensor on the CPU; there is no fallback between
the two. All three are pure selections, so kernel and plain version agree
bit for bit.

  stack_rows       k x [n] -> [nch, n] channel-major (zero pad rows)
  expand_rows_raw  slot -> Gaussian expansion of the permat (raw rows)
  emit_from_raw    rect walk + invalid-slot masking of raw rows
  expand_emit      expand_rows_raw and emit_from_raw fused in one kernel
                   (the main path's form)
  interleave_rows  11 x [P] sorted channels -> the [16, P] instance SoA

Permat rows (the expand input): 0-9 feat, 10 offs, 11 tminx, 12 tminy,
13 rw, 14 gid, 15 zero. Emitted rows: 0-9 feat (zeroed when invalid),
10 gid (-1 when invalid), 11 tile key as f32 (sentinel when invalid).
"""
from __future__ import annotations

import torch

from gaussianprediction_tpu_torch.kernels import launch_counts

NCH = 16
N_EMIT = 12


def _kernels():
    from gaussianprediction_tpu_torch.kernels import build

    return build


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _check_rows(rows, n):
    for r in rows:
        if r.dtype != torch.float32 or r.dim() != 1 or r.shape[0] != n:
            raise ValueError("rows must be 1-d float32 tensors of one length")
        if not r.is_contiguous():
            raise ValueError("rows must be contiguous")


def _on_cuda(*tensors) -> bool:
    cuda = [t.is_cuda for t in tensors]
    if any(cuda) and not all(cuda):
        raise ValueError("tensors must all be on one device")
    return cuda[0]


# ---------------------------------------------------------------- stack


def stack_rows_plain(chans, nch: int = NCH):
    mat = torch.stack(list(chans), dim=0)
    k, n = mat.shape
    if k < nch:
        mat = torch.cat([mat, mat.new_zeros((nch - k, n))], dim=0)
    return mat


def stack_rows(chans, nch: int = NCH):
    """k x [n] f32 rows -> [nch, n] (rows k..nch-1 zero)."""
    chans = list(chans)
    k, n = len(chans), chans[0].shape[0]
    if not 1 <= k <= nch <= 16:
        raise ValueError(f"need 1 <= k={k} <= nch={nch} <= 16")
    _check_rows(chans, n)
    if not _on_cuda(*chans):
        return stack_rows_plain(chans, nch)
    b = _kernels()
    out = torch.empty((nch, n), dtype=torch.float32, device=chans[0].device)
    b.launch("gpt_stack_rows", b.row_pointers(chans), k, nch, n,
             out.data_ptr(), _stream())
    launch_counts["stack"] += 1
    return out


# --------------------------------------------------------------- expand


def _check_expand(permat, offs, total):
    if permat.dtype != torch.float32 or permat.dim() != 2 or \
            permat.shape[0] != NCH or not permat.is_contiguous():
        raise ValueError("permat must be a contiguous [16, N] float32")
    if offs.dtype != torch.int32 or offs.shape != (permat.shape[1],) or \
            not offs.is_contiguous():
        raise ValueError("offs must be a contiguous [N] int32")
    if total.dtype != torch.int32 or total.numel() != 1:
        raise ValueError("total must be a one-element int32 tensor")
    if permat.shape[1] < 1:
        raise ValueError("expand needs at least one Gaussian")


def _owner(offs, capacity: int):
    """Per slot j, the Gaussian g with offs[g] <= j < offs[g+1]."""
    j = torch.arange(capacity, dtype=torch.int32, device=offs.device)
    g = torch.searchsorted(offs, j, right=True) - 1
    return g.clamp(min=0)


def expand_rows_raw_plain(permat, offs, total, capacity: int):
    return permat[:, _owner(offs, capacity)]


def expand_rows_raw(permat, offs, total, capacity: int):
    """permat [16, N], offs [N] int32 ascending exclusive cumsum of the
    per-Gaussian slot counts (every Gaussian owns >= 1 slot), total [1]
    int32 live slot count -> the [16, capacity] raw rows of each slot's
    owner. `total` is not read in raw mode (it is the emit's bound)."""
    _check_expand(permat, offs, total)
    if not _on_cuda(permat, offs, total):
        return expand_rows_raw_plain(permat, offs, total, capacity)
    return _expand_launch(permat, offs, total, capacity, False, 0, 0)


def emit_from_raw(raw, total, grid_x: int, sentinel: int):
    """Raw rows -> the emitted [12, P] rows (plain PyTorch; the main path
    runs it fused into the expand kernel, expand_emit).

    The rect walk is exact f32 small-integer arithmetic in the JAX
    package's order: k = j - offs, q = floor(k / rw), key = (tminy + q) *
    grid_x + (tminx + k - q*rw). rw == 0 flags an empty Gaussian's
    singleton slot, emitted invalid."""
    P = raw.shape[1]
    j = torch.arange(P, dtype=torch.int32, device=raw.device)
    offs_sel, tminx, tminy, rw, gid = raw[10], raw[11], raw[12], raw[13], \
        raw[14]
    k = j.to(torch.float32) - offs_sel
    rwm = torch.clamp(rw, min=1.0)
    q = torch.floor(k / rwm)
    rem = k - q * rwm
    keyf = (tminy + q) * float(grid_x) + (tminx + rem)
    ok = (j < total.reshape(())) & (rw > 0.5)
    okf = ok.to(torch.float32)
    feat = raw[:10] * okf
    gid_out = torch.where(ok, gid, torch.full_like(gid, -1.0))
    key_out = torch.where(ok, keyf, torch.full_like(keyf, float(sentinel)))
    return torch.cat([feat, gid_out[None], key_out[None]], dim=0)


def expand_emit(permat, offs, total, capacity: int, grid_x: int,
                sentinel: int):
    """expand_rows_raw + emit_from_raw: [12, capacity] emitted rows. One
    fused kernel launch on the card (launch count "expand")."""
    _check_expand(permat, offs, total)
    if not _on_cuda(permat, offs, total):
        return emit_from_raw(
            expand_rows_raw_plain(permat, offs, total, capacity), total,
            grid_x, sentinel,
        )
    return _expand_launch(permat, offs, total, capacity, True, grid_x,
                          sentinel)


def _expand_launch(permat, offs, total, capacity, emit, grid_x, sentinel):
    b = _kernels()
    rows = N_EMIT if emit else NCH
    out = torch.empty((rows, capacity), dtype=torch.float32,
                      device=permat.device)
    total = total.reshape(1).contiguous()
    b.launch("gpt_expand_rows", permat.data_ptr(), offs.data_ptr(),
             permat.shape[1], total.data_ptr(), capacity, int(emit),
             float(grid_x), float(sentinel), out.data_ptr(), _stream())
    launch_counts["expand"] += 1
    return out


# ----------------------------------------------------------- interleave


def interleave_rows_plain(chans):
    gid = chans[10]
    valid = (gid >= 0.0).to(torch.float32)
    zeros = torch.zeros_like(gid)
    return torch.stack(
        list(chans[:10]) + [gid, valid, zeros, zeros, zeros, zeros], dim=0
    )


def interleave_rows(chans):
    """11 x [P] rows (feat0..9, gid) -> [16, P] instance SoA: rows 0-9
    feat, 10 gid, 11 valid = gid >= 0, 12-15 zero."""
    chans = list(chans)
    if len(chans) != 11:
        raise ValueError("interleave_rows takes 11 rows")
    n = chans[0].shape[0]
    _check_rows(chans, n)
    if not _on_cuda(*chans):
        return interleave_rows_plain(chans)
    b = _kernels()
    out = torch.empty((NCH, n), dtype=torch.float32, device=chans[0].device)
    b.launch("gpt_interleave_rows", b.row_pointers(chans), n,
             out.data_ptr(), _stream())
    launch_counts["interleave"] += 1
    return out
