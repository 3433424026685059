"""Parity of the port's stack / expand / interleave (ops/expand.py) with
gaussianprediction_tpu/ops/expand_pallas.py.

All three are pure selections, so everything is held bit-exact: the JAX
side runs the expand kernel in Pallas interpret mode (both its resident
and its windowed variant) and stack/interleave through their plain
references, as the JAX package's own tests do on the CPU. The contract of
expand is the EMITTED stream (feat, gid, key after masking): raw rows past
the live total differ between the TPU variants and are not compared.

The CUDA kernels are held to these plain versions on the card by
tests/test_torch_gpu.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import n, one_torch_thread, t  # noqa: F401

from gaussianprediction_tpu.ops import expand_pallas as JE
from gaussianprediction_tpu_torch.ops import expand as TE


def _layout(counts_rw_rh, grid_x=8, seed=0):
    """Per-Gaussian (rw, rh) -> permat rows as build_instances_fwd makes
    them: every Gaussian owns max(rw*rh, 1) slots, rw == 0 flags an empty
    one."""
    rw, rh = (np.asarray(a, np.int32) for a in counts_rw_rh)
    num = len(rw)
    rng = np.random.default_rng(seed)
    count1 = np.maximum(rw * rh, 1)
    offsets = (np.cumsum(count1) - count1).astype(np.int32)
    rows = np.zeros((16, num), np.float32)
    rows[0:10] = rng.normal(size=(10, num))
    rows[10] = offsets
    rows[11] = rng.integers(0, grid_x - 5, num)
    rows[12] = rng.integers(0, grid_x - 4, num)
    rows[13] = rw
    rows[14] = np.arange(num)
    return rows, offsets, int(count1.sum())


def _jax_emit(rows, offsets, total, capacity, grid_x, sentinel):
    """The JAX package's expand kernel (interpret) + emit pass."""
    num = rows.shape[1]
    W = JE.WCAND
    Np = ((num + 2 * W + JE.STK_BLK - 1) // JE.STK_BLK) * JE.STK_BLK
    permat = np.zeros((16, Np), np.float32)
    permat[:, :num] = rows
    offs_row = np.full((1, Np), JE.HUGE, np.int32)
    offs_row[0, :num] = offsets
    cap = ((capacity + JE.ALIGN - 1) // JE.ALIGN) * JE.ALIGN
    nb = cap // JE.BSLOT
    g0 = np.maximum(np.searchsorted(
        offs_row[0], np.arange(nb) * JE.BSLOT, side="right") - 1, 0)
    raw = JE.expand_rows_raw(
        jnp.asarray(permat), jnp.asarray(offs_row),
        jnp.asarray((g0 // W).astype(np.int32)),
        jnp.asarray([total], jnp.int32), cap, interpret=True)
    return np.stack([np.asarray(c) for c in JE.emit_from_raw(
        raw, jnp.int32(total), grid_x, sentinel)]), cap


CASES = {
    # rect walks of width 1..5 and empty Gaussians' singleton slots
    "rects": lambda r: (r.integers(0, 6, 400), r.integers(1, 5, 400)),
    # 0..126 own one slot, 127 owns two: the TPU windows' zero-slack case
    "window_boundary": lambda r: (np.r_[np.ones(127), 2, np.ones(172)],
                                  np.ones(300)),
    "giant": lambda r: (np.array([40, 1, 5]), np.array([25, 1, 1])),
}


@pytest.mark.parametrize("windowed", [False, True],
                         ids=["resident", "windowed"])
@pytest.mark.parametrize("case", list(CASES) + ["capacity_truncates"])
def test_expand_emit_matches_jax(case, windowed, monkeypatch):
    if windowed:
        monkeypatch.setattr(JE, "RES_MAX_BYTES", 0)
    r = np.random.default_rng(1)
    rw, rh = CASES.get(case, CASES["rects"])(r)
    grid_x, sentinel = 8, 64
    rows, offsets, total1 = _layout((rw, rh), grid_x)
    capacity = total1 // 2 if case == "capacity_truncates" else total1
    total = min(total1, capacity)
    ref, cap = _jax_emit(rows, offsets, total, capacity, grid_x, sentinel)
    raw = TE.expand_rows_raw(t(rows), t(offsets), t(np.int32([total])), cap)
    ours = TE.emit_from_raw(raw, t(np.int32([total])), grid_x, sentinel)
    np.testing.assert_array_equal(n(ours), ref)
    fused = TE.expand_emit(t(rows), t(offsets), t(np.int32([total])), cap,
                           grid_x, sentinel)
    assert torch.equal(fused, ours)
    # raw rows of live slots are the owner's permat column
    owner = np.searchsorted(offsets, np.arange(total), side="right") - 1
    np.testing.assert_array_equal(n(raw)[:, :total], rows[:, owner])


@pytest.mark.parametrize("k,nch", [(10, 16), (15, 16), (16, 16), (3, 8)])
def test_stack_rows_matches_jax(k, nch):
    chans = np.random.default_rng(k).normal(size=(k, 1000)).astype(
        np.float32)
    ref = JE.stack_rows([jnp.asarray(c) for c in chans], nch=nch,
                        interpret=True)
    ours = TE.stack_rows([t(c) for c in chans], nch=nch)
    np.testing.assert_array_equal(n(ours), n(ref))


def test_interleave_rows_matches_jax():
    r = np.random.default_rng(2)
    chans = r.normal(size=(11, 2000)).astype(np.float32)
    chans[10] = r.integers(-1, 50, 2000)
    ref = JE.interleave_rows([jnp.asarray(c) for c in chans],
                             interpret=True)
    ours = TE.interleave_rows([t(c) for c in chans])
    np.testing.assert_array_equal(n(ours), n(ref))


def test_wrappers_reject_bad_inputs():
    x = torch.zeros(10)
    with pytest.raises(ValueError):
        TE.stack_rows([x, torch.zeros(11)])
    with pytest.raises(ValueError):
        TE.interleave_rows([x] * 10)
    with pytest.raises(ValueError):
        TE.expand_rows_raw(torch.zeros(16, 4), torch.zeros(4),
                           t(np.int32([1])), 8)
