"""Parity of the port's pointops (ops/pointops.py: grouping,
queryandgroup, subtraction, aggregation, interpolation) and of
models/gaussians.py:load_ply_params with the JAX package.

The same numpy inputs (40 source points, 25 queries, 6 channels, a
3-channel aggregation weight shared cyclically) go through both; values
and the gradients of a random linear functional of each output (JAX AD
against torch autograd) agree within 1e-5 relative to each array's
largest magnitude: gathers and sums of the same f32 values, the KNN
distances through the same formula. The neighbour indices are equal
(distinct distances at this size).

load_ply_params: the port's save_ply writes a `dnerf`-preset state of 300
live Gaussians (SH degree 3, capacity rows dead), then both packages read
the file; params and the alive mask are equal bit for bit, dead rows at
opacity -15.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import n, one_torch_thread, stage1_params, t  # noqa

from gaussianprediction_tpu import config as jcfg
from gaussianprediction_tpu.models import gaussians as JG
from gaussianprediction_tpu.ops import pointops as JPO
from gaussianprediction_tpu_torch import config as tcfg
from gaussianprediction_tpu_torch.convert import state_from_params
from gaussianprediction_tpu_torch.models import gaussians as TG
from gaussianprediction_tpu_torch.ops import pointops as TPO

RNG = np.random.default_rng(31)
XYZ = RNG.normal(size=(40, 3)).astype(np.float32)
NEW = RNG.normal(size=(25, 3)).astype(np.float32)
FEAT = RNG.normal(size=(40, 6)).astype(np.float32)
IDX = RNG.integers(0, 40, (25, 4)).astype(np.int32)
SQ_IDX = RNG.integers(0, 25, (25, 4)).astype(np.int32)
POS = RNG.normal(size=(25, 4, 6)).astype(np.float32)
WGT = RNG.normal(size=(25, 4, 3)).astype(np.float32)
A25 = RNG.normal(size=(25, 6)).astype(np.float32)


def _ix(P, idx):
    """The index array in the package's own array type."""
    return torch.as_tensor(idx) if P is TPO else jnp.asarray(idx)


# name -> (function of the differentiable inputs, the inputs)
CASES = {
    "grouping": (lambda P, f: P.grouping(f, _ix(P, IDX)), (FEAT,)),
    "queryandgroup": (lambda P, x, q, f: P.queryandgroup(4, x, q, f),
                      (XYZ, NEW, FEAT)),
    "queryandgroup_self": (
        lambda P, x, f: P.queryandgroup(5, x, None, f, use_xyz=False),
        (XYZ, FEAT)),
    "subtraction": (lambda P, a, b: P.subtraction(a, b, _ix(P, SQ_IDX)),
                    (A25, A25[::-1].copy())),
    "aggregation": (lambda P, i, p, w: P.aggregation(i, p, w, _ix(P, SQ_IDX)),
                    (A25, POS, WGT)),
    "interpolation": (lambda P, x, q, f: P.interpolation(x, q, f),
                      (XYZ, NEW, FEAT)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_pointops_match_jax(name):
    fn, inputs = CASES[name]
    jout = fn(JPO, *[jnp.asarray(a) for a in inputs])
    cot = np.random.default_rng(32).normal(size=jout.shape).astype(
        np.float32)
    jgrads = jax.grad(
        lambda *a: jnp.sum(fn(JPO, *a) * cot),
        argnums=tuple(range(len(inputs))))(*[jnp.asarray(a)
                                             for a in inputs])
    targs = [t(a).requires_grad_(True) for a in inputs]
    tout = fn(TPO, *targs)
    assert tuple(tout.shape) == tuple(jout.shape)
    scale = np.abs(np.asarray(jout)).max()
    np.testing.assert_allclose(n(tout), np.asarray(jout), rtol=0,
                               atol=1e-5 * scale)
    torch.sum(tout * t(cot)).backward()
    for a, b in zip(targs, jgrads):
        ref = np.asarray(b)
        got = n(a.grad) if a.grad is not None else np.zeros_like(ref)
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-5 * max(np.abs(ref).max(), 1e-6))


def test_load_ply_params_matches_jax(tmp_path):
    cfg = tcfg.get_preset("dnerf")
    cfg.model.max_gaussian_size = cfg.model.capacity = 512
    jc = jcfg.Config.from_json(cfg.to_json())
    params, alive = stage1_params(cfg, 512, seed=33)
    alive[300:] = False
    params["opacity"][5] = -0.0           # signed zeros survive the read
    state = state_from_params(params, alive, device="cpu")
    path = str(tmp_path / "point_cloud.ply")
    TG.save_ply(state, path)
    ours, t_alive = TG.load_ply_params(path, cfg, device="cpu")
    ref, j_alive = JG.load_ply_params(path, jc)
    np.testing.assert_array_equal(n(t_alive), np.asarray(j_alive))
    assert int(t_alive.sum()) == 300
    assert sorted(ours) == sorted(ref)
    for k in ref:
        a, b = n(ours[k]), np.asarray(ref[k])
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape, k
        assert (a.view(np.int32) == b.view(np.int32)).all(), k
    # the live rows are the saved state's, in order
    live = np.flatnonzero(alive)
    np.testing.assert_array_equal(n(ours["xyz"])[:300], params["xyz"][live])
    assert (n(ours["opacity"])[300:] == -15.0).all()
