"""Parity of the port's instance stream (ops/instance_stream.py) with
gaussianprediction_tpu/ops/instance_stream.py:build_instances_fwd.

The same projected scene (from the JAX package, so both sides get equal
floats) goes through both. Held exactly: tile_start, tile_end, n_dropped,
n_total, and the sorted [16, P] stream inside every tile segment (the
(tile, depth) order and every channel, bit for bit). Past the segments
lie the invalid slots, whose order is not part of the contract. Covered:
a stream sized for zero drops, a capacity overflow (n_dropped > 0) and
rect capping (max_tiles small enough to cap).

The backward (the per-Gaussian reduction of the instance cotangent) is
held to the JAX custom VJP in all three GPT_BWD_REDUCE modes, sized and
overflowing, within 64 * 2^-24 of the largest running sum |cumsum| of the
sorted cotangent: both take differences of f32 prefix sums, which XLA and
PyTorch associate differently.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import n, one_torch_thread, scene, t  # noqa: F401

from gaussianprediction_tpu.data.synthetic import orbit_camera
from gaussianprediction_tpu.ops import instance_stream as JS
from gaussianprediction_tpu.ops import projection as JP
from gaussianprediction_tpu_torch.data.synthetic import (
    orbit_camera as torbit,
)
from gaussianprediction_tpu_torch.ops import instance_stream as TS

W = H = 128
GX = GY = 8


def _projected(num=2000, seed=0, scale_range=(-5.0, -3.0)):
    g = scene(num, seed=seed, scale_range=scale_range)
    cam = orbit_camera(0.5, width=W, height=H).to_device_dict()
    q = g["rotation"] / np.linalg.norm(g["rotation"], axis=-1, keepdims=True)
    alive = np.ones(num, bool)
    alive[::53] = False
    proj = JP.project_from_params(
        jnp.asarray(g["xyz"]), jnp.asarray(g["scaling"]), jnp.asarray(q),
        cam, W, H, alive=jnp.asarray(alive),
        opacity=jnp.asarray(g["opacity"]))
    feat = jnp.concatenate(
        [proj.mean2d, proj.conic, jnp.asarray(g["opacity"])[:, None],
         jnp.asarray(g["colors"]), proj.depth[:, None]], axis=-1)
    return g, q, alive, proj, feat


@pytest.mark.parametrize("case", ["sized", "overflow", "capped"])
def test_build_instances_matches_jax(case):
    scale = (-3.6, -2.4) if case == "capped" else (-5.0, -3.0)
    _, _, _, proj, feat = _projected(scale_range=scale)
    max_tiles = 4 if case == "capped" else 1024
    capacity = 1024 if case == "overflow" else 8 * 2000
    ref, _ = JS.build_instances_fwd(
        feat, proj.depth, proj.tiles_min, proj.tiles_max, proj.visible,
        GX, GY, capacity, max_tiles, interpret=True)
    ours = TS.build_instances_fwd(
        t(feat), t(proj.tiles_min), t(proj.tiles_max), t(proj.visible),
        GX, GY, capacity, max_tiles)
    np.testing.assert_array_equal(n(ours.tile_start), n(ref.tile_start))
    np.testing.assert_array_equal(n(ours.tile_end), n(ref.tile_end))
    assert int(ours.n_dropped) == int(ref.n_dropped)
    assert int(ours.n_total) == int(ref.n_total)
    if case == "sized":
        assert int(ref.n_dropped) == 0
    else:
        assert int(ref.n_dropped) > 0
    assert tuple(ours.inst.shape) == tuple(ref.inst.shape)
    ts, te = n(ref.tile_start), n(ref.tile_end)
    cols = np.concatenate([np.arange(a, b) for a, b in zip(ts, te)])
    assert cols.size > 0
    np.testing.assert_array_equal(n(ours.inst)[:, cols],
                                  np.asarray(ref.inst)[:, cols])
    # bit-exact, not only equal in value (-0.0 vs +0.0 included)
    assert (n(ours.inst)[:12, cols].view(np.int32)
            == np.asarray(ref.inst)[:12, cols].view(np.int32)).all()


def test_probe_slot_need_matches_jax():
    g, q, alive, _, _ = _projected(seed=3)
    jcam = orbit_camera(0.5, width=W, height=H).to_device_dict()
    tcam = torbit(0.5, width=W, height=H).to_device_dict("cpu")
    for max_tiles in (1024, 4):
        ref = JS.probe_slot_need(
            jnp.asarray(g["xyz"]), jnp.asarray(g["scaling"]),
            jnp.asarray(g["rotation"]), jnp.asarray(g["opacity"]), jcam, W,
            H, alive=jnp.asarray(alive), max_tiles=max_tiles)
        ours = TS.probe_slot_need(
            t(g["xyz"]), t(g["scaling"]), t(g["rotation"]), t(g["opacity"]),
            tcam, W, H, alive=t(alive), max_tiles=max_tiles)
        assert int(ours) == int(ref)


def test_capped_rect_matches_jax():
    r = np.random.default_rng(5)
    tmin = r.integers(0, 40, (500, 2)).astype(np.int32)
    tmax = (tmin + r.integers(0, 60, (500, 2))).astype(np.int32)
    center = r.uniform(-50, 1500, (500, 2)).astype(np.float32)
    for max_tiles in (1, 7, 64, 1024):
        ref = JS._capped_rect(jnp.asarray(tmin), jnp.asarray(tmax),
                              jnp.asarray(center), max_tiles)
        ours = TS._capped_rect(t(tmin), t(tmax), t(center), max_tiles)
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(n(a), n(b))


def test_orderable_bits_is_lax_sort_order():
    # lax.sort canonicalizes float keys: -0.0 == +0.0, NaNs equal and last
    z = np.array([3.0, -0.0, 0.0, -1e-30, np.nan, 1e-30, -np.inf, np.inf,
                  -2.5, 2.5, -np.nan, 1e38, -1e38, 0.0, -0.0], np.float32)
    order = torch.sort(TS.orderable_bits(t(z)), stable=True).indices
    ref = jax.lax.sort((jnp.asarray(z), jnp.arange(z.size)), num_keys=1,
                       is_stable=True)[1]
    np.testing.assert_array_equal(n(order), n(ref))


@pytest.fixture(scope="module", params=["sized", "overflow"])
def stream_vjp(request):
    """The JAX VJP of build_instances (its default reduction) on one
    random cotangent, shared by the port's three modes."""
    _, _, _, proj, feat = _projected()
    capacity = 1024 if request.param == "overflow" else 8 * 2000
    args = (proj.tiles_min, proj.tiles_max, proj.visible)
    stream, vjp = jax.vjp(
        lambda f: JS.build_instances(f, proj.depth, *args, GX, GY, capacity,
                                     1024, True), feat)
    assert (int(stream.n_dropped) > 0) == (request.param == "overflow")
    cot = np.random.default_rng(8).normal(size=stream.inst.shape).astype(
        np.float32)
    (ref,) = vjp(stream._replace(inst=jnp.asarray(cot)))
    # the tolerance's scale: the largest running sum the reduction forms
    gid = np.asarray(stream.inst)[10]
    srt = cot[:10, np.argsort(gid, kind="stable")]
    tol = 64 * 2.0 ** -24 * np.abs(np.cumsum(srt, axis=1)).max()
    return feat, args, capacity, cot, np.asarray(ref), tol


@pytest.mark.parametrize("mode", ["serial", "batched", "pallas"])
def test_build_instances_backward_matches_jax(monkeypatch, stream_vjp,
                                              mode):
    monkeypatch.setenv("GPT_BWD_REDUCE", mode)
    feat, args, capacity, cot, ref, tol = stream_vjp
    tfeat = t(feat).requires_grad_(True)
    ours = TS.build_instances(tfeat, *[t(a) for a in args], GX, GY,
                              capacity)
    ours.inst.backward(t(cot))
    assert np.abs(ref).max() > 100 * tol
    np.testing.assert_allclose(n(tfeat.grad), ref, rtol=0, atol=tol)
    _, kept = TS.build_instances_fwd(t(feat), *[t(a) for a in args], GX, GY,
                                     capacity, with_kept=True)
    direct = TS.build_instances_bwd(ours.inst[10], kept, t(cot), mode=mode)
    assert torch.equal(direct, tfeat.grad)
