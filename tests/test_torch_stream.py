"""Parity of the port's instance stream (ops/instance_stream.py) with
gaussianprediction_tpu/ops/instance_stream.py:build_instances_fwd.

The same projected scene (from the JAX package, so both sides get equal
floats) goes through both. Held exactly: tile_start, tile_end, n_dropped,
n_total, and the sorted [16, P] stream inside every tile segment (the
(tile, depth) order and every channel, bit for bit). Past the segments
lie the invalid slots, whose order is not part of the contract. Covered:
a stream sized for zero drops, a capacity overflow (n_dropped > 0), rect
capping (max_tiles small enough to cap) and GPT_ELLIPSE_CULL=1 (the same
pairs culled as the JAX package culls, and the blend of the culled stream
equal bit for bit to the uncut one's; the backward's (gid, emitted slot)
order of the culled stream's columns the uncut stream's order).

The backward (the per-Gaussian reduction of the instance cotangent) is
held to the JAX package's reduction (its custom VJP's build_instances_bwd)
on the port's stream in all three GPT_BWD_REDUCE modes, sized and
overflowing, within 64 * 2^-24 of the largest running sum |cumsum| of the
sorted cotangent: both take differences of f32 prefix sums, which XLA and
PyTorch associate differently. A Gaussian whose capped rect has width but
no height is found in the reference: the JAX stream emits it a phantom
instance, the port none (test_zero_height_rect_holds_no_instance).
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
from gaussianprediction_tpu_torch.ops import rasterize_kernels as rk

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


@pytest.mark.parametrize("case", ["sized", "overflow", "capped", "cull"])
def test_build_instances_matches_jax(case, monkeypatch):
    scale = (-3.6, -2.4) if case in ("capped", "cull") else (-5.0, -3.0)
    _, _, _, proj, feat = _projected(scale_range=scale)
    max_tiles = 4 if case == "capped" else 1024
    capacity = 1024 if case == "overflow" else 8 * 2000
    if case == "cull":
        uncut, _, slot_u = TS.build_instances_fwd(
            t(feat), t(proj.tiles_min), t(proj.tiles_max), t(proj.visible),
            GX, GY, capacity, max_tiles, with_kept=True)
        # both packages read the switch at the call (JAX: at the trace)
        monkeypatch.setenv("GPT_ELLIPSE_CULL", "1")
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
    if case in ("sized", "cull"):
        assert int(ref.n_dropped) == 0
    else:
        assert int(ref.n_dropped) > 0
    if case == "cull":
        # the cull drops pairs from the segments, never a whole Gaussian's
        # pixels: the blend gives the uncut stream's bits
        kept = int((ours.tile_end - ours.tile_start).sum())
        total = int((uncut.tile_end - uncut.tile_start).sum())
        assert 0 < kept < total
        a = rk.rasterize_binned(ours.inst, ours.tile_start, ours.tile_end,
                                GX, GY)
        b = rk.rasterize_binned(uncut.inst, uncut.tile_start,
                                uncut.tile_end, GX, GY)
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        # the backward's order: sorted by (gid, emitted slot), the culled
        # stream's columns line up with the uncut stream's stable gid sort
        # (itself the (gid, slot) order), so every sum sees the same
        # operands in the same places
        _, _, slot_c = TS.build_instances_fwd(
            t(feat), t(proj.tiles_min), t(proj.tiles_max), t(proj.visible),
            GX, GY, capacity, max_tiles, with_kept=True)
        gid_u = uncut.inst[10].to(torch.int64)
        gid_c = ours.inst[10].to(torch.int64)
        ord_u = torch.sort(gid_u.to(torch.int32), stable=True).indices
        assert torch.equal(torch.sort(((gid_u + 1) << 32) | slot_u).indices,
                           ord_u)
        ord_c = torch.sort(((gid_c + 1) << 32) | slot_c).indices
        assert torch.equal(gid_c[ord_c], gid_u[ord_u])
        assert torch.equal(slot_c[ord_c], slot_u[ord_u])
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
    """The JAX package's reduction (build_instances_bwd, its default mode)
    of one random cotangent on the port's stream, shared by the port's
    three modes. The JAX package's own stream of this scene holds one
    phantom instance (test_zero_height_rect_holds_no_instance), which
    misaligns its VJP's runs; its reduction is held on the stream both
    packages agree the scene has."""
    _, _, _, proj, feat = _projected()
    capacity = 1024 if request.param == "overflow" else 8 * 2000
    args = (proj.tiles_min, proj.tiles_max, proj.visible)
    stream, kept, _ = TS.build_instances_fwd(
        t(feat), *[t(a) for a in args], GX, GY, capacity, with_kept=True)
    assert (int(stream.n_dropped) > 0) == (request.param == "overflow")
    cot = np.random.default_rng(8).normal(size=stream.inst.shape).astype(
        np.float32)
    (ref,) = JS.build_instances_bwd(
        (jnp.asarray(n(stream.inst[10])), jnp.asarray(n(kept)), feat.shape),
        jnp.asarray(cot))
    # the tolerance's scale: the largest running sum the reduction forms
    gid = n(stream.inst[10])
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
    _, kept, _ = TS.build_instances_fwd(t(feat), *[t(a) for a in args],
                                        GX, GY, capacity, with_kept=True)
    direct = TS.build_instances_bwd(ours.inst[10], kept, t(cot), mode=mode)
    assert torch.equal(direct, tfeat.grad)


def test_zero_height_rect_holds_no_instance():
    """Found in the reference: a visible Gaussian whose capped rect has
    width but no height (rw > 0, rh == 0: a tight rect clipped away at an
    image edge) owns no instance, but the JAX package's expand emit flags
    empty Gaussians by rw == 0 alone, so it emits that Gaussian's
    singleton slot as a real instance of tile (x0, y0): a gid that no
    kept count holds. Where (x0, y0) is a tile of the image, the tile's
    instances shift by one slot against its counted bounds; and the
    backward's run boundaries (the kept counts behind a negative prefix
    of P - sum(kept) columns) all misalign, so the per-Gaussian gradients
    are other Gaussians' sums. The port emits the slot invalid: its stream
    is the stream without those Gaussians, and its backward gives each
    Gaussian the sum of its own columns (a float64 oracle), within the
    reduction's roundoff; the JAX VJP does not."""
    _, _, _, proj, feat = _projected()
    tmin, tmax = np.array(proj.tiles_min), np.array(proj.tiles_max)
    vis = np.array(proj.visible)
    cand = np.flatnonzero(vis & (tmax[:, 1] > tmin[:, 1])
                          & (tmax[:, 0] > tmin[:, 0]))[:6]
    tmax[cand, 1] = tmin[cand, 1]          # zero height, real rows
    capacity = 8 * 2000
    jargs = (jnp.asarray(tmin), jnp.asarray(tmax), proj.visible)
    _, (jgid, jkept, _) = JS.build_instances_fwd(
        feat, proj.depth, *jargs, GX, GY, capacity, 1024, interpret=True)
    # the scene has one such Gaussian of its own, past the last tile row
    _, _, rw, rh = TS._capped_rect(t(tmin), t(tmax), t(feat)[:, 0:2], 1024)
    phantoms = int((t(vis) & (rw > 0) & (rh == 0)).sum())
    assert phantoms > len(cand)
    assert int((np.asarray(jgid) >= 0).sum()) == \
        int(np.asarray(jkept).sum()) + phantoms
    ours, kept, _ = TS.build_instances_fwd(
        t(feat), t(tmin), t(tmax), t(vis), GX, GY, capacity, with_kept=True)
    gid = ours.inst[10]
    assert int((gid >= 0).sum()) == int(kept.sum())
    np.testing.assert_array_equal(n(kept), np.asarray(jkept))
    hidden = vis.copy()
    hidden[cand] = False
    alt = TS.build_instances_fwd(t(feat), t(tmin), t(tmax), t(hidden), GX,
                                 GY, capacity)
    assert torch.equal(ours.tile_start, alt.tile_start)
    assert torch.equal(ours.tile_end, alt.tile_end)
    cols = torch.cat([torch.arange(int(a), int(b)) for a, b in
                      zip(ours.tile_start, ours.tile_end)])
    assert torch.equal(ours.inst[:, cols], alt.inst[:, cols])
    # the backward against a float64 oracle: each Gaussian's columns summed
    cot = np.random.default_rng(9).normal(size=ours.inst.shape).astype(
        np.float32)
    g = n(gid).astype(np.int64)
    oracle = np.zeros((feat.shape[0], 10))
    np.add.at(oracle, g[g >= 0], cot[:10, g >= 0].T.astype(np.float64))
    srt = cot[:10, np.argsort(g, kind="stable")]
    tol = 64 * 2.0 ** -24 * np.abs(np.cumsum(srt, axis=1)).max()
    ours_d = n(TS.build_instances_bwd(gid, kept, t(cot)))
    np.testing.assert_allclose(ours_d, oracle, rtol=0, atol=tol)
    stream, vjp = jax.vjp(
        lambda f: JS.build_instances(f, proj.depth, *jargs, GX, GY,
                                     capacity, 1024, True), feat)
    jcot = np.random.default_rng(9).normal(size=stream.inst.shape).astype(
        np.float32)
    jg = np.asarray(stream.inst)[10].astype(np.int64)
    joracle = np.zeros((feat.shape[0], 10))
    np.add.at(joracle, jg[jg >= 0], jcot[:10, jg >= 0].T.astype(np.float64))
    (jd,) = vjp(stream._replace(inst=jnp.asarray(jcot)))
    assert np.abs(np.asarray(jd) - joracle).max() > 100 * tol
