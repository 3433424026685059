"""Parity of the port's classic render path (ops/binning.py,
render(fast_binning=False)) and of render's cov3d_precomp and
tight_rects=False with the JAX package, and the port's binning path
against its own fast path.

- bin_gaussians on one projection (the JAX package's, so both sides get
  equal floats; a few visible Gaussians share a depth, two of them -0.0
  and +0.0 apart): gauss_id, tile_id, tile_start, tile_end, n_instances
  and n_dropped equal, for align 1 and 128, sized and with drops.
- render(fast_binning=False), render(cov3d_precomp=...) and
  render(tight_rects=False) at 64x40 (220 Gaussians, the variant tests'
  scene): images within 2e-5 (depth 2e-4) and the gradients of
  mean((render - target)^2) + 0.1 mean(depth) within 2e-4 of each
  gradient's largest magnitude of the JAX render's (eager, interpret
  mode), the tolerances of tests/test_torch_render.py.
- In the port, the binning path equals the fast path bit for bit in every
  output and every gradient: with no drops and distinct depths both order
  each tile's instances by depth with ties by Gaussian index, the blend
  sees the same columns, and the reduction sorts each Gaussian's slots by
  gid into the same order behind a prefix of zero cotangents (padding and
  empty slots), so even the cumsum differences keep their bits here: the
  CPU's row-wise cumsum adds in order, and zeros change no partial sum.
  (On the card the row-wise scan associates by position, and the two
  prefixes differ in length: there the per-Gaussian sums agree within the
  scan's roundoff, which chip_smoke.py's classic-path phase holds.)
- cov3d_precomp built from the same scales and rotations renders the
  render's bits; GPT_ELLIPSE_CULL=1 gives the uncut render's bits and
  gradients.
- The blend variants on a binning stream (segments CHUNK-aligned and not
  contiguous, tile_end[t] < tile_start[t + 1]): the JAX package's MT and
  FLAT kernels (interpret mode) give its classic kernel's forward bit for
  bit there, FLAT its backward too and MT its backward within roundoff
  (the MT backward sums in another order on any layout); the port's
  plain variants give its classic plain versions' bits. The layout
  changes no variant's result in either package.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import n, one_torch_thread, t  # noqa: F401

from gaussianprediction_tpu.data.synthetic import orbit_camera
from gaussianprediction_tpu.data.synthetic import random_gaussians
from gaussianprediction_tpu.ops import binning as JB
from gaussianprediction_tpu.ops import projection as JP
from gaussianprediction_tpu.ops import rasterize as JRR
from gaussianprediction_tpu.ops import rasterize_pallas as JR
from gaussianprediction_tpu_torch.data.synthetic import (
    orbit_camera as torbit,
)
from gaussianprediction_tpu_torch.ops import binning as TB
from gaussianprediction_tpu_torch.ops import blend_variants as BV
from gaussianprediction_tpu_torch.ops import projection as TP
from gaussianprediction_tpu_torch.ops import rasterize_kernels as rk
from gaussianprediction_tpu_torch.ops.rasterize import render

W, H = 64, 40
GX, GY = 4, 3
BG = np.array([0.1, 0.2, 0.3], np.float32)
VARS = ("GPT_BLEND_FLAT", "GPT_BLEND_SMT", "GPT_BLEND_MT", "GPT_BLEND_TPB",
        "GPT_ELLIPSE_CULL")


@pytest.fixture(autouse=True)
def _no_variant(monkeypatch):
    for k in VARS:
        monkeypatch.delenv(k, raising=False)


def _scene():
    g = random_gaussians(220, seed=3, scale_range=(-3.6, -2.2))
    op = (1.0 / (1.0 + np.exp(-(g["opacity_logit"][:, 0] + 2.0)))).astype(
        np.float32)
    q = g["rotation"] / np.linalg.norm(g["rotation"], axis=-1, keepdims=True)
    target = np.random.default_rng(5).uniform(0, 1, (H, W, 3)).astype(
        np.float32)
    return dict(xyz=g["xyz"], log_s=g["log_scales"], rot=q.astype(
        np.float32), op=op, col=g["colors"]), target


def _jcam():
    return orbit_camera(0.4, width=W, height=H, uid=0).to_device_dict()


def _tcam():
    return torbit(0.4, width=W, height=H, uid=0).to_device_dict("cpu")


def _projection():
    """The JAX projection of the scene, with tied depths among visible
    Gaussians (-0.0 / +0.0 apart too, on invisible rows)."""
    g, _ = _scene()
    proj = JP.project_from_params(
        jnp.asarray(g["xyz"]), jnp.exp(jnp.asarray(g["log_s"])),
        jnp.asarray(g["rot"]), _jcam(), W, H, opacity=jnp.asarray(g["op"]))
    depth = np.array(proj.depth)
    vis = np.flatnonzero(np.asarray(proj.visible))
    depth[vis[10:20]] = depth[vis[0]]
    depth[vis[30]] = depth[vis[31]]
    hidden = np.flatnonzero(~np.asarray(proj.visible))
    if hidden.size >= 2:
        depth[hidden[0]], depth[hidden[1]] = -0.0, 0.0
    return proj._replace(depth=jnp.asarray(depth))


@pytest.mark.parametrize("align", [1, 128])
@pytest.mark.parametrize("sized", [True, False], ids=["sized", "drops"])
def test_bin_gaussians_matches_jax(align, sized):
    proj = _projection()
    need = int(JB.bin_gaussians(proj, W, H, 1 << 16, align=align)
               .n_dropped) == 0
    assert need
    capacity = 1 << 14 if sized else (1024 if align > 1 else 256)
    ref = JB.bin_gaussians(proj, W, H, capacity, align=align)
    tproj = TP.Projected(*[t(x) for x in proj])
    ours = TB.bin_gaussians(tproj, W, H, capacity, align=align)
    assert (int(ref.n_dropped) == 0) == sized
    for name in ref._fields:
        a, b = n(getattr(ours, name)), np.asarray(getattr(ref, name))
        assert a.dtype == np.int32, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    if align > 1:
        ts, te = n(ours.tile_start), n(ours.tile_end)
        assert (ts % align == 0).all()
        assert (te[:-1] <= ts[1:]).all() and (te[:-1] < ts[1:]).any()


def _jax_render(**kw):
    g, target = _scene()
    cam = _jcam()
    cov = kw.pop("cov", False)

    def loss(xyz, log_s, rot, op, col):
        s = jnp.exp(log_s)
        extra = {}
        if cov:
            from gaussianprediction_tpu.ops.projection import (
                covariance_from_scaling_rotation,
            )
            extra["cov3d_precomp"] = covariance_from_scaling_rotation(
                s, rot / jnp.linalg.norm(rot, axis=-1, keepdims=True))
        out = JRR.render(xyz, s, rot, op, None, cam, W, H,
                         jnp.asarray(BG), colors_precomp=col,
                         interpret=True, capacity_multiplier=24,
                         **extra, **kw)
        return (jnp.mean((out["render"] - target) ** 2)
                + 0.1 * jnp.mean(out["depth"]), out)

    (_, out), grads = jax.value_and_grad(
        loss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
            *[jnp.asarray(g[k]) for k in ("xyz", "log_s", "rot", "op",
                                          "col")])
    return out, grads


def _port_render(**kw):
    g, target = _scene()
    targs = [t(g[k]).requires_grad_(True)
             for k in ("xyz", "log_s", "rot", "op", "col")]
    xyz, log_s, rot, op, col = targs
    s = torch.exp(log_s)
    if kw.pop("cov", False):
        kw["cov3d_precomp"] = TP.covariance_from_scaling_rotation(
            s, rot / torch.linalg.norm(rot, dim=-1, keepdim=True))
    out = render(xyz, s, rot, op, None, _tcam(), W, H, t(BG),
                 colors_precomp=col, capacity_multiplier=24, **kw)
    loss = torch.mean((out["render"] - t(target)) ** 2) + \
        0.1 * torch.mean(out["depth"])
    loss.backward()
    return out, [a.grad for a in targs]


CASES = {"binning": {"fast_binning": False}, "cov3d": {"cov": True},
         "loose_rects": {"tight_rects": False}}


@pytest.mark.parametrize("case", sorted(CASES))
def test_render_and_gradients_match_jax(case):
    ref, rgrads = _jax_render(**CASES[case])
    ours, grads = _port_render(**CASES[case])
    assert int(ours["n_dropped"]) == int(ref["n_dropped"]) == 0
    assert int(ours["n_instances"]) == int(ref["n_instances"])
    np.testing.assert_array_equal(n(ours["radii"]), np.asarray(ref["radii"]))
    for key, tol in (("render", 2e-5), ("alpha", 2e-5), ("depth", 2e-4)):
        np.testing.assert_allclose(n(ours[key]), np.asarray(ref[key]),
                                   atol=tol, rtol=0, err_msg=key)
    names = ["xyz", "log_scales", "rotation", "opacity", "colors"]
    for name, a, b in zip(names, grads, rgrads):
        scale = np.abs(np.asarray(b)).max()
        assert scale > 0, name
        np.testing.assert_allclose(n(a), np.asarray(b), rtol=0,
                                   atol=2e-4 * scale, err_msg=name)


def _bits(x):
    return x.detach().contiguous().view(torch.int32)


@pytest.mark.parametrize("case", ["binning", "cov3d", "cull"])
def test_port_paths_equal_the_fast_path_bit_for_bit(case, monkeypatch):
    ref, rgrads = _port_render()
    if case == "cull":
        monkeypatch.setenv("GPT_ELLIPSE_CULL", "1")
    ours, grads = _port_render(**CASES.get(case, {}))
    for key in ("render", "depth", "alpha"):
        assert torch.equal(_bits(ours[key]), _bits(ref[key])), key
    assert torch.equal(ours["tidx"], ref["tidx"])
    for a, b in zip(grads, rgrads):
        if case == "cov3d":
            continue            # the gradient reaches another input
        assert torch.equal(_bits(a), _bits(b))


def _binning_stream():
    """A JAX binning stream of the scene (the render's layout): instT,
    tile_start, tile_end, and a random pixel cotangent."""
    g, _ = _scene()
    proj = JP.project_from_params(
        jnp.asarray(g["xyz"]), jnp.exp(jnp.asarray(g["log_s"])),
        jnp.asarray(g["rot"]), _jcam(), W, H, opacity=jnp.asarray(g["op"]))
    bins = JB.bin_gaussians(proj, W, H, 24 * 220 // 128 * 128,
                             align=JR.CHUNK)
    gid = np.maximum(np.asarray(bins.gauss_id), 0)
    valid = (np.asarray(bins.gauss_id) >= 0).astype(np.float32)
    feat = np.concatenate(
        [np.asarray(proj.mean2d), np.asarray(proj.conic), g["op"][:, None],
         g["col"], np.asarray(proj.depth)[:, None]], axis=-1)
    inst = np.concatenate(
        [feat[gid].T * valid, np.asarray(bins.gauss_id,
                                         np.float32)[None], valid[None],
         np.zeros((4, gid.size), np.float32)], axis=0).astype(np.float32)
    ts, te = np.asarray(bins.tile_start), np.asarray(bins.tile_end)
    assert (te[:-1] < ts[1:]).any()         # not contiguous
    cot = np.random.default_rng(9).normal(size=(GX * GY, 256, 8)).astype(
        np.float32)
    return np.ascontiguousarray(inst), ts, te, cot


def _jax_blend(inst, ts, te, cot):
    out, vjp = jax.vjp(
        lambda x: JR.rasterize_binned(x, jnp.asarray(ts), jnp.asarray(te),
                                      GX, GY, True, True), jnp.asarray(inst))
    (d,) = vjp(jnp.asarray(cot))
    return np.asarray(out), np.asarray(d)


def test_variants_on_a_binning_stream(monkeypatch):
    inst, ts, te, cot = _binning_stream()
    ref_out, ref_d = _jax_blend(inst, ts, te, cot)
    for env in ({"GPT_BLEND_MT": "1", "GPT_BLEND_TPB": "4"},
                {"GPT_BLEND_FLAT": "1"}):
        with monkeypatch.context() as mp:
            for k, v in env.items():
                mp.setenv(k, v)
            out, d = _jax_blend(inst, ts, te, cot)
        # what the reference does there: its classic kernel's forward bit
        # for bit, and its backward on every segment column (the padding
        # columns' gradient is never read): FLAT's bit for bit, MT's within
        # roundoff (its kernel sums the pixels in another order, on a
        # contiguous stream too: 4.8e-7 at most here on both layouts)
        np.testing.assert_array_equal(out, ref_out, err_msg=str(env))
        cols = np.concatenate([np.arange(a, b) for a, b in zip(ts, te)])
        if "GPT_BLEND_FLAT" in env:
            np.testing.assert_array_equal(d[:, cols], ref_d[:, cols])
        else:
            np.testing.assert_allclose(
                d[:, cols], ref_d[:, cols], rtol=0,
                atol=2e-6 * np.abs(ref_d).max())
    args = (t(inst), t(ts), t(te), GX, GY)
    dpix = rk.pixel_grads(rk.rasterize_binned_plain(*args), t(cot))
    fwd = _bits(rk.rasterize_binned_plain(*args))
    bwd = _bits(rk.rasterize_binned_bwd_plain(*args, dpix))
    for name, f, b in (
            ("flat", BV.rasterize_binned_flat_plain(*args),
             BV.rasterize_binned_bwd_flat_plain(*args, dpix)),
            ("mt4", BV.rasterize_binned_mt_plain(*args, 4),
             BV.rasterize_binned_bwd_mt_plain(*args, 4, dpix)),
            ("mt3", BV.rasterize_binned_mt_plain(*args, 3),
             BV.rasterize_binned_bwd_mt_plain(*args, 3, dpix)),
            ("smt4", BV.rasterize_binned_smt_plain(*args, 4),
             BV.rasterize_binned_bwd_smt_plain(*args, 4, dpix))):
        assert torch.equal(_bits(f), fwd), name
        assert torch.equal(_bits(b), bwd), name
    # and the port's classic blend against the JAX classic kernel
    ours = n(rk.rasterize_binned_plain(*args))
    for c, tol in ((rk.O_R, 2e-5), (rk.O_G, 2e-5), (rk.O_B, 2e-5),
                   (rk.O_Z, 2e-4), (rk.O_T, 2e-5)):
        np.testing.assert_allclose(ours[..., c], ref_out[..., c], atol=tol,
                                   rtol=0)
