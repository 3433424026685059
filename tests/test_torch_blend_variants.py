"""Parity of the port's flat work-list and multi-tile blends
(ops/blend_variants.py; GPT_BLEND_FLAT, GPT_BLEND_MT) with its classic
blend and with the JAX package's same-variant paths.

- The work list equals the JAX _build_worklist bit for bit on crafted
  layouts (empty tiles, the last tile empty, a segment over many blocks,
  segments straddling block edges), and the flat kernels' ranges partition
  it at tile starts.
- Each pixel walks its tile's segment in order whatever the geometry, so
  the flat and multi-tile plain versions (TPB 1, 3, 4, 8) equal the classic
  plain versions bit for bit, forward and backward (every bit, signed zeros
  too): a fault in the work list or the window walk shows as a difference,
  not as noise.
- The port's render and its gradients under GPT_BLEND_FLAT=1 and under
  GPT_BLEND_MT=1, GPT_BLEND_TPB=4 are held to the JAX package's render
  under the same variable (eager, interpret mode: the JAX package reads
  the variables at trace time, so a cached jit of one variant would answer
  for another), with tests/test_torch_blend.py's tolerances: rgb and alpha
  2e-5, depth 2e-4, each gradient within 2e-4 of its largest magnitude.
  The JAX FLAT path itself differs from the JAX classic path by up to
  6.3e-7 in the render and 1.1e-5 relative in the gradients (its bf16-split
  MXU dots re-associate over another chunk partition).
- The variables' precedence (FLAT over SMT over MT), the SMT variant
  selected by GPT_BLEND_SMT > 1 (its own tests are in
  tests/test_torch_blend_smt.py), and a bad GPT_BLEND_TPB raising.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import (  # noqa: F401
    crafted_stream, n, one_torch_thread, t,
)

from gaussianprediction_tpu.data.synthetic import orbit_camera
from gaussianprediction_tpu.data.synthetic import random_gaussians
from gaussianprediction_tpu.ops import instance_stream as JS
from gaussianprediction_tpu.ops import projection as JP
from gaussianprediction_tpu.ops import rasterize as JRR
from gaussianprediction_tpu.ops import rasterize_pallas as JR
from gaussianprediction_tpu_torch.data.synthetic import (
    orbit_camera as torbit,
)
from gaussianprediction_tpu_torch.ops import blend_variants as BV
from gaussianprediction_tpu_torch.ops import rasterize_kernels as TR
from gaussianprediction_tpu_torch.ops.rasterize import render

W, H = 128, 112
GX, GY = 8, 7
VARS = ("GPT_BLEND_FLAT", "GPT_BLEND_SMT", "GPT_BLEND_MT", "GPT_BLEND_TPB")


@pytest.fixture(autouse=True)
def no_variant_env(monkeypatch):
    for k in VARS:
        monkeypatch.delenv(k, raising=False)


def _layouts():
    """(name, tile_start, tile_end, P) of crafted segment layouts."""
    def seq(counts, offset=0, tail=100):
        ends = offset + np.cumsum(counts)
        return ((ends - counts).astype(np.int32), ends.astype(np.int32),
                int(ends[-1]) + tail)

    rng = np.random.default_rng(0)
    rand = rng.integers(0, 600, 40)
    rand[[0, 7, 8, 38, 39]] = 0
    return [
        ("empty_tiles", *seq([0, 300, 0, 0, 700, 256, 1, 513, 0, 255, 257,
                              1000, 0, 40, 0])),
        ("many_blocks", *seq([5, 3000, 7], offset=130)),
        ("straddling", *seq([250, 10, 250, 10, 250, 10], offset=3)),
        ("all_empty", *seq([0, 0, 0, 0], offset=50)),
        ("random", *seq(rand, offset=17, tail=0)),
    ]


@pytest.mark.parametrize("layout", _layouts(), ids=lambda x: x[0])
def test_worklist_matches_jax(layout):
    _, ts, te, P = layout
    nblocks = -(-P // 256)
    ref = JR._build_worklist(jnp.asarray(ts), jnp.asarray(te), 256, nblocks)
    ours = BV.build_worklist(t(ts), t(te), 256, nblocks)
    for name, a, b in zip(("wt", "woff", "ft", "nwork"), ours, ref):
        assert a.dtype == torch.int32, name
        np.testing.assert_array_equal(n(a), np.asarray(b), err_msg=name)
    _, woff, ft, nwork = ours
    T, nw = ts.shape[0], int(nwork)
    first = np.append(n(ft), nw)
    nitems = np.diff(first)
    for R in (1, 3, 7, 1000):
        cut = n(BV.flat_ranges(ft, nwork, R))
        assert cut.shape == (R + 1,) and cut[0] == 0 and cut[-1] == T
        assert (np.diff(cut) >= 0).all()
        per = -(-nw // R)
        items = first[cut[1:]] - first[cut[:-1]]
        assert items.sum() == nw
        assert (items <= per + max(int(nitems.max()), 1) - 1).all()


def _stream(num, seed, opacity_boost=0.0):
    """The JAX package's instance stream of a random scene, as numpy."""
    g = random_gaussians(num, seed=seed, scale_range=(-5.0, -3.0))
    op = 1.0 / (1.0 + np.exp(-(g["opacity_logit"][:, 0] + opacity_boost)))
    cam = orbit_camera(0.5, width=W, height=H).to_device_dict()
    q = g["rotation"] / np.linalg.norm(g["rotation"], axis=-1, keepdims=True)
    proj = JP.project_from_params(
        jnp.asarray(g["xyz"]), jnp.asarray(np.exp(g["log_scales"])),
        jnp.asarray(q), cam, W, H, opacity=jnp.asarray(op, jnp.float32))
    feat = jnp.concatenate(
        [proj.mean2d, proj.conic, jnp.asarray(op, jnp.float32)[:, None],
         jnp.asarray(g["colors"]), proj.depth[:, None]], axis=-1)
    stream, _ = JS.build_instances_fwd(
        feat, proj.depth, proj.tiles_min, proj.tiles_max, proj.visible, GX,
        GY, 12 * num, 1024, interpret=True)
    assert int(stream.n_dropped) == 0
    return (np.asarray(stream.inst), np.asarray(stream.tile_start),
            np.asarray(stream.tile_end))


def _bits(x):
    return n(x).view(np.int32)


@pytest.mark.parametrize("case", ["sparse", "dense_occlusion", "saturated"])
def test_plain_variants_equal_classic_bit_for_bit(case):
    if case == "saturated":     # crafted: most tiles' pixels all latch
        counts = np.random.default_rng(0).integers(0, 300, GX * GY)
        counts[[3, 17, GX * GY - 1]] = 0
        inst, ts, te = crafted_stream(counts, GX, 1, sigma=(2.0, 6.0),
                                      opacity=(0.3, 0.99))
    else:
        inst, ts, te = _stream(1500, 1, 4.0 if case == "dense_occlusion"
                               else 0.0)
    args = (t(inst), t(ts), t(te), GX, GY)
    aux = {}
    ref = TR.rasterize_binned_plain(*args, True, aux=aux)
    if case == "saturated":     # the walks stop early in many tiles
        assert aux["instances"] < 0.8 * int((te - ts).sum())
    cot = torch.randn(ref.shape, generator=torch.Generator().manual_seed(3))
    dpix = TR.pixel_grads(ref, cot)
    dref = TR.rasterize_binned_bwd_plain(*args, dpix)
    assert dref[:10].abs().amax(dim=1).min() > 0
    out = BV.rasterize_binned_flat_plain(*args, True)
    np.testing.assert_array_equal(_bits(out), _bits(ref))
    np.testing.assert_array_equal(
        _bits(BV.rasterize_binned_bwd_flat_plain(*args, dpix)), _bits(dref))
    for tpb in (1, 3, 4, 8):
        out = BV.rasterize_binned_mt_plain(*args, tpb, True)
        np.testing.assert_array_equal(_bits(out), _bits(ref),
                                      err_msg=f"tpb {tpb}")
        np.testing.assert_array_equal(
            _bits(BV.rasterize_binned_bwd_mt_plain(*args, tpb, dpix)),
            _bits(dref), err_msg=f"tpb {tpb}")


def _render_case():
    """tests/test_rasterizer.py's TestMultiTileBlend scene at 64x48."""
    Wr, Hr = 64, 48
    g = random_gaussians(220, seed=3, scale_range=(-3.6, -2.2))
    op = (1.0 / (1.0 + np.exp(-(g["opacity_logit"] + 2.0)))).astype(
        np.float32)
    target = np.random.default_rng(5).uniform(0, 1, (Hr, Wr, 3)).astype(
        np.float32)
    args = [g["xyz"], g["log_scales"], g["rotation"], op, g["colors"]]
    return Wr, Hr, args, target


def _jax_render(Wr, Hr, args, target):
    cam = orbit_camera(0.4, width=Wr, height=Hr, uid=0).to_device_dict()
    bg = jnp.asarray([0.1, 0.2, 0.3])

    def loss(xyz, log_s, rot, op, col):
        out = JRR.render(xyz, jnp.exp(log_s), rot, op[:, 0], None, cam, Wr,
                         Hr, bg, colors_precomp=col, interpret=True)
        return (jnp.mean((out["render"] - target) ** 2)
                + 0.1 * jnp.mean(out["depth"]), out)

    (_, out), grads = jax.value_and_grad(
        loss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
            *[jnp.asarray(a) for a in args])
    return out, grads


def _port_render(Wr, Hr, args, target):
    cam = torbit(0.4, width=Wr, height=Hr, uid=0).to_device_dict("cpu")
    targs = [t(a).requires_grad_(True) for a in args]
    xyz, log_s, rot, op, col = targs
    out = render(xyz, torch.exp(log_s), rot, op[:, 0], None, cam, Wr, Hr,
                 torch.tensor([0.1, 0.2, 0.3]), colors_precomp=col)
    loss = torch.mean((out["render"] - t(target)) ** 2) + \
        0.1 * torch.mean(out["depth"])
    loss.backward()
    return out, [a.grad for a in targs]


@pytest.mark.parametrize("env", [{"GPT_BLEND_FLAT": "1"},
                                 {"GPT_BLEND_MT": "1", "GPT_BLEND_TPB": "4"}],
                         ids=["flat", "mt4"])
def test_render_and_gradients_match_jax_variant(env, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    Wr, Hr, args, target = _render_case()
    ref, rgrads = _jax_render(Wr, Hr, args, target)
    kind = "flat" if "GPT_BLEND_FLAT" in env else "mt"
    seen = []
    orig = BV.rasterize_binned_bwd_flat if kind == "flat" else \
        BV.rasterize_binned_bwd_mt
    monkeypatch.setattr(
        BV, orig.__name__,
        lambda *a, **k: seen.append(a) or orig(*a, **k))
    ours, grads = _port_render(Wr, Hr, args, target)
    assert len(seen) == 1                 # the variant's backward ran
    assert int(ours["n_dropped"]) == 0
    for key, tol in (("render", 2e-5), ("alpha", 2e-5), ("depth", 2e-4)):
        np.testing.assert_allclose(n(ours[key]), np.asarray(ref[key]),
                                   atol=tol, rtol=0, err_msg=key)
    names = ["xyz", "log_scales", "rotation", "opacity", "colors"]
    for name, a, b in zip(names, grads, rgrads):
        scale = max(np.abs(np.asarray(b)).max(), 1e-6)
        np.testing.assert_allclose(n(a), np.asarray(b), rtol=0,
                                   atol=2e-4 * scale + 1e-8, err_msg=name)


@pytest.mark.parametrize("env,want", [
    ({}, ("classic", None)),
    ({"GPT_BLEND_SMT": "1"}, ("classic", None)),
    ({"GPT_BLEND_FLAT": "1"}, ("flat", None)),
    ({"GPT_BLEND_FLAT": "1", "GPT_BLEND_SMT": "4", "GPT_BLEND_MT": "1"},
     ("flat", None)),
    ({"GPT_BLEND_MT": "1"}, ("mt", 4)),
    ({"GPT_BLEND_MT": "1", "GPT_BLEND_TPB": "3"}, ("mt", 3)),
    ({"GPT_BLEND_MT": "0", "GPT_BLEND_TPB": "0"}, ("classic", None)),
    ({"GPT_BLEND_SMT": "4", "GPT_BLEND_MT": "1"}, ("smt", 4)),
    ({"GPT_BLEND_SMT": "2"}, ("smt", 2)),
    ({"GPT_BLEND_MT": "1", "GPT_BLEND_TPB": "0"}, ValueError),
    ({"GPT_BLEND_MT": "1", "GPT_BLEND_TPB": "two"}, ValueError),
    ({"GPT_BLEND_SMT": "x"}, ValueError),
], ids=lambda x: ("-".join(f"{k[10:]}={v}" for k, v in x.items())
                  or "unset") if isinstance(x, dict) else None)
def test_variant_selection(env, want, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if isinstance(want, type):
        with pytest.raises(want):
            TR.blend_variant()
        return
    assert tuple(TR.blend_variant()) == want


def test_smt_raises_and_backward_keeps_forward_variant(monkeypatch):
    """GPT_BLEND_SMT > 1 once raised; it now selects the SMT blend, which
    gives the classic bits. The backward keeps the forward's variant."""
    counts = [300, 0, 41, 600]
    inst, ts, te = crafted_stream(counts, 2, 2)
    args = (t(inst), t(ts), t(te), 2, 2)
    monkeypatch.setenv("GPT_BLEND_SMT", "4")
    np.testing.assert_array_equal(
        _bits(TR.rasterize_binned(*args)),
        _bits(TR.rasterize_binned(*args, variant=TR.CLASSIC)))
    monkeypatch.delenv("GPT_BLEND_SMT")
    monkeypatch.setenv("GPT_BLEND_MT", "1")
    x = args[0].clone().requires_grad_(True)
    out = TR.RasterizeBinned.apply(x, *args[1:], False)
    monkeypatch.setenv("GPT_BLEND_SMT", "4")   # read by forward only
    out[..., :4].sum().backward()
    dpix = TR.pixel_grads(out.detach(), torch.cat(
        [torch.ones_like(out[..., :4]), torch.zeros_like(out[..., 4:])], -1))
    ref = TR.rasterize_binned_bwd(*args, dpix, TR.CLASSIC)
    np.testing.assert_array_equal(_bits(x.grad), _bits(ref))
    with pytest.raises(ValueError):
        BV.rasterize_binned_mt(*args, 0)
