"""Parity of the port's SMT blend (GPT_BLEND_SMT; ops/blend_variants.py:
one program per smt consecutive tiles, walked one after another) with its
classic blend and with the JAX package's SMT path.

- Each pixel walks its own tile's segment in order from a fresh state
  whatever the geometry, so the SMT plain versions at SMT 2, 3, 4 and 8
  equal the classic plain versions bit for bit, forward and backward (int32
  views: every bit, signed zeros too), on a sparse and a dense-occlusion
  stream of 7 x 7 = 49 tiles, a count that no SMT here divides (the last
  program owns fewer tiles).
- The port's render and its gradients under GPT_BLEND_SMT=4 are held to
  the JAX package's render under the same variable (eager, interpret mode:
  the JAX package reads the variable at trace time) with
  tests/test_torch_blend.py's tolerances: rgb and alpha 2e-5, depth 2e-4,
  each gradient within 2e-4 of its largest magnitude.
- blend_variant: GPT_BLEND_SMT=n selects SMT with n tiles per program
  where n > 1; n <= 1 is off; a non-integer raises; FLAT takes precedence
  over SMT and SMT over MT.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import n, one_torch_thread, t  # noqa: F401

from gaussianprediction_tpu.data.synthetic import orbit_camera
from gaussianprediction_tpu.data.synthetic import random_gaussians
from gaussianprediction_tpu.ops import instance_stream as JS
from gaussianprediction_tpu.ops import projection as JP
from gaussianprediction_tpu.ops import rasterize as JRR
from gaussianprediction_tpu_torch.data.synthetic import (
    orbit_camera as torbit,
)
from gaussianprediction_tpu_torch.ops import blend_variants as BV
from gaussianprediction_tpu_torch.ops import rasterize_kernels as TR
from gaussianprediction_tpu_torch.ops.rasterize import render

W, H = 112, 112
GX, GY = 7, 7
VARS = ("GPT_BLEND_FLAT", "GPT_BLEND_SMT", "GPT_BLEND_MT", "GPT_BLEND_TPB")


@pytest.fixture(autouse=True)
def no_variant_env(monkeypatch):
    for k in VARS:
        monkeypatch.delenv(k, raising=False)


def _stream(num, seed, opacity_boost):
    """The JAX package's instance stream of a random scene, as numpy."""
    g = random_gaussians(num, seed=seed, scale_range=(-5.0, -3.0))
    op = 1.0 / (1.0 + np.exp(-(g["opacity_logit"][:, 0] + opacity_boost)))
    cam = orbit_camera(0.7, width=W, height=H).to_device_dict()
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


@pytest.mark.parametrize("case", ["sparse", "dense_occlusion"])
def test_plain_smt_equals_classic_bit_for_bit(case):
    inst, ts, te = _stream(1200, 2, 4.0 if case == "dense_occlusion"
                           else 0.0)
    assert (te > ts).sum() > GX * GY // 2
    args = (t(inst), t(ts), t(te), GX, GY)
    ref = TR.rasterize_binned_plain(*args, True)
    cot = torch.randn(ref.shape, generator=torch.Generator().manual_seed(4))
    dpix = TR.pixel_grads(ref, cot)
    dref = TR.rasterize_binned_bwd_plain(*args, dpix)
    assert dref[:10].abs().amax(dim=1).min() > 0
    for smt in (2, 3, 4, 8):
        assert GX * GY % smt != 0
        out = BV.rasterize_binned_smt_plain(*args, smt, True)
        np.testing.assert_array_equal(_bits(out), _bits(ref),
                                      err_msg=f"smt {smt}")
        np.testing.assert_array_equal(
            _bits(BV.rasterize_binned_bwd_smt_plain(*args, smt, dpix)),
            _bits(dref), err_msg=f"smt {smt}")


def test_smt_schedule_walks_each_program_in_turn():
    """Program p walks tile p*smt's segment, then the next tile's, ...;
    every tile gets each rank of its segment once, in order."""
    ts = torch.tensor([0, 3, 3, 10, 12], dtype=torch.int32)
    te = torch.tensor([3, 3, 10, 12, 20], dtype=torch.int32)
    seen = {u: [] for u in range(5)}
    steps = 0
    for idx, live, pending in BV.smt_schedule(ts, te, 2):
        steps += 1
        for u in range(5):
            assert bool(pending[u]) == (len(seen[u]) < int(te[u] - ts[u]))
            if bool(live[u]):
                seen[u].append(int(idx[u]))
    # programs: tiles (0, 1) 3 ranks, (2, 3) 9, (4,) 8
    assert steps == 9
    for u in range(5):
        assert seen[u] == list(range(int(ts[u]), int(te[u])))
    with pytest.raises(ValueError):
        BV.rasterize_binned_smt(torch.zeros((16, 4)), ts, te, 5, 1, 0)


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


def test_render_and_gradients_match_jax_smt(monkeypatch):
    monkeypatch.setenv("GPT_BLEND_SMT", "4")
    Wr, Hr, args, target = _render_case()
    cam = orbit_camera(0.4, width=Wr, height=Hr, uid=0).to_device_dict()
    bg = jnp.asarray([0.1, 0.2, 0.3])

    def loss(xyz, log_s, rot, op, col):
        out = JRR.render(xyz, jnp.exp(log_s), rot, op[:, 0], None, cam, Wr,
                         Hr, bg, colors_precomp=col, interpret=True)
        return (jnp.mean((out["render"] - target) ** 2)
                + 0.1 * jnp.mean(out["depth"]), out)

    (_, ref), rgrads = jax.value_and_grad(
        loss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
            *[jnp.asarray(a) for a in args])

    seen = []
    orig = BV.rasterize_binned_bwd_smt
    monkeypatch.setattr(BV, "rasterize_binned_bwd_smt",
                        lambda *a, **k: seen.append(a) or orig(*a, **k))
    tcam = torbit(0.4, width=Wr, height=Hr, uid=0).to_device_dict("cpu")
    targs = [t(a).requires_grad_(True) for a in args]
    xyz, log_s, rot, op, col = targs
    ours = render(xyz, torch.exp(log_s), rot, op[:, 0], None, tcam, Wr, Hr,
                  torch.tensor([0.1, 0.2, 0.3]), colors_precomp=col)
    (torch.mean((ours["render"] - t(target)) ** 2)
     + 0.1 * torch.mean(ours["depth"])).backward()
    assert len(seen) == 1 and seen[0][5] == 4   # the SMT backward, smt 4
    assert int(ours["n_dropped"]) == 0
    for key, tol in (("render", 2e-5), ("alpha", 2e-5), ("depth", 2e-4)):
        np.testing.assert_allclose(n(ours[key]), np.asarray(ref[key]),
                                   atol=tol, rtol=0, err_msg=key)
    names = ["xyz", "log_scales", "rotation", "opacity", "colors"]
    for name, a, b in zip(names, [x.grad for x in targs], rgrads):
        scale = max(np.abs(np.asarray(b)).max(), 1e-6)
        np.testing.assert_allclose(n(a), np.asarray(b), rtol=0,
                                   atol=2e-4 * scale + 1e-8, err_msg=name)


@pytest.mark.parametrize("env,want", [
    ({"GPT_BLEND_SMT": "4"}, ("smt", 4)),
    ({"GPT_BLEND_SMT": "9"}, ("smt", 9)),
    ({"GPT_BLEND_SMT": "0"}, ("classic", None)),
    ({"GPT_BLEND_SMT": "-3"}, ("classic", None)),
    ({"GPT_BLEND_SMT": "1", "GPT_BLEND_MT": "1"}, ("mt", 4)),
    ({"GPT_BLEND_SMT": "3", "GPT_BLEND_MT": "1", "GPT_BLEND_TPB": "2"},
     ("smt", 3)),
    ({"GPT_BLEND_FLAT": "1", "GPT_BLEND_SMT": "4"}, ("flat", None)),
    ({"GPT_BLEND_SMT": "2.5"}, ValueError),
    ({"GPT_BLEND_SMT": ""}, ValueError),
], ids=lambda x: ("-".join(f"{k[10:]}={v}" for k, v in x.items())
                  or "unset") if isinstance(x, dict) else None)
def test_smt_selection(env, want, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if isinstance(want, type):
        with pytest.raises(want):
            TR.blend_variant()
        return
    assert tuple(TR.blend_variant()) == want
