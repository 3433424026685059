"""End-to-end parity of the port's stage-0/1 render with the JAX package.

A `dnerf`-preset model (2k Gaussians, SH degree 3, the d=4 w=256 deform
MLP) is made with numpy, carried into the port by convert.py, and rendered
at 128x128 by both packages: render_at_time at stage 0, render_set at
stage 1 (iteration 20000, past xyz_noise_iteration, so no noise is drawn).
Tolerances are the rasterizer tests' own, rgb and alpha 2e-5, depth 2e-4:
the deform MLP, projection and SH differ from XLA's only in the last ulps,
and the blend follows the oracle's CUDA semantics where the Pallas kernel
scans (ulp-level association). Integer outputs (radii, n_dropped,
n_instances) are held equal.

The render's gradients w.r.t. xyz, scaling, rotation, opacity, shs and the
NDC-scale means2d carrier are held to the JAX render's (Pallas backward,
interpret mode) within 2e-4 of each gradient's largest magnitude, the
tolerance the JAX package holds its own backward to against the oracle.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import (  # noqa: F401
    jax_state, n, one_torch_thread, stage1_params, t,
)

from gaussianprediction_tpu import config as jcfg
from gaussianprediction_tpu.data.synthetic import orbit_camera
from gaussianprediction_tpu.eval import render as jeval
from gaussianprediction_tpu.train import step as jstep
from gaussianprediction_tpu.train.checkpoint import save_checkpoint
from gaussianprediction_tpu_torch import config as tcfg
from gaussianprediction_tpu_torch.convert import (
    load_jax_checkpoint, state_from_params,
)
from gaussianprediction_tpu_torch.data.synthetic import (
    orbit_camera as torbit,
)
from gaussianprediction_tpu_torch.eval import render as teval
from gaussianprediction_tpu_torch.ops import rasterize as TR
from gaussianprediction_tpu_torch.models.gaussians import (
    GaussianState, weight_model,
)
from gaussianprediction_tpu_torch.train import step as tstep
from gaussianprediction_tpu_torch.train.loop import stage_transition

W = H = 128
N = 2000


@pytest.fixture(scope="module")
def model():
    tc = tcfg.get_preset("dnerf")
    params, alive = stage1_params(tc, N, seed=11)
    return params, alive


def _close(ours, ref):
    np.testing.assert_allclose(n(ours["render"]), n(ref["render"]),
                               atol=2e-5, rtol=0)
    np.testing.assert_allclose(n(ours["alpha"]), n(ref["alpha"]), atol=2e-5,
                               rtol=0)
    np.testing.assert_allclose(n(ours["depth"]), n(ref["depth"]), atol=2e-4,
                               rtol=0)


@pytest.fixture(scope="module")
def render_grads(model):
    """d mean((render - target)^2) / d inputs, from the JAX render."""
    params, alive = model
    xyz, q = params["xyz"], params["rotation"]
    scal = np.exp(params["scaling"])
    op = 1.0 / (1.0 + np.exp(-params["opacity"]))
    shs = np.concatenate([params["features_dc"], params["features_rest"]],
                         axis=1).transpose(0, 2, 1)
    dummy = np.zeros((N, 2), np.float32)
    inputs = [np.ascontiguousarray(a, np.float32)
              for a in (xyz, scal, q, op, shs, dummy)]
    cam = orbit_camera(0.7, width=W, height=H)
    target = np.random.default_rng(21).uniform(0, 1, (H, W, 3)).astype(
        np.float32)
    bg = np.array([0.3, 0.2, 0.1], np.float32)
    from gaussianprediction_tpu.ops import rasterize as JRr

    def loss(x, s, r, o, sh, d):
        out = JRr.render(x, s, r, o, sh, cam.to_device_dict(), W, H,
                         jnp.asarray(bg), sh_degree=3,
                         alive=jnp.asarray(alive), means2d_dummy=d,
                         interpret=True, need_tidx=False)
        return jnp.mean((out["render"] - target) ** 2)

    ref = jax.jit(jax.grad(loss, argnums=tuple(range(6))))(
        *[jnp.asarray(a) for a in inputs])
    return inputs, alive, cam, target, bg, [np.asarray(g) for g in ref]


def test_render_gradients_match_jax(render_grads):
    inputs, alive, cam, target, bg, ref = render_grads
    tin = [t(a).requires_grad_(True) for a in inputs]
    x, s, r, o, sh, d = tin
    tcam = torbit(0.7, width=W, height=H).to_device_dict("cpu")
    out = TR.render(x, s, r, o, sh, tcam, W, H, t(bg), sh_degree=3,
                    alive=t(alive), means2d_dummy=d, need_tidx=False)
    assert int(out["n_dropped"]) == 0
    torch.mean((out["render"] - t(target)) ** 2).backward()
    names = ("xyz", "scaling", "rotation", "opacity", "shs",
             "means2d_dummy")
    for name, a, b in zip(names, tin, ref):
        scale = np.abs(b).max()
        assert scale > 0, name
        np.testing.assert_allclose(n(a.grad), b, rtol=0, atol=2e-4 * scale,
                                   err_msg=name)
    # under no_grad the render takes the kernels directly: same image
    with torch.no_grad():
        again = TR.render(*[a.detach() for a in tin[:5]], tcam, W, H, t(bg),
                          sh_degree=3, alive=t(alive), need_tidx=False)
    assert torch.equal(again["render"], out["render"].detach())


def test_render_at_time_stage0(model):
    params, alive = model
    jc, tc = jcfg.get_preset("dnerf"), tcfg.get_preset("dnerf")
    it = 100
    assert tstep.stage_of(tc, it) == 0
    js = jax_state(params, alive)
    ts = state_from_params(params, alive, device="cpu")
    view = orbit_camera(0.9, width=W, height=H, time=0.0)
    bg = np.array([0.0, 0.5, 1.0], np.float32)

    @jax.jit
    def jfn(cam):
        pkg, _ = jstep.render_at_time(
            js.params, jc, js, cam, jnp.float32(0.0), jnp.int32(it),
            jax.random.PRNGKey(0), 0, W, H, jnp.asarray(bg), 3,
            interpret=True, need_tidx=True)
        return {k: pkg[k] for k in ("render", "depth", "alpha", "tidx",
                                    "radii", "n_dropped", "n_instances")}

    ref = jfn(view.to_device_dict())
    tview = torbit(0.9, width=W, height=H, time=0.0)
    ours, _ = tstep.render_at_time(
        ts.params, tc, ts, tview.to_device_dict("cpu"), torch.tensor(0.0),
        it, None, 0, W, H, t(bg), 3, need_tidx=True)
    _close(ours, ref)
    np.testing.assert_array_equal(n(ours["radii"]), n(ref["radii"]))
    assert int(ours["n_dropped"]) == int(ref["n_dropped"]) == 0
    assert int(ours["n_instances"]) == int(ref["n_instances"])
    assert np.mean(n(ours["tidx"]) == n(ref["tidx"])) > 0.99
    assert (n(ours["radii"])[~alive] == 0).all()


def test_render_set_stage1(model):
    params, alive = model
    jc, tc = jcfg.get_preset("dnerf"), tcfg.get_preset("dnerf")
    it = 20_000
    assert tstep.stage_of(tc, it) == 1
    js = jax_state(params, alive)
    ts = state_from_params(params, alive, device="cpu")
    times = (0.1, 0.8)
    jviews = [orbit_camera(0.3 + 2.0 * i, width=W, height=H, time=tt, uid=i)
              for i, tt in enumerate(times)]
    tviews = [torbit(0.3 + 2.0 * i, width=W, height=H, time=tt, uid=i)
              for i, tt in enumerate(times)]
    bg = np.zeros(3, np.float32)
    ref, _, _ = jeval.render_set(js, jc, it, jviews, bg, interpret=True)
    stats = {}
    ours, gts, fps = teval.render_set(ts, tc, it, tviews, bg, stats=stats)
    assert gts == [] and fps > 0
    assert stats["n_dropped"] == [0, 0] and len(stats["ms"]) == 2
    for o, r in zip(ours, ref):
        assert o.shape == (H, W, 3) and o.dtype == np.float32
        np.testing.assert_allclose(o, np.asarray(r), atol=2e-5, rtol=0)
    # the two times give different images: the deformation is live
    assert np.abs(ours[0] - ours[1]).max() > 1e-3
    rgb, depth, tidx = teval.make_render_fn(ts, tc, it, W, H, bg, 3)(
        tviews[0].to_device_dict("cpu"), torch.tensor(times[0]))
    assert torch.equal(torch.clamp(rgb, 0, 1), torch.from_numpy(ours[0]))


def test_convert_loads_jax_checkpoint(model, tmp_path):
    params, alive = model
    js = jax_state(params, alive)
    path = str(tmp_path / "chkpnt.npz")
    js = js.replace(denom=jnp.arange(N, dtype=jnp.float32))
    opt = {"m": jax.tree.map(jnp.ones_like, js.params),
           "v": jax.tree.map(jnp.zeros_like, js.params),
           "step": jnp.int32(7)}
    save_checkpoint(path, js, opt, 1234, jax.random.PRNGKey(0))
    state, opt_state, iteration = load_jax_checkpoint(path, device="cpu")
    assert iteration == 1234
    np.testing.assert_array_equal(n(state.denom), np.arange(N))
    assert not state.xyz_gradient_accum.any()
    assert state.max_radii2D.dtype == torch.int32
    assert int(opt_state["step"]) == 7
    assert float(opt_state["m"]["df_mlp"][2]["w"].min()) == 1.0
    assert float(opt_state["v"]["xyz"].max()) == 0.0
    np.testing.assert_array_equal(n(state.alive), alive)
    assert len(state.params["df_mlp"]) == len(params["df_mlp"]) == 5
    for a, b in zip(state.params["df_mlp"], params["df_mlp"]):
        np.testing.assert_array_equal(n(a["w"]), b["w"])
        np.testing.assert_array_equal(n(a["b"]), b["b"])
    for k in ("xyz", "features_dc", "features_rest", "scaling", "rotation",
              "opacity", "motion_feature"):
        assert state.params[k].dtype == torch.float32
        np.testing.assert_array_equal(n(state.params[k]), params[k])


def test_unported_paths_raise():
    g = {k: torch.zeros(4, d) for k, d in (("xyz", 3), ("s", 3), ("q", 4))}
    cam = torbit(0.1, width=32, height=32).to_device_dict("cpu")
    for kw in ({"tile_band": (0, 1)}, {"fast_binning": False}):
        with pytest.raises(NotImplementedError):
            TR.render(g["xyz"], g["s"], g["q"], torch.ones(4), None, cam, 32,
                      32, torch.zeros(3), colors_precomp=g["xyz"], **kw)
    for enc in ("brick", "fourier"):
        cfg = tcfg.get_preset("dnerf")
        cfg.model.weight_encoder = enc
        with pytest.raises(NotImplementedError):
            tstep.deform_for_stage({"xyz": g["xyz"]}, cfg, None,
                                   torch.tensor(0.0), 40_000, None, 2)
        with pytest.raises(NotImplementedError):
            weight_model(cfg, np.random.default_rng(0))
    cfg = tcfg.get_preset("dnerf")
    cfg.train.distill_init_steps = 10
    st = GaussianState(params={}, alive=torch.ones(4, dtype=torch.bool),
                       kpt_alive=torch.zeros(4, dtype=torch.bool))
    with pytest.raises(NotImplementedError):
        stage_transition(st, None, cfg, cfg.train.second_stage_iteration + 1)
