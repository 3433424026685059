"""Parity of the port's training step (train/step.py, optimizer.py,
densify.py, models/gaussians.py:create_from_pcd) with the JAX package.

A `dnerf`-preset model (2k Gaussians, SH degree 3, the d=4 w=256 deform
MLP) with random densification statistics and Adam moments is made with
numpy, carried into the port by convert.py, and stepped once at stage 0
and once at stage 1 by both packages at 128x128, with time decay on. A
third case steps stage 1 with step opacity on (explicit: the gradient
reaches opacity_thres, and the lifecycle pass re-runs the deform MLP),
time decay off and the SH basis truncated (active degree 1 of 3). The
JAX step draws its time and xyz noise from its key; the test draws the
same numbers with jax.random and hands them to the port. Each JAX step is
jitted once and shared by the cases that read it. The implicit lifecycle
(Δo from the MLP) is held by a VJP of deform_stage1 alone, without a
render, for both opacity types.

Tolerances, and why:
  - loss, l1: 1e-5 relative (the render agrees to 2e-5 per pixel);
  - gradients: 2e-4 of each leaf's largest magnitude, the tolerance the
    JAX package holds its own Pallas backward to against the lax.scan
    oracle (tests/test_rasterizer.py): the backward sums per-pixel terms
    in another order, and the Pallas kernel takes dop = sum(dpower) / op;
  - Adam moments: the same, scaled as the moments scale the gradient;
  - params: 2e-3 of the group's learning rate (the step is lr * m / sqrt
    (v), and the moments above keep that ratio to about 1e-3);
  - densification statistics: denom and max_radii2D equal, the gradient
    norms to 2e-4 of their largest value.
Densify, prune and reset_opacity are selections and masked writes over
the same floats: held equal, the split's offsets (a rotation of the
pre-drawn noise) to 1e-6.
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
from gaussianprediction_tpu.models import deform as jdeform
from gaussianprediction_tpu.models import gaussians as jgauss
from gaussianprediction_tpu.train import densify as jdens
from gaussianprediction_tpu.train import step as jstep
from gaussianprediction_tpu_torch import config as tcfg
from gaussianprediction_tpu_torch.convert import (
    opt_state_from_arrays, state_from_params,
)
from gaussianprediction_tpu_torch.data.synthetic import (
    orbit_camera as torbit,
)
from gaussianprediction_tpu_torch.models import deform as tdeform
from gaussianprediction_tpu_torch.models import gaussians as tgauss
from gaussianprediction_tpu_torch.train import densify as tdens
from gaussianprediction_tpu_torch.train import optimizer as topt
from gaussianprediction_tpu_torch.train import step as tstep

W = H = 128
N = 2000
TOTAL_FRAME = 50
STATS4 = ("xyz_gradient_accum", "xyz_gradient_accum_max", "denom",
          "max_radii2D")


# case -> (stage, iteration, active SH degree or None, step opacity); the
# stage-1 iterations lie inside the noise anneals
CASES = {0: (0, 500, None, False), 1: (1, 2000, None, False),
         "step_opacity": (1, 6000, 1, True)}


def _cfgs(step_opacity=False):
    jc, tc = jcfg.get_preset("dnerf"), tcfg.get_preset("dnerf")
    for c in (jc, tc):
        c.train.use_time_decay = not step_opacity
        if step_opacity:
            c.model.step_opacity = True
            c.model.opacity_type = "explicit"
    return jc, tc


def _start(step_opacity=False):
    """numpy params, alive, statistics and Adam state of a model in
    training."""
    _, tc = _cfgs(step_opacity)
    params, alive = stage1_params(tc, N, seed=11)
    rng = np.random.default_rng(12)
    if step_opacity:
        params["opacity_thres"] = rng.uniform(0.0, 0.8, (N, 1)).astype(
            np.float32)
    stats = {
        "xyz_gradient_accum": rng.uniform(0, 1e-3, N).astype(np.float32),
        "xyz_gradient_accum_max": rng.uniform(0, 1e-4, N).astype(
            np.float32),
        "denom": rng.integers(0, 5, N).astype(np.float32),
        "max_radii2D": rng.integers(0, 9, N).astype(np.int32),
        "xyz_motion_accum_max": np.zeros(N, np.float32),
        "motion_denom": np.zeros(N, np.float32),
    }

    def moments(x):
        # m0 = 0 keeps the step's gradient readable from the JAX moment
        # (m = 0.1 g); v0 > 0 keeps the update smooth in g
        s = np.abs(x).mean() + 1e-3
        v = ((0.2 * s) ** 2 * rng.uniform(0.5, 1.5, x.shape)).astype(
            np.float32)
        return np.zeros_like(x), v

    mv = jax.tree.map(moments, params)
    is_pair = lambda x: isinstance(x, tuple)  # noqa: E731
    opt = {"m": jax.tree.map(lambda p: p[0], mv, is_leaf=is_pair),
           "v": jax.tree.map(lambda p: p[1], mv, is_leaf=is_pair),
           "step": np.int32(4)}
    return params, alive, stats, opt


def _jax_state(params, alive, stats):
    js = jax_state(params, alive)
    return js.replace(**{k: jnp.asarray(v) for k, v in stats.items()})


@pytest.fixture(scope="module")
def steps():
    """One JAX and one port step per case from the same state."""
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    view = orbit_camera(0.9, width=W, height=H, time=0.4)
    tview = torbit(0.9, width=W, height=H, time=0.4)
    gt = np.random.default_rng(5).uniform(0, 1, (H, W, 3)).astype(
        np.float32)
    out = {}
    for case, (stage, it, deg, sop) in CASES.items():
        jc, tc = _cfgs(sop)
        params, alive, stats, opt = _start(sop)
        key = jax.random.PRNGKey(stage)
        k_noise, k_time = jax.random.split(key)
        time_noise = jax.random.normal(k_time, ())
        xyz_noise = jax.random.normal(k_noise, (N, 3)) if stage else None
        jfn, raw, _ = jstep.make_train_step(jc, stage, W, H, 1.3, 3,
                                            TOTAL_FRAME, bg, interpret=True)
        if sop:
            # the JAX lifecycle tests the iteration in Python
            # (models/deform.py:_lifecycle_opacity), so its jitted step
            # cannot trace it: jit with the iteration static instead
            jfn, jit_it = jax.jit(raw, static_argnums=5), it
        else:
            jit_it = jnp.int32(it)
        js2, jopt2, jm = jfn(_jax_state(params, alive, stats),
                             jax.tree.map(jnp.asarray, opt),
                             view.to_device_dict(), jnp.asarray(gt),
                             jnp.float32(0.4), jit_it, key,
                             None if deg is None else jnp.int32(deg))
        ts = state_from_params(params, alive, device="cpu", stats=stats)
        topt0 = opt_state_from_arrays(opt, device="cpu")
        step = tstep.make_train_step(tc, stage, W, H, 1.3, 3, TOTAL_FRAME,
                                     t(bg))
        ts2, topt2, tm = step(
            ts, topt0, tview.to_device_dict("cpu"), t(gt), torch.tensor(0.4),
            it, active_deg=deg,
            noise=None if xyz_noise is None else t(xyz_noise),
            time_noise=t(time_noise))
        out[case] = (js2, jopt2, jm, ts2, topt2, tm, opt)
    return out


def _leaves(tree):
    return topt.tree_leaves(tree)


@pytest.mark.parametrize("stage", list(CASES))
def test_train_step_matches_jax(steps, stage):
    js2, jopt2, jm, ts2, topt2, tm, opt0 = steps[stage]
    stage, it, deg, sop = CASES[stage]
    assert int(tm["n_dropped"]) == int(jm["n_dropped"]) == 0
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm["l1"]), float(jm["l1"]), rtol=1e-5)
    _, tc = _cfgs(sop)
    groups = topt.active_groups(tc, max(stage, 1))
    assert ("opacity_thres" in groups) == sop
    assert int(topt2["step"]) == int(jopt2["step"]) == 5
    for key, group in topt.GROUP_OF_PARAM.items():
        if key not in ts2.params:
            continue
        tp, jp = _leaves(ts2.params[key]), _leaves(js2.params[key])
        if group not in groups:
            for a, b in zip(tp, jp):
                np.testing.assert_array_equal(n(a), n(b))
            continue
        lr = float(topt.group_lr(group, tc, 1.3, it))
        tg = _leaves(tm["grads"][key])
        m0 = _leaves(opt0["m"][key])
        for a, b, g, mj, mt, vj, vt, mo in zip(
                tp, jp, tg, _leaves(jopt2["m"][key]),
                _leaves(topt2["m"][key]), _leaves(jopt2["v"][key]),
                _leaves(topt2["v"][key]), m0):
            # the JAX gradient, from its first moment: m = 0.1 g (m0 = 0)
            assert not mo.any()
            gj = n(mj) / 0.1
            scale = max(np.abs(gj).max(), 1e-12)
            np.testing.assert_allclose(n(g), gj, atol=2e-4 * scale + 1e-9,
                                       rtol=0, err_msg=f"grad {key}")
            np.testing.assert_allclose(n(mt), n(mj), rtol=0,
                                       atol=2e-5 * scale + 1e-10,
                                       err_msg=f"m {key}")
            vs = max(np.abs(n(vj)).max(), 1e-20)
            np.testing.assert_allclose(n(vt), n(vj), rtol=0,
                                       atol=2e-4 * vs, err_msg=f"v {key}")
            np.testing.assert_allclose(n(a), n(b), rtol=0, atol=2e-3 * lr,
                                       err_msg=f"param {key}")
    np.testing.assert_array_equal(n(ts2.denom), n(js2.denom))
    np.testing.assert_array_equal(n(ts2.max_radii2D), n(js2.max_radii2D))
    for k in ("xyz_gradient_accum", "xyz_gradient_accum_max"):
        ref = n(getattr(js2, k))
        np.testing.assert_allclose(n(getattr(ts2, k)), ref, rtol=0,
                                   atol=2e-4 * np.abs(ref).max(),
                                   err_msg=k)
    # inside the densification window: the statistics moved
    assert float(ts2.denom.sum()) > float(_start(sop)[2]["denom"].sum())
    if sop:
        assert tm["grads"]["opacity_thres"].abs().max() > 0
    if deg is not None:
        # coefficients beyond the active degree get no gradient
        assert not tm["grads"]["features_rest"][:, (deg + 1) ** 2 - 1:].any()


@pytest.mark.parametrize("opacity_type", ["implicit", "explicit"])
def test_lifecycle_opacity_vjp_matches_jax(opacity_type):
    """deform_stage1's opacity with step opacity on, past
    step_opacity_iteration, and its VJP into every param it reads: the
    implicit lifecycle's Δo (the deform MLP's 8th output) and the explicit
    one's opacity_thres. Tolerances: the opacity to 1e-6, each gradient to
    2e-4 of its leaf's largest magnitude."""
    jc, tc = _cfgs(True)
    jc.model.opacity_type = tc.model.opacity_type = opacity_type
    params, alive, _, _ = _start(True)
    params = {k: v[:300] if k != "df_mlp" else v for k, v in params.items()}
    keys = ("opacity", "opacity_thres", "motion_feature", "df_mlp")
    ct = np.random.default_rng(8).normal(size=(300, 1)).astype(np.float32)
    js = jax_state(params, alive[:300])

    def jfn(sub):
        p = {**js.params, **sub}
        return jdeform.deform_stage1(p, jc, js, jnp.float32(0.3), 6000, None,
                                     noise=jnp.zeros((300, 3))).opacity

    @jax.jit
    def opacity_vjp(sub, c):
        out, vjp = jax.vjp(jfn, sub)
        return out, vjp(c)[0]

    jout, jg = opacity_vjp({k: js.params[k] for k in keys}, jnp.asarray(ct))
    ts = state_from_params(params, alive[:300], device="cpu")
    sub = {k: topt.tree_map(lambda x: x.clone().requires_grad_(True),
                            ts.params[k]) for k in keys}
    tout = tdeform.deform_stage1({**ts.params, **sub}, tc, ts,
                                 torch.tensor(0.3), 6000, None,
                                 noise=torch.zeros((300, 3))).opacity
    np.testing.assert_allclose(n(tout), n(jout), rtol=0, atol=1e-6)
    leaves = [x for k in keys for x in topt.tree_leaves(sub[k])]
    got = torch.autograd.grad(tout, leaves, t(ct), allow_unused=True)
    ref = [x for k in keys for x in jax.tree.leaves(jg[k])]
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        b = n(b)
        a = np.zeros_like(b) if a is None else n(a)
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=2e-4 * np.abs(b).max() + 1e-12)
    moved = {"implicit": "df_mlp", "explicit": "opacity_thres"}[opacity_type]
    assert any(np.abs(n(x)).max() > 0 for x in jax.tree.leaves(jg[moved]))


def _densify_start():
    """A state with 300 free slots and statistics that clone some small
    Gaussians and split some large ones (more than the free slots hold)."""
    params, alive, stats, opt = _start()
    alive = alive.copy()
    alive[-300:] = False
    return params, alive, stats, opt


@pytest.mark.parametrize("op", ["densify", "prune", "reset_opacity"])
def test_densify_prune_reset_match_jax(op):
    jc, tc = _cfgs()
    params, alive, stats, opt = _densify_start()
    extent = 1.0          # percent_dense * extent = 0.01: a few clones
    js = _jax_state(params, alive, stats)
    jopt = jax.tree.map(jnp.asarray, opt)
    ts = state_from_params(params, alive, device="cpu", stats=stats)
    topt0 = opt_state_from_arrays(opt, device="cpu")
    if op == "densify":
        key = jax.random.PRNGKey(7)
        noise = jax.random.normal(key, (2, N, 3))
        js2, jopt2 = jdens.densify_and_prune_clone_split(js, jopt, jc,
                                                         extent, key)
        ts2, topt2 = tdens.densify_and_prune_clone_split(ts, topt0, tc,
                                                         extent, noise=t(noise))
        born = (n(ts2.alive) & ~alive).sum()
        died = (alive & ~n(ts2.alive)).sum()        # split parents
        assert died > 0 and born > 2 * died         # clones and children
        assert born >= 299                          # free slots run out
        for k in STATS4:
            assert not n(getattr(ts2, k)).any()
    elif op == "prune":
        js2, jopt2 = jdens.prune(js, jc, extent, 6), jopt
        ts2, topt2 = tdens.prune(ts, tc, extent, 6), topt0
        assert 0 < (alive & ~n(ts2.alive)).sum() < alive.sum()
    else:
        js2, jopt2 = jdens.reset_opacity(js, jopt)
        ts2, topt2 = tdens.reset_opacity(ts, topt0)
        assert float(torch.sigmoid(ts2.params["opacity"][alive]).max()) \
            <= 0.01 + 1e-7
    np.testing.assert_array_equal(n(ts2.alive), n(js2.alive))
    for k in tdens.PER_GAUSSIAN:
        if k not in params:
            continue
        np.testing.assert_allclose(n(ts2.params[k]), n(js2.params[k]),
                                   rtol=0, atol=1e-6, err_msg=k)
        for mom in ("m", "v"):
            np.testing.assert_array_equal(n(topt2[mom][k]),
                                          n(jopt2[mom][k]))


def test_rank_to_slot_matches_jax():
    free = np.random.default_rng(3).random(257) < 0.3
    np.testing.assert_array_equal(
        n(tdens._rank_to_slot(t(free))),
        n(jdens._rank_to_slot(jnp.asarray(free))))


def test_create_from_pcd_matches_jax():
    jc, tc = jcfg.get_preset("test"), tcfg.get_preset("test")
    rng = np.random.default_rng(4)
    pts = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (300, 3)).astype(np.float32)
    js = jgauss.create_from_pcd(jax.random.PRNGKey(0), jc, pts, cols)
    # the random parts are the JAX package's draws
    ts = tgauss.create_from_pcd(
        tc, pts, cols, motion_feature=n(js.params["motion_feature"]),
        df_mlp=jax.tree.map(np.asarray, js.params["df_mlp"]),
        hash_tables=jax.tree.map(np.asarray, js.params["hash_tables"]),
        weight_mlp=jax.tree.map(np.asarray, js.params["weight_mlp"]),
        device="cpu")
    assert sorted(ts.params) == sorted(js.params)
    assert ts.kpt_capacity == 32 and int(ts.n_kpts()) == 0
    assert int(ts.n_alive()) == 300
    np.testing.assert_array_equal(n(ts.alive), n(js.alive))
    np.testing.assert_array_equal(n(ts.kpt_alive), n(js.kpt_alive))
    for k, v in ts.params.items():
        for a, b in zip(topt.tree_leaves(v), topt.tree_leaves(js.params[k])):
            np.testing.assert_allclose(n(a), n(b), rtol=1e-6, atol=1e-7,
                                       err_msg=k)
    for k in tgauss.STATS:
        np.testing.assert_array_equal(n(getattr(ts, k)), n(getattr(js, k)))
    # drawn from a torch.Generator instead: the same deterministic parts
    ts2 = tgauss.create_from_pcd(tc, pts, cols, torch.Generator().manual_seed(1),
                                 device="cpu")
    assert ts2.params["motion_feature"].abs().max() <= 1e-3
    assert torch.equal(ts2.params["scaling"], ts.params["scaling"])
    for k in ("hash_tables", "weight_mlp"):
        assert [x.shape for x in topt.tree_leaves(ts2.params[k])] == \
            [x.shape for x in topt.tree_leaves(ts.params[k])]
    assert float(ts2.params["hash_tables"]["level_0"].abs().max()) <= 1e-4
