"""Parity of the port's stages 2/3 (models/deform.py:deform_stage23,
train/step.py for stages 2 and 3, train/loop.py, keypoint growth in
train/densify.py, convert.py for a stage-2 state) with the JAX package.

A `test`-preset model (capacity 512, 4 hash levels of 2 features, 16 + 16
keypoint rows, the d=2 w=32 deform MLP, SH degree 1) is made by the JAX
package's create_from_pcd from 16 well-separated blobs of points (with a
motion feature per blob), so that the k-means of the stage-2 transition
finds the blobs in both packages. Its keypoints are set by the JAX
set_super_keypoints and the state is carried into the port by convert.py;
time decay and teacher-guided growth are on, so the stage-2 time anneal
and the teacher statistics run. Each JAX step is jitted once (stage 2 at
iteration 90, stage 3 at 130, both inside the keypoint-growth window) and
the port is handed the JAX step's time and keypoint noise.

Tolerances, as tests/test_torch_train.py holds the stage-0/1 steps: loss
and l1 1e-5 relative; gradients 2e-4 of each leaf's largest magnitude (the
JAX gradient read from its first moment: the start state's m is 0); Adam
moments the same, scaled as the moments scale the gradient; params 2e-3 of
the group's learning rate; denom, motion_denom and max_radii2D equal, the
gradient norms and the teacher residual maxima to 2e-4 of their largest
value. The KNN indices are held equal on every Gaussian whose 7 nearest
keypoints are apart by more than 1e-5 (1 + d_7) in squared distance
(roundoff cannot reorder those), at least 99% of the rows. Keypoint growth is
selections and masked writes: held equal. k-means keypoints within 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import n, one_torch_thread, t  # noqa: F401

from gaussianprediction_tpu import config as jcfg
from gaussianprediction_tpu.data.synthetic import orbit_camera
from gaussianprediction_tpu.models import deform as jdeform
from gaussianprediction_tpu.models import gaussians as jgauss
from gaussianprediction_tpu.train import checkpoint as jckpt
from gaussianprediction_tpu.train import densify as jdens
from gaussianprediction_tpu.train import loop as jloop
from gaussianprediction_tpu.train import step as jstep
from gaussianprediction_tpu_torch import config as tcfg
from gaussianprediction_tpu_torch.convert import (
    load_jax_checkpoint, opt_state_from_arrays, state_from_params,
)
from gaussianprediction_tpu_torch.data.synthetic import (
    orbit_camera as torbit,
)
from gaussianprediction_tpu_torch.models import deform as tdeform
from gaussianprediction_tpu_torch.train import densify as tdens
from gaussianprediction_tpu_torch.train import loop as tloop
from gaussianprediction_tpu_torch.train import optimizer as topt
from gaussianprediction_tpu_torch.train import step as tstep

W = H = 64
N_PTS = 400
TOTAL_FRAME = 50
ITERS = {2: 90, 3: 130}
SH = 1
STATS = ("xyz_gradient_accum", "xyz_gradient_accum_max", "denom",
         "max_radii2D", "xyz_motion_accum_max", "motion_denom")


def _cfgs():
    jc, tc = jcfg.get_preset("test"), tcfg.get_preset("test")
    for c in (jc, tc):
        c.train.use_time_decay = True
        c.train.densify_from_teaching = True
    return jc, tc


def _leaves(tree):
    return topt.tree_leaves(tree)


def _jax_np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def model():
    """A JAX stage-1 model of 16 blobs, before and after the keypoints."""
    jc, _ = _cfgs()
    rng = np.random.default_rng(0)
    centers = rng.uniform(-0.8, 0.8, (16, 3))
    pts = (np.repeat(centers, N_PTS // 16, 0)
           + rng.normal(0, 0.03, (N_PTS, 3))).astype(np.float32)
    cols = rng.uniform(0, 1, (N_PTS, 3)).astype(np.float32)
    js = jax.jit(lambda k: jgauss.create_from_pcd(k, jc, pts, cols))(
        jax.random.PRNGKey(0))
    C = js.capacity
    feat = np.zeros((C, jc.model.feature_dim), np.float32)
    feat[:N_PTS] = (np.repeat(rng.normal(0, 0.3, (16, feat.shape[1])),
                              N_PTS // 16, 0)
                    + rng.normal(0, 0.01, (N_PTS, feat.shape[1])))
    params = dict(js.params)
    params["motion_feature"] = jnp.asarray(feat)
    params["features_rest"] = jnp.asarray(rng.normal(
        0, 0.1, js.params["features_rest"].shape).astype(np.float32))
    js = js.replace(params=params)
    key = jax.random.PRNGKey(9)
    js_k = jax.jit(lambda s, k: jloop.set_super_keypoints(s, jc, k))(
        js, key)
    start = int(jax.random.randint(key, (), 0, C))
    return js, js_k, start


def _random_stats(C, seed):
    rng = np.random.default_rng(seed)
    return {
        "xyz_gradient_accum": rng.uniform(0, 1e-3, C).astype(np.float32),
        "xyz_gradient_accum_max": rng.uniform(0, 1e-4, C).astype(
            np.float32),
        "denom": rng.integers(0, 5, C).astype(np.float32),
        "max_radii2D": rng.integers(0, 9, C).astype(np.int32),
        "xyz_motion_accum_max": rng.uniform(0, 0.4, C).astype(np.float32),
        "motion_denom": rng.integers(0, 5, C).astype(np.float32),
    }


def _random_opt(params, seed):
    """m = 0 (the JAX gradient reads from its moment, m = 0.1 g), v > 0
    (keeps the update smooth in g), step 4."""
    rng = np.random.default_rng(seed)

    def v(x):
        s = np.abs(x).mean() + 1e-3
        return ((0.2 * s) ** 2 * rng.uniform(0.5, 1.5, x.shape)).astype(
            np.float32)

    return {"m": jax.tree.map(np.zeros_like, params),
            "v": jax.tree.map(v, params), "step": np.int32(4)}


@pytest.fixture(scope="module")
def steps(model):
    """One JAX and one port step per stage from the same state."""
    jc, tc = _cfgs()
    _, js_k, _ = model
    params = _jax_np(js_k.params)
    kpt_alive = np.asarray(js_k.kpt_alive)
    alive = np.asarray(js_k.alive)
    stats = _random_stats(js_k.capacity, 12)
    opt = _random_opt(params, 13)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    view = orbit_camera(0.9, width=W, height=H, time=0.4)
    tview = torbit(0.9, width=W, height=H, time=0.4)
    gt = np.random.default_rng(5).uniform(0, 1, (H, W, 3)).astype(
        np.float32)
    out = {}
    for stage, it in ITERS.items():
        key = jax.random.PRNGKey(stage)
        k_noise, k_time = jax.random.split(key)
        time_noise = jax.random.normal(k_time, ())
        kpt_noise = jax.random.normal(k_noise, params["super_xyz"].shape)
        jfn, _, _ = jstep.make_train_step(jc, stage, W, H, 1.3, SH,
                                          TOTAL_FRAME, bg, interpret=True)
        # fresh arrays: the jitted step donates its state
        js = js_k.replace(params=jax.tree.map(jnp.asarray, params),
                          alive=jnp.asarray(alive),
                          kpt_alive=jnp.asarray(kpt_alive),
                          **{k: jnp.asarray(v) for k, v in stats.items()})
        js2, jopt2, jm = jfn(js, jax.tree.map(jnp.asarray, opt),
                             view.to_device_dict(), jnp.asarray(gt),
                             jnp.float32(0.4), jnp.int32(it), key)
        ts = state_from_params(params, alive, kpt_alive, device="cpu",
                               stats=stats)
        step = tstep.make_train_step(tc, stage, W, H, 1.3, SH, TOTAL_FRAME,
                                     t(bg))
        ts2, topt2, tm = step(
            ts, opt_state_from_arrays(opt, device="cpu"),
            tview.to_device_dict("cpu"), t(gt), torch.tensor(0.4), it,
            noise=t(kpt_noise), time_noise=t(time_noise))
        out[stage] = (js2, jopt2, jm, ts2, topt2, tm, params, stats)
    return out


def _near_ties(js_k, jc):
    """Rows whose 7 nearest keypoints (the hybrid KNN's space, float64)
    are not all apart by more than 1e-5 (1 + d_7)."""
    p = _jax_np(js_k.params)
    a = jc.model.feature_amplify
    q = np.concatenate([p["xyz"], p["motion_feature"] * a], 1)
    k = np.concatenate([p["super_xyz"], p["super_feature"] * a], 1)
    d = ((q[:, None].astype(np.float64) - k[None]) ** 2).sum(-1)
    d[:, ~np.asarray(js_k.kpt_alive)] = np.inf
    d = np.sort(d, 1)[:, :jc.model.nearest_num + 1]
    return ~(np.diff(d, axis=1) > 1e-5 * (1 + d[:, -1:])).all(axis=1)


def test_set_super_keypoints_and_transitions(model):
    jc, tc = _cfgs()
    js, js_k, start = model
    ts = state_from_params(_jax_np(js.params), np.asarray(js.alive),
                           np.asarray(js.kpt_alive), device="cpu")
    assert int(ts.n_kpts()) == 0 and ts.kpt_capacity == 32
    opt0 = topt.init_adam(ts.params)
    s2 = tc.train.second_stage_iteration
    ts2, opt2 = tloop.stage_transition(ts, opt0, tc, s2 + 1,
                                       start_idx=start)
    np.testing.assert_array_equal(n(ts2.kpt_alive), n(js_k.kpt_alive))
    assert int(ts2.n_kpts()) == tc.model.max_points == 16
    for k in ("super_xyz", "super_feature"):
        np.testing.assert_allclose(n(ts2.params[k]), n(js_k.params[k]),
                                   rtol=0, atol=1e-5, err_msg=k)
    assert opt2 is not opt0 and int(opt2["step"]) == 0
    # not a transition iteration: nothing changes; stage 3: a fresh Adam
    assert tloop.stage_transition(ts2, opt0, tc, s2 + 2) == (ts2, opt0)
    ts3, opt3 = tloop.stage_transition(
        ts2, {**opt0, "step": torch.tensor(7, dtype=torch.int32)}, tc,
        tc.train.third_stage_iteration + 1)
    assert ts3 is ts2 and int(opt3["step"]) == 0
    assert tloop.stage_of(tc, s2 + 1) == 2 and tstep.stage_of is \
        tloop.stage_of


def test_deform_stage23_matches_jax(model):
    jc, tc = _cfgs()
    _, js_k, _ = model
    ts = state_from_params(_jax_np(js_k.params), np.asarray(js_k.alive),
                           np.asarray(js_k.kpt_alive), device="cpu")
    key = jax.random.PRNGKey(4)
    noise = jax.random.normal(key, js_k.params["super_xyz"].shape)
    jo = jax.jit(lambda s, k: jdeform.deform_stage23(
        s.params, jc, s, jnp.float32(0.3), 70, k))(js_k, key)
    to = tdeform.deform_stage23(ts.params, tc, ts, torch.tensor(0.3), 70,
                                noise=t(noise))
    tie = _near_ties(js_k, jc)
    assert tie.sum() <= 0.01 * tie.size
    np.testing.assert_array_equal(n(to.nn_idx)[~tie], n(jo.nn_idx)[~tie])
    for f in ("weights_xyz", "weights_r"):
        np.testing.assert_allclose(n(getattr(to, f)), n(getattr(jo, f)),
                                   rtol=0, atol=1e-6, err_msg=f)
    for f in ("xyz", "rotation", "scaling", "opacity", "delta_xyz",
              "kpts_xyz_motion", "kpts_rotation_motion"):
        np.testing.assert_allclose(n(getattr(to, f)), n(getattr(jo, f)),
                                   rtol=0, atol=2e-6, err_msg=f)
    jr = jax.jit(lambda p, d: jdeform.teacher_motion_residual(
        p, jc, jdeform.time_encode(jc, jnp.float32(0.3)), d))(
            js_k.params, jo.delta_xyz)
    tr = tdeform.teacher_motion_residual(
        ts.params, tc, tdeform.time_encode(tc, torch.tensor(0.3)),
        to.delta_xyz)
    np.testing.assert_allclose(n(tr), n(jr), rtol=0, atol=2e-6)
    for stage in (1, 2):
        np.testing.assert_allclose(
            float(tdeform.motion_feature_reg(ts.params, stage)),
            float(jdeform.motion_feature_reg(js_k.params, jc, 0, stage)),
            rtol=1e-6)


@pytest.mark.parametrize("stage", [2, 3])
def test_train_step_matches_jax(steps, stage):
    js2, jopt2, jm, ts2, topt2, tm, params0, stats0 = steps[stage]
    _, tc = _cfgs()
    assert int(tm["n_dropped"]) == int(jm["n_dropped"]) == 0
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm["l1"]), float(jm["l1"]), rtol=1e-5)
    groups = topt.active_groups(tc, stage)
    assert int(topt2["step"]) == int(jopt2["step"]) == 5
    it = ITERS[stage]
    for key, group in topt.GROUP_OF_PARAM.items():
        tp, jp = _leaves(ts2.params[key]), _leaves(js2.params[key])
        if group not in groups:
            for a, b, c in zip(tp, jp, _leaves(params0[key])):
                np.testing.assert_array_equal(n(a), n(b))
                np.testing.assert_array_equal(n(a), c)   # untouched
            continue
        lr = float(topt.group_lr(group, tc, 1.3, it))
        for a, b, g, mj, mt, vj, vt in zip(
                tp, jp, _leaves(tm["grads"][key]),
                _leaves(jopt2["m"][key]), _leaves(topt2["m"][key]),
                _leaves(jopt2["v"][key]), _leaves(topt2["v"][key])):
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
    # the weight model learns in both stages; stage 2 leaves the
    # Gaussians as they were
    for lvl in ts2.params["hash_tables"]:
        assert not np.array_equal(n(ts2.params["hash_tables"][lvl]),
                                  params0["hash_tables"][lvl])
    assert "xyz" not in tm["grads"] if stage == 2 else "xyz" in tm["grads"]
    for k in ("denom", "max_radii2D", "motion_denom"):
        np.testing.assert_array_equal(n(getattr(ts2, k)),
                                      n(getattr(js2, k)), err_msg=k)
    for k in ("xyz_gradient_accum", "xyz_gradient_accum_max",
              "xyz_motion_accum_max"):
        ref = n(getattr(js2, k))
        np.testing.assert_allclose(n(getattr(ts2, k)), ref, rtol=0,
                                   atol=2e-4 * np.abs(ref).max(), err_msg=k)
    # inside the keypoint-growth window: the statistics moved
    assert float(ts2.denom.sum()) > float(stats0["denom"].sum())
    assert float(ts2.motion_denom.sum()) > float(
        stats0["motion_denom"].sum())


@pytest.mark.parametrize("how", ["grads", "teaching"])
def test_grow_keypoints_matches_jax(model, how):
    jc, tc = _cfgs()
    _, js_k, _ = model
    params = _jax_np(js_k.params)
    stats = _random_stats(js_k.capacity, 21)
    opt = _random_opt(params, 22)
    opt["m"] = jax.tree.map(lambda x: x + 1.0, opt["m"])
    js = js_k.replace(**{k: jnp.asarray(v) for k, v in stats.items()})
    ts = state_from_params(params, np.asarray(js_k.alive),
                           np.asarray(js_k.kpt_alive), device="cpu",
                           stats=stats)
    max_new = tc.model.adaptive_points_num
    jfn = {"grads": jdens.grow_keypoints_from_grads,
           "teaching": jdens.grow_keypoints_from_teaching}[how]
    tfn = {"grads": tdens.grow_keypoints_from_grads,
           "teaching": tdens.grow_keypoints_from_teaching}[how]
    # ratio 20 (the default is 100) so that several keypoints grow
    js2, jopt2 = jax.jit(lambda s_, o: jfn(s_, o, jc, max_new, 20))(
        js, jax.tree.map(jnp.asarray, opt))
    ts2, topt2 = tfn(ts, opt_state_from_arrays(opt, device="cpu"), tc,
                     max_new, 20)
    np.testing.assert_array_equal(n(ts2.kpt_alive), n(js2.kpt_alive))
    new = n(ts2.kpt_alive) & ~np.asarray(js_k.kpt_alive)
    assert new.sum() >= 2
    for k in tdens.PER_KPT:
        np.testing.assert_array_equal(n(ts2.params[k]), n(js2.params[k]))
        for mom in ("m", "v"):
            np.testing.assert_array_equal(n(topt2[mom][k]),
                                          n(jopt2[mom][k]))
            assert not n(topt2[mom][k])[new].any()
    for k in STATS:
        assert not n(getattr(ts2, k)).any()
    # a free-row-less state grows nothing
    full = ts2.replace(kpt_alive=torch.ones_like(ts2.kpt_alive))
    ts3, _ = tdens.grow_keypoints_from_grads(
        full.replace(**{k: t(v) for k, v in stats.items()}), topt2, tc,
        max_new)
    np.testing.assert_array_equal(n(ts3.params["super_xyz"]),
                                  n(ts2.params["super_xyz"]))


def test_convert_round_trips_stage2_state(model, tmp_path):
    _, js_k, _ = model
    opt = jax.tree.map(jnp.asarray, _random_opt(_jax_np(js_k.params), 3))
    path = str(tmp_path / "stage2.npz")
    jckpt.save_checkpoint(path, js_k, opt, 31_000, jax.random.PRNGKey(0))
    ts, topt2, it = load_jax_checkpoint(path, device="cpu")
    assert it == 31_000
    nested = state_from_params(_jax_np(js_k.params), np.asarray(js_k.alive),
                               np.asarray(js_k.kpt_alive), device="cpu")
    np.testing.assert_array_equal(n(ts.kpt_alive), n(js_k.kpt_alive))
    assert sorted(ts.params["hash_tables"]) == [f"level_{i}"
                                                for i in range(4)]
    for state in (ts, nested):
        assert sorted(state.params) == sorted(js_k.params)
        for k in js_k.params:
            for a, b in zip(_leaves(state.params[k]),
                            jax.tree.leaves(js_k.params[k])):
                assert a.dtype == torch.float32
                np.testing.assert_array_equal(n(a), np.asarray(b),
                                              err_msg=k)
    for a, b in zip(_leaves(topt2["v"]), jax.tree.leaves(opt["v"])):
        np.testing.assert_array_equal(n(a), np.asarray(b))
    # the port's Adam updates the nested hash tables like any other leaf
    grads = {"hash_tables": topt.tree_map(torch.ones_like,
                                          ts.params["hash_tables"]),
             "weight_mlp": topt.tree_map(torch.ones_like,
                                         ts.params["weight_mlp"])}
    new, _ = topt.adam_step(
        {k: ts.params[k] for k in grads},
        grads, {"m": {k: topt2["m"][k] for k in grads},
                "v": {k: topt2["v"][k] for k in grads},
                "step": topt2["step"]}, tcfg.get_preset("test"), 2,
        tstep.row_lrs(tcfg.get_preset("test"), 2, tstep.step_scalars(
            tcfg.get_preset("test"), 2, 1.0, [31_000])[0]))
    for a, b in zip(_leaves(new["hash_tables"]),
                    _leaves(ts.params["hash_tables"])):
        assert (a < b).all()
