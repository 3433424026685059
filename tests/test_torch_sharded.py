"""The port's sharded training step (parallel/shard.py) and its Trainer
and CLI paths on 4 (and 2) spawned `gloo` ranks on the CPU, against the
JAX package's make_sharded_train_step on 4 of its virtual CPU devices
(tests/conftest.py) and against the port's own single-device paths.

Each rank is a fresh process (tests/torch_dist_child.py) that imports only
the port, joins the group through parallel/distributed.py from its
environment, reads its inputs from an .npz under tmp_path and writes its
results there. A child that hangs is killed at its timeout and fails its
test.

- JAX parity: a `test`-preset model (128 Gaussians of 512 rows, SH 1,
  64x64) takes one sharded step on a 1 x 4 mesh at stage 2 (keypoints,
  the hash grid; iteration 70) and on a 2 x 2 mesh at stage 1 (iteration
  30) in both packages, from the same state and Adam state (first moments
  0, second moments random, so the update follows the gradient's size).
  The xyz and time noise are annealed off (xyz_noise_iteration =
  time_noise_iteration = 1), as the JAX package's own sharded Trainer
  test has them. Held to the JAX package's bars for its sharded step
  against its single step (tests/test_parallel.py): the loss to 1e-4
  relative, the parameters and xyz_gradient_accum to 1e-5, denom equal;
  every rank's state bit-identical to rank 0's.
- The data axis inside the port: a 2 x 1 mesh on ranks 0 and 1 against
  make_train_step_batched over the same two cameras with its Adam step at
  the same iteration: loss, gradients, statistics, parameters and Adam
  moments equal bit for bit (the batched step's teacher statistics, the
  one pinned difference, are off in the preset).
- The Trainer: Trainer(n_devices=4, n_data=2) from iteration 45 to 66
  (the densify event at 50, the stage-2 transition at 61), its iterations
  before 45 single-device, against the port's single-device Trainer over
  the same cameras and draws (each iteration's two cameras accumulated by
  make_train_step_batched, Adam at that iteration): the alive and
  keypoint counts equal, the losses within 3e-2 relative (the JAX
  package's bound for the same trajectory, tests/test_parallel.py),
  every rank's state bit-identical.
- cli.train --n_devices 2 on 2 ranks (GPT_FORCE_CPU=1): each rank is given
  its own model path; rank 0 writes its own, rank 1 writes nothing.
"""
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import (  # noqa: F401
    load_ranks, one_torch_thread, spawn,
)

from gaussianprediction_tpu import config as jcfg
from gaussianprediction_tpu.data.synthetic import orbit_camera
from gaussianprediction_tpu.data.synthetic import random_gaussians
from gaussianprediction_tpu.models import gaussians as jgauss
from gaussianprediction_tpu.parallel.mesh import make_mesh as jmake_mesh
from gaussianprediction_tpu.parallel.shard import (
    make_sharded_train_step as jsharded,
)
from gaussianprediction_tpu.train.loop import set_super_keypoints
from gaussianprediction_tpu_torch import config as tcfg
from gaussianprediction_tpu_torch.convert import flatten
from gaussianprediction_tpu_torch.data.scene import (
    Scene, synthetic_scene_info,
)
from gaussianprediction_tpu_torch.train.loop import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W = H = 64
EXTENT, TOTAL_FRAME, SH = 1.3, 8, 1
NOISE_OFF = {"train": {"xyz_noise_iteration": 1, "time_noise_iteration": 1}}
STATS = ("xyz_gradient_accum", "xyz_gradient_accum_max", "denom",
         "max_radii2D", "xyz_motion_accum_max", "motion_denom")
# (n_data, n_tile, stage, iteration)
JAX_CASES = ((1, 4, 2, 70), (2, 2, 1, 30))


def assert_ranks_identical(ranks, prefix):
    for r, got in enumerate(ranks[1:], 1):
        for k, v in ranks[0].items():
            if k.startswith(prefix):
                assert np.array_equal(got[k], v, equal_nan=True), (r, k)


def _jcfg():
    cfg = jcfg.get_preset("test")
    cfg.train.xyz_noise_iteration = cfg.train.time_noise_iteration = 1
    return cfg


def _jax_start(stage):
    """(state arrays, Adam state arrays) of the JAX model of a case."""
    cfg = _jcfg()
    g = random_gaussians(128, seed=0, scale_range=(-3.2, -2.0))
    st = jgauss.create_from_pcd(jax.random.PRNGKey(0), cfg, g["xyz"],
                                g["colors"])
    rng = np.random.default_rng(5)
    params = dict(st.params)
    params["features_rest"] = jnp.asarray(rng.normal(
        0, 0.1, st.params["features_rest"].shape).astype(np.float32))
    st = st.replace(params=params)
    if stage >= 2:
        st = set_super_keypoints(st, cfg, jax.random.PRNGKey(1))
    params = jax.tree.map(np.asarray, st.params)

    def second(x):
        s = np.abs(x).mean() + 1e-3
        return ((0.2 * s) ** 2 * rng.uniform(0.5, 1.5, x.shape)).astype(
            np.float32)

    opt = {"m": jax.tree.map(np.zeros_like, params),
           "v": jax.tree.map(second, params), "step": np.int32(4)}
    return st, params, opt


def _views(n_data):
    angles = [0.4 + 0.8 * j for j in range(n_data)]
    times = [0.3 + 0.2 * j for j in range(n_data)]
    gts = np.random.default_rng(1).uniform(
        0, 1, (n_data, H, W, 3)).astype(np.float32)
    return angles, times, gts


def _case_inputs(path, st, params, opt, gts):
    arrays = {f"params/{k}": v for k, v in flatten(params).items()}
    arrays.update({f"opt/{k}": v for k, v in flatten(opt).items()})
    arrays["alive"] = np.asarray(st.alive)
    arrays["kpt_alive"] = np.asarray(st.kpt_alive)
    for k in STATS:
        arrays[k] = np.asarray(getattr(st, k))
    arrays["gts"] = gts
    np.savez(path, **arrays)


def _spec_case(inputs, n_data, n_tile, stage, it, angles, times, **kw):
    return dict(inputs=str(inputs), n_data=n_data, n_tile=n_tile,
                stage=stage, iteration=it, angles=angles, times=times,
                bg=[0.0, 0.0, 0.0], extent=EXTENT, sh_degree=SH,
                total_frame=TOTAL_FRAME, capacity_multiplier=12.0,
                cfg=NOISE_OFF, **kw)


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """The JAX sharded steps of JAX_CASES and the port's on 4 ranks, plus
    the port's 2 x 1 mesh against its batched step."""
    folder = tmp_path_factory.mktemp("steps")
    cases, jax_out = [], []
    for i, (nd, nt, stage, it) in enumerate(JAX_CASES):
        st, params, opt = _jax_start(stage)
        angles, times, gts = _views(nd)
        inputs = folder / f"inputs{i}.npz"
        _case_inputs(inputs, st, params, opt, gts)
        cases.append(_spec_case(inputs, nd, nt, stage, it, angles, times))
        mesh = jmake_mesh(n_data=nd, n_tile=nt,
                          devices=jax.devices("cpu")[:nd * nt])
        step, B = jsharded(_jcfg(), stage, W, H, EXTENT, SH,
                           TOTAL_FRAME, np.zeros(3, np.float32), mesh,
                           interpret=True, capacity_multiplier=12.0)
        assert B == nd
        cams = jax.tree.map(
            lambda *xs: jnp.stack([jnp.asarray(x) for x in xs]),
            *[orbit_camera(a, width=W, height=H, time=tm).to_device_dict()
              for a, tm in zip(angles, times)])
        js = st.replace(params=jax.tree.map(jnp.asarray, params))
        s2, o2, m = step(js, jax.tree.map(jnp.asarray, opt), cams,
                         jnp.asarray(gts), jnp.asarray(times, jnp.float32),
                         jnp.int32(it), jax.random.PRNGKey(7))
        jax_out.append((jax.tree.map(np.asarray, s2),
                        jax.tree.map(np.asarray, o2),
                        {k: np.asarray(v) for k, v in m.items()}))
    # the port's data axis against its batched step, on ranks 0 and 1
    st, params, opt = _jax_start(1)
    angles, times, gts = _views(2)
    inputs = folder / "inputs_batched.npz"
    _case_inputs(inputs, st, params, opt, gts)
    cases.append(_spec_case(inputs, 2, 1, 1, 30, angles, times,
                            ranks=[0, 1], batched_ref=True))
    spawn({"job": "steps", "width": W, "height": H, "cases": cases},
          folder, 4)
    return jax_out, load_ranks(folder, 4)


@pytest.mark.parametrize("case", range(len(JAX_CASES)),
                         ids=[f"{nd}x{nt}-stage{s}"
                              for nd, nt, s, _ in JAX_CASES])
def test_sharded_step_matches_jax(steps, case):
    (js2, jo2, jm), ranks = steps[0][case], steps[1]
    pre = f"case{case}/"
    got = ranks[0]
    assert int(got[pre + "n_dropped"]) == int(jm["n_dropped"]) == 0
    assert float(got[pre + "loss"]) == pytest.approx(float(jm["loss"]),
                                                     rel=1e-4)
    assert float(got[pre + "l1"]) == pytest.approx(float(jm["l1"]),
                                                   rel=1e-4)
    for k, v in flatten(js2.params).items():
        np.testing.assert_allclose(got[f"{pre}params/{k}"], v, rtol=0,
                                   atol=1e-5, err_msg=k)
    for k in ("xyz_gradient_accum", "xyz_gradient_accum_max"):
        np.testing.assert_allclose(got[pre + k], getattr(js2, k), rtol=0,
                                   atol=1e-5, err_msg=k)
    np.testing.assert_array_equal(got[pre + "denom"], js2.denom)
    np.testing.assert_array_equal(got[pre + "max_radii2D"], js2.max_radii2D)
    assert_ranks_identical(ranks, pre)


def test_data_axis_matches_batched_step(steps):
    """The sharded step's data axis (2 x 1 on ranks 0 and 1) sums the two
    cameras' gradients as make_train_step_batched does, bit for bit: one
    band is the whole frame (the single step's loss) and a sum of two is
    the same in either order."""
    ranks = steps[1]
    pre = f"case{len(JAX_CASES)}/"
    got = ranks[0]
    assert pre + "loss" not in ranks[2]          # ranks 2, 3 sat it out
    keys = [k[len(pre) + len("batched/"):] for k in got
            if k.startswith(pre + "batched/")]
    assert "loss" in keys and "params/xyz" in keys and "grads/xyz" in keys
    for k in keys:
        assert np.array_equal(got[pre + k], got[pre + "batched/" + k],
                              equal_nan=True), k
    for k, v in got.items():
        if k.startswith(pre) and "batched/" not in k:
            assert np.array_equal(ranks[1][k], v, equal_nan=True), k


# ---- the Trainer -------------------------------------------------------
FIRST, LAST = 45, 66        # densify at 50, stage 2 from 61
SCENE = dict(n_points=64, n_cams=4, n_test=0, width=32, height=32)


def _trainer_cfg():
    cfg = tcfg.get_preset("test")
    cfg.opt.iterations = LAST
    cfg.train.use_time_decay = False
    cfg.train.xyz_noise_iteration = cfg.train.time_noise_iteration = 1
    return cfg


def _reference(n_data):
    """The single-device Trainer over the sharded Trainer's cameras and
    draws: each iteration's n_data cameras accumulated by the batched step
    with Adam at that iteration (the members' noise zero: the anneal is
    off at the sharded step's iteration)."""
    info = synthetic_scene_info(device="cpu", **SCENE)
    tr = Trainer(_trainer_cfg(), Scene(info, seed=3), device="cpu",
                 quiet=True, log_every=1, n_data=n_data)
    for it in range(1, FIRST):
        tr.train_one(it)
    losses = []
    for it in range(FIRST, LAST + 1):
        stage = tr._start(it)
        cams = [tr.scene.next_train_camera() for _ in range(n_data)]
        views = [tr._view(c) for c in cams]
        noise, time_noises = tr._sharded_noise(stage)
        zero = None if noise is None else torch.zeros_like(noise)
        tr.state, tr.opt_state, m = tr._batched_step_fn(stage, n_data)(
            tr.state, tr.opt_state, [v[0] for v in views],
            [v[2] for v in views], [v[1] for v in views],
            it - n_data + 1, active_deg=tr.active_sh_degree,
            noises=[zero] * n_data, time_noises=time_noises)
        tr._densification(it, stage)
        losses.append(float(m["loss"]))
    return tr, losses


@pytest.fixture(scope="module")
def trainers(tmp_path_factory):
    folder = tmp_path_factory.mktemp("trainer")
    cfg = {"opt": {"iterations": LAST},
           "train": {"use_time_decay": False, "xyz_noise_iteration": 1,
                     "time_noise_iteration": 1}}
    cases = [dict(n_devices=4, n_data=2, first=FIRST, last=LAST,
                  scene=SCENE, scene_seed=3, cfg=cfg)]
    spawn({"job": "trainer", "cases": cases}, folder, 4, timeout=300)
    return load_ranks(folder, 4)


def test_sharded_trainer_crosses_events(trainers):
    pre = "case0/"
    ref, ref_losses = _reference(2)
    got = trainers[0]
    assert tuple(got[pre + "counts"]) == (int(ref.state.n_alive()),
                                          int(ref.state.n_kpts()))
    assert int(ref.state.n_kpts()) > 0        # the transition ran
    np.testing.assert_allclose(got[pre + "losses"], ref_losses, rtol=3e-2)
    assert_ranks_identical(trainers, pre)
    for k, v in flatten(ref.state.params).items():
        assert np.isfinite(got[f"{pre}params/{k}"]).all(), k


def test_cli_train_two_ranks_rank0_writes(tmp_path):
    from gaussianprediction_tpu_torch.data.blender import (
        write_nerf_synthetic,
    )

    info = synthetic_scene_info(n_points=80, n_cams=8, n_test=2, width=32,
                                height=32, dynamic=True, device="cpu")
    src = tmp_path / "scene"
    write_nerf_synthetic(str(src), info.train_cameras, info.points,
                         info.colors)
    argv = [[sys.executable, "-m", "gaussianprediction_tpu_torch.cli.train",
             "-s", str(src), "-m", str(tmp_path / f"m{r}"), "--preset",
             "test", "--iterations", "14", "--jointly_iteration", "5",
             "--test_iterations", "14", "--checkpoint_iterations", "14",
             "--save_iterations", "14", "--n_devices", "2"]
            for r in range(2)]
    outs = spawn(None, tmp_path, 2, timeout=240, argv=argv,
                 extra_env={"GPT_FORCE_CPU": "1", "PYTHONPATH": REPO})
    written = sorted(os.listdir(tmp_path / "m0"))
    for name in ("cfg.json", "chkpnt14.npz", "history.json", "tb",
                 "point_cloud"):
        assert name in written, written
    assert not (tmp_path / "m1").exists()
    assert "Training complete" in outs[0]
    assert "Training complete" not in outs[1]
    with np.load(tmp_path / "m0" / "chkpnt14.npz") as f:
        assert all(np.isfinite(f[k]).all() for k in f.files
                   if f[k].dtype.kind == "f")
    hist = json.load(open(tmp_path / "m0" / "history.json"))
    assert any("eval" in h for h in hist)
