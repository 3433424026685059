"""Parity of the port's Trainer (train/loop.py) and its modules (Scene,
synthetic_scene_info, the checkpoint, the TensorBoard writer) with the JAX
package's, on the `test` preset at 32x32.

- Scene: one seed gives one training-camera sequence in both packages
  (three epochs compared).
- synthetic_scene_info: the same points, colours, cameras and test split;
  the images (the port's render against the JAX render of the same cloud)
  within 2e-5.
- A JAX checkpoint loads into the port's Trainer with params, Adam state,
  masks, statistics and iteration equal bit for bit, and the port's PLY
  of that state is the JAX package's byte for byte; the port's own
  checkpoint round-trips bit for bit, its generator state included, and
  loads through the JAX package's loader bit for bit, with the key of
  the JAX Trainer's PRNGKey(2024 * seed); so do the checkpoints of the
  brick and fourier weight models (past the stage-2 transition).
- Trajectory: the JAX Trainer saves a checkpoint at iteration 0 and runs 55
  iterations (0 -> 1 at 10; densify, prune and the capacity re-probe at
  50). The port's Trainer loads that checkpoint and runs the same 55
  iterations on the same cameras, a subclass replaying the JAX key
  sequence through the Trainer's draw methods (_step_noise,
  _densify_noise, _kmeans_start). The alive counts after the event are
  equal; the parameters and the Adam moments are held within tolerances
  set from the measured drift (f32 roundoff of two implementations,
  compounded by Adam's normalisation over 55 steps), stated below.
- training_report on the JAX run's final state: the test and train L1 and
  PSNR of both packages within render roundoff.
- A port-only run of the preset from 0 through every stage to 141 (the
  twin of tests/test_training.py::test_full_stage_progression), with its
  history, TensorBoard, PLY and checkpoint files.
- The TensorBoard writer writes the JAX writer's bytes.
- The two Trainer paths once refused run: steps_per_call > 1 trains a
  chunk in one multi-step call, profile_steps > 0 writes a trace (the
  window cut short by the run's end); n_devices > 1 without a process
  group raises naming torchrun.
"""
import copy
import os
import socket
import time

import jax
import numpy as np
import pytest
import torch

from torch_port_util import one_torch_thread, t  # noqa: F401

from gaussianprediction_tpu.config import get_preset as jget_preset
from gaussianprediction_tpu.data.scene import Scene as JScene
from gaussianprediction_tpu.models import gaussians as JG
from gaussianprediction_tpu.train import checkpoint as jckpt
from gaussianprediction_tpu.data.scene import (
    synthetic_scene_info as jsynthetic,
)
from gaussianprediction_tpu.train.loop import Trainer as JTrainer
from gaussianprediction_tpu.utils import tb_writer as jtb
from gaussianprediction_tpu_torch.config import get_preset
from gaussianprediction_tpu_torch.data.scene import (
    Scene, load_scene_info, synthetic_scene_info,
)
from gaussianprediction_tpu_torch.data.scene_types import SceneInfo
from gaussianprediction_tpu_torch.models import gaussians as G
from gaussianprediction_tpu_torch.train import checkpoint as ckpt
from gaussianprediction_tpu_torch.train.loop import Trainer
from gaussianprediction_tpu_torch.utils import tb_writer as ttb
from gaussianprediction_tpu_torch.utils.camera import Camera

SCENE = dict(n_points=80, n_cams=6, n_test=1, width=32, height=32,
             dynamic=True)
SEED = 3          # the Scene's camera-order seed
ITERS = 55        # 0 -> 1 at 10, densify / prune / re-probe at 50
CPU = "cpu"

# Trajectory tolerances, each a fraction of the leaf's largest magnitude in
# the JAX run. Measured drift at iteration 55 (torch 2.13 CPU, jax 0.9.0):
# params 1.24e-5 (motion_feature), first moments 1.26e-5, second moments
# 8.3e-6 (rotation); the largest on the way was 1.44e-4 on motion_feature
# at the first stage-1 step, while its values are ~1e-3. Each step's loss
# agreed within 2e-7 relative.
TOL_PARAMS = 1e-4
TOL_M = 1e-4
TOL_V = 1e-4
TOL_LOSS = 1e-5   # relative, every step


def _port_info(jinfo) -> SceneInfo:
    """The JAX scene's points, cameras and images as the port's SceneInfo,
    so both Trainers fit the same targets."""
    def cam(c):
        return Camera(uid=c.uid, R=c.R, T=c.T, fovx=c.fovx, fovy=c.fovy,
                      image=c.image, image_name=c.image_name, width=c.width,
                      height=c.height, time=c.time)

    train = [cam(c) for c in jinfo.train_cameras]
    test = [cam(c) for c in jinfo.test_cameras]
    return SceneInfo(points=jinfo.points, colors=jinfo.colors,
                     train_cameras=train, test_cameras=test,
                     render_cameras=test, total_frame=jinfo.total_frame)


class ReplayTrainer(Trainer):
    """The port's Trainer drawing the JAX Trainer's random numbers: the
    key comes from the JAX checkpoint it loads, and each draw method splits
    it as the JAX Trainer does at that event."""

    def load_checkpoint(self, path):
        super().load_checkpoint(path)
        with np.load(path) as f:
            self.key = jax.random.wrap_key_data(f["meta/rng_key"])

    def _next_key(self):
        self.key, k = jax.random.split(self.key)
        return k

    def _step_noise(self, stage):
        k_noise, k_time = jax.random.split(self._next_key())
        noise = None
        if stage >= 1:
            name = "xyz" if stage == 1 else "super_xyz"
            noise = t(jax.random.normal(k_noise,
                                        self.state.params[name].shape))
        time_noise = t(jax.random.normal(k_time, ())) \
            if self.cfg.train.use_time_decay else None
        return noise, time_noise

    def _densify_noise(self):
        return t(jax.random.normal(self._next_key(),
                                   (2, self.state.capacity, 3)))

    def _kmeans_start(self):
        return int(jax.random.randint(self._next_key(), (), 0,
                                      self.state.capacity))


def _flat(state, opt_state):
    return ckpt._flatten({"params": state.params, "opt": opt_state,
                          "meta": {"alive": state.alive,
                                   "kpt_alive": state.kpt_alive,
                                   **{k: getattr(state, k)
                                      for k in ckpt.STATS}}})


@pytest.fixture(scope="module")
def jinfo():
    return jsynthetic(**SCENE, interpret=True)


@pytest.fixture(scope="module")
def jax_run(jinfo, tmp_path_factory):
    """The JAX Trainer: a checkpoint at iteration 0, 55 iterations, a
    checkpoint and the training report at 55."""
    d = tmp_path_factory.mktemp("jax_run")
    cfg = jget_preset("test")
    tr = JTrainer(cfg, JScene(jinfo, seed=SEED), interpret=True, quiet=True)
    tr.save_checkpoint(str(d / "chkpnt0.npz"))
    alive, losses = [], []
    for i in range(1, ITERS + 1):
        losses.append(float(tr.train_one(i)["loss"]))
        tr.iteration = i
        if i in (49, 50):
            alive.append(int(tr.state.n_alive()))
    tr.save_checkpoint(str(d / "chkpnt55.npz"))
    report = tr.training_report(ITERS)
    return dict(dir=d, trainer=tr, alive=alive, losses=losses,
                report=report, mult=float(cfg.model.capacity_multiplier))


def test_scene_camera_sequence_matches_jax(jinfo):
    js, ts = JScene(jinfo, seed=SEED, prefetch=0), Scene(_port_info(jinfo),
                                                         seed=SEED)
    k = 3 * len(jinfo.train_cameras)
    assert [js.next_train_camera().uid for _ in range(k)] == \
        [ts.next_train_camera().uid for _ in range(k)]
    assert ts.cameras_extent == js.cameras_extent
    assert ts.total_frame == js.total_frame


def test_synthetic_scene_info_matches_jax(jinfo):
    ours = synthetic_scene_info(**SCENE, device=CPU)
    np.testing.assert_array_equal(ours.points, jinfo.points)
    np.testing.assert_array_equal(ours.colors, jinfo.colors)
    assert ours.total_frame == jinfo.total_frame
    for split in ("train_cameras", "test_cameras", "render_cameras"):
        a, b = getattr(ours, split), getattr(jinfo, split)
        assert [c.uid for c in a] == [c.uid for c in b], split
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x.R, y.R)
            np.testing.assert_array_equal(x.T, y.T)
            assert (x.time, x.fovx, x.fovy) == (y.time, y.fovx, y.fovy)
            assert x.image.shape == (32, 32, 3) and x.image.max() > 0.1
            np.testing.assert_allclose(x.image, y.image, rtol=0, atol=2e-5)


def test_jax_checkpoint_loads_bit_for_bit(jinfo, jax_run, tmp_path):
    path = str(jax_run["dir"] / "chkpnt55.npz")
    tr = Trainer(get_preset("test"), Scene(_port_info(jinfo)), device=CPU,
                 quiet=True)
    tr.load_checkpoint(path)
    assert tr.iteration == ITERS
    ours = _flat(tr.state, tr.opt_state)
    with np.load(path) as f:
        ref = {k: f[k] for k in f.files
               if k not in ("meta/iteration", "meta/rng_key")}
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        assert ours[k].dtype == v.dtype, k
        assert ours[k].tobytes() == v.tobytes(), k
    # and its PLY is the JAX package's, byte for byte
    G.save_ply(tr.state, str(tmp_path / "port.ply"))
    JG.save_ply(jax_run["trainer"].state, str(tmp_path / "jax.ply"))
    assert (tmp_path / "port.ply").read_bytes() == \
        (tmp_path / "jax.ply").read_bytes()


def test_port_checkpoint_loads_in_jax(jinfo, jax_run, tmp_path):
    """The port's Trainer, two iterations past the JAX checkpoint at 55,
    writes a checkpoint that the JAX loader reads with the JAX Trainer's
    templates: every array equal bit for bit, the iteration, and the key
    data of PRNGKey(2024 * seed)."""
    seed = 5
    tr = Trainer(get_preset("test"), Scene(_port_info(jinfo), seed=SEED),
                 seed=seed, device=CPU, quiet=True)
    tr.load_checkpoint(str(jax_run["dir"] / "chkpnt55.npz"))
    for i in (ITERS + 1, ITERS + 2):
        tr.train_one(i)
        tr.iteration = i
    path = str(tmp_path / "port.npz")
    tr.save_checkpoint(path)
    j = jax_run["trainer"]
    state, opt_state, iteration, key = jckpt.load_checkpoint(
        path, j.state, j.opt_state)
    assert iteration == ITERS + 2
    x = 2024 * seed
    np.testing.assert_array_equal(jax.random.key_data(key),
                                  np.array([x >> 32, x & 0xFFFFFFFF]))
    ours = _flat(tr.state, tr.opt_state)
    theirs = ckpt._flatten({"params": state.params, "opt": opt_state,
                            "meta": {"alive": state.alive,
                                     "kpt_alive": state.kpt_alive,
                                     **{k: getattr(state, k)
                                        for k in ckpt.STATS}}})
    assert sorted(ours) == sorted(theirs)
    for k, v in theirs.items():
        assert ours[k].dtype == v.dtype, k
        assert ours[k].tobytes() == v.tobytes(), k


@pytest.mark.parametrize("enc", ["brick", "fourier"])
def test_encoder_checkpoint_loads_in_jax(jinfo, enc, tmp_path):
    """A port checkpoint of a brick or fourier model, two stage-2
    iterations past the transition, loads through the JAX loader with
    templates from the JAX create_from_pcd of the same encoder: the same
    tree (brick tables of the JAX shapes; no hash tables for fourier),
    every array equal bit for bit."""
    from gaussianprediction_tpu.train import optimizer as jopt

    cfg = get_preset("test")
    cfg.model.weight_encoder = enc
    tr = Trainer(cfg, Scene(_port_info(jinfo), seed=SEED), seed=5,
                 device=CPU, quiet=True)
    it = cfg.train.second_stage_iteration + 1
    for i in (it, it + 1):
        tr.train_one(i)
        tr.iteration = i
    assert int(tr.state.n_kpts()) == cfg.model.max_points
    path = str(tmp_path / f"{enc}.npz")
    tr.save_checkpoint(path)
    jc = jget_preset("test")
    jc.model.weight_encoder = enc
    info = tr.scene.info
    tmpl = jax.eval_shape(lambda k: JG.create_from_pcd(
        k, jc, info.points, info.colors), jax.random.PRNGKey(0))
    opt_tmpl = jax.eval_shape(jopt.init_adam, tmpl.params)
    assert ("hash_tables" in tmpl.params) == (enc == "brick")
    state, opt_state, iteration, _ = jckpt.load_checkpoint(path, tmpl,
                                                           opt_tmpl)
    assert iteration == it + 1
    for a, b in zip(jax.tree.leaves(state.params),
                    jax.tree.leaves(tmpl.params)):
        assert a.shape == b.shape and a.dtype == b.dtype
    ours = _flat(tr.state, tr.opt_state)
    theirs = ckpt._flatten({"params": state.params, "opt": opt_state,
                            "meta": {"alive": state.alive,
                                     "kpt_alive": state.kpt_alive,
                                     **{k: getattr(state, k)
                                        for k in ckpt.STATS}}})
    assert sorted(ours) == sorted(theirs)
    for k, v in theirs.items():
        assert ours[k].tobytes() == v.tobytes(), k


def test_trajectory_matches_jax(jinfo, jax_run):
    cfg = get_preset("test")
    tr = ReplayTrainer(cfg, Scene(_port_info(jinfo), seed=SEED),
                       device=CPU, quiet=True)
    tr.load_checkpoint(str(jax_run["dir"] / "chkpnt0.npz"))
    alive, losses = [], []
    for i in range(1, ITERS + 1):
        m = tr.train_one(i)
        tr.iteration = i
        assert int(m["n_dropped"]) == 0
        losses.append(float(m["loss"]))
        if i in (49, 50):
            alive.append(int(tr.state.n_alive()))
    np.testing.assert_allclose(losses, jax_run["losses"], rtol=TOL_LOSS)
    # the densify event grew the model, identically
    assert alive == jax_run["alive"] and alive[1] > alive[0]
    assert float(cfg.model.capacity_multiplier) == jax_run["mult"]
    j = jax_run["trainer"]
    assert torch.equal(tr.state.alive, t(j.state.alive))
    ours = _flat(tr.state, tr.opt_state)
    ref = ckpt._flatten({"params": j.state.params, "opt": j.opt_state})
    for k, v in ref.items():
        tol = TOL_M if k.startswith("opt/m/") else TOL_V \
            if k.startswith("opt/v/") else TOL_PARAMS
        if k == "opt/step":
            assert int(ours[k]) == int(v)
            continue
        scale = max(float(np.abs(v).max()), 1e-30)
        np.testing.assert_allclose(ours[k], v, rtol=0, atol=tol * scale,
                                   err_msg=k)


def test_training_report_matches_jax(jinfo, jax_run):
    tr = Trainer(get_preset("test"), Scene(_port_info(jinfo)), device=CPU,
                 quiet=True)
    tr.load_checkpoint(str(jax_run["dir"] / "chkpnt55.npz"))
    ours, ref = tr.training_report(ITERS), jax_run["report"]
    assert sorted(ours) == sorted(ref)
    for k in ("test_l1", "train_l1"):
        assert abs(ours[k] - ref[k]) <= 1e-5, k
    for k in ("test_psnr", "train_psnr"):
        assert abs(ours[k] - ref[k]) <= 1e-3, k


def test_full_stage_progression_and_checkpoint_round_trip(tmp_path):
    cfg = get_preset("test")
    cfg.train.test_iterations = (70,)
    cfg.train.save_iterations = (140,)
    cfg.train.checkpoint_iterations = (100,)
    info = synthetic_scene_info(**SCENE, device=CPU)
    tr = Trainer(cfg, Scene(info), device=CPU, quiet=True, log_every=20)
    hist = tr.run(iterations=140, model_path=str(tmp_path))
    assert tr.iteration == 140
    assert int(tr.state.n_kpts()) >= cfg.model.max_points
    m = tr.train_one(141)
    assert np.isfinite(float(m["loss"]))
    logged = [h for h in hist if "loss" in h]
    assert [h["iter"] for h in logged] == list(range(20, 141, 20))
    assert all(h["n_dropped"] == 0 for h in logged)
    assert [h["eval"]["iter"] for h in hist if "eval" in h] == [70]
    assert (tmp_path / "history.json").exists()
    assert (tmp_path / "point_cloud/iteration_140/point_cloud.ply").exists()
    (ev,) = os.listdir(tmp_path / "tb")
    tags = {v["tag"] for e in ttb.read_events(str(tmp_path / "tb" / ev))
            for v in e.get("values", [])}
    assert {"train/psnr", "test/loss_viewpoint_psnr",
            "scene/opacity_histogram"} <= tags

    # the port's own checkpoint round-trips bit for bit
    path = str(tmp_path / "chkpnt100.npz")
    a = Trainer(copy.deepcopy(cfg), Scene(info), device=CPU, quiet=True)
    a.load_checkpoint(path)
    a.save_checkpoint(str(tmp_path / "again.npz"))
    b = Trainer(copy.deepcopy(cfg), Scene(info), seed=9, device=CPU,
                quiet=True)
    b.load_checkpoint(str(tmp_path / "again.npz"))
    assert a.iteration == b.iteration == 100
    fa, fb = _flat(a.state, a.opt_state), _flat(b.state, b.opt_state)
    with np.load(path) as f:
        assert sorted(fa) == sorted(k for k in f.files
                                    if k not in ("meta/iteration",
                                                 "meta/rng_key",
                                                 ckpt.GENERATOR_KEY))
        np.testing.assert_array_equal(f["meta/rng_key"],
                                      ckpt.jax_key_data(cfg.train.seed))
        for k, v in fa.items():
            assert v.dtype == f[k].dtype and v.tobytes() == f[k].tobytes()
            assert fb[k].tobytes() == v.tobytes(), k
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    assert torch.equal(a._randn((5,)), b._randn((5,)))


def test_tb_writer_writes_the_jax_bytes(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1700000000.25)
    monkeypatch.setattr(socket, "gethostname", lambda: "host")
    img = np.random.default_rng(0).uniform(0, 1, (8, 6, 3))
    vals = np.random.default_rng(1).normal(size=500)
    paths = []
    for mod, d in ((jtb, "jax"), (ttb, "port")):
        w = mod.SummaryWriter(str(tmp_path / d))
        for step, x in enumerate((0.5, 0.25, 1e-7)):
            w.add_scalar("train/psnr", x, step)
        w.add_image("test/render", img, 3)
        w.add_histogram("scene/opacity_histogram", vals, 3)
        w.flush()
        w.close()
        paths.append(w.path)
    a, b = (open(p, "rb").read() for p in paths)
    assert a == b and len(a) > 500


def test_unported_paths_raise(jinfo, tmp_path, monkeypatch):
    info = _port_info(jinfo)
    chunks = []
    orig = Trainer.train_chunk
    monkeypatch.setattr(Trainer, "train_chunk", lambda self, a, b: (
        chunks.append((a, b)), orig(self, a, b))[1])
    tr = Trainer(get_preset("test"), Scene(info), device=CPU, quiet=True,
                 steps_per_call=4)
    tr.run(iterations=6)
    # [1, 4] in one call; 5 and 6 are no whole chunk and run alone
    assert chunks == [(1, 4), (5, 5), (6, 6)] and tr.iteration == 6
    # several devices are ported; they need torchrun's process group
    with pytest.raises(RuntimeError, match="torchrun --standalone"):
        Trainer(get_preset("test"), Scene(info), device=CPU, quiet=True,
                n_devices=2)
    cfg = get_preset("test")
    cfg.train.profile_steps, cfg.train.profile_from = 3, 1
    tr = Trainer(cfg, Scene(info), device=CPU, quiet=True)
    tr.run(iterations=2, model_path=str(tmp_path))
    assert tr.iteration == 2
    assert os.listdir(tmp_path / "profile") == ["trace_iter1-2.json"]
    # the loaders are ported: a directory that holds no scene is refused
    with pytest.raises(ValueError, match="Could not recognize scene type"):
        load_scene_info(get_preset("test"))
