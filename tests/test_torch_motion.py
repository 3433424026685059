"""Parity of the port's motion extrapolation (models/gcn.py,
motion/gcn_train.py, motion/dataset.py, the GCN conversion in convert.py,
the render entry points of eval/render.py) with the JAX package.

The GCN is the JAX init_gcn_xyzr tree carried into the port by
convert.py:gcn_from_arrays (K = 5 keypoints, linear_size 32, num_stage 2,
the MLP head and no_mapping).

- Forward: within 1e-5 of max(1, the largest |value|) in train and eval
  mode, the batch-norm running statistics after a train-mode call too,
  and at B = 1 in train mode (which nn.BatchNorm1d refuses). The graph-
  conv head's outputs reach |7.5|, where XLA's and torch's GEMM sums part
  by up to 1.4e-5.
- One training step from the same model and batch: the loss within 1e-5
  relative, every gradient within 1e-3 of its leaf's largest magnitude.
  The batch norms divide by sqrt(var + 1e-5) over 8 samples: the port's
  f32 gradients differ from its own f64 ones by up to 3e-4 of a leaf's
  largest magnitude, JAX's from the port's by up to 3.3e-4. The biases of
  the graph convolutions that feed a batch norm are left out here and
  below: the batch norm subtracts them again, so their exact gradient is
  0 and both packages hold roundoff (1e-8 to 1e-5).
- train_gcn from the tree JAX's train_gcn makes (PRNGKey(seed), split,
  init_gcn_xyzr), 5 epochs with the noise on and the same numpy seed, one
  step an epoch (20 windows, batch 16): the loss history within rtol
  1e-4, the final parameters and batch-norm running variances within
  2e-4 of each leaf's largest magnitude (the running means absorb the
  graph-conv biases and are left out). Measured: loss 1.2e-6, parameters
  9.6e-5. Adam with eps 1e-15 first steps each element by lr · sign(g),
  so an element whose gradient lies within f32 roundoff of 0 moves ±lr
  either way in either package: at batch 8 (ten steps) such flips part
  the rotation branch by up to 5e-2 of a leaf's magnitude. That is f32
  roundoff, not the algorithm.
- The rollout of 20 frames from one model: within 1e-4 of the
  trajectory's largest |value|.
- GCN checkpoints both ways: a JAX-written one loads in the port (rollout
  within 1e-5), a port-written one loads through the JAX loader with
  arrays equal bit for bit, and the port's own save/load rolls out
  bit-identically.

extract_trajectories runs on a `test`-preset stage-2 model of 16 blobs
made as tests/test_torch_stage23.py makes it (the JAX create_from_pcd and
set_super_keypoints, carried over by convert.py), past the keypoint-noise
anneal and inside it with the JAX draw handed over: within 1e-5.
build_windows and times_from_scene are held to JAX's exactly.

render_kpts (keypoints from the extracted trajectories), render_video and
render_train_sequence render that model past the anneal at 64x64 beside
the JAX functions (Pallas in interpret mode), at the tolerance
tests/test_torch_render.py holds render_set to (rgb 2e-5); save_video
writes an mp4 or, without an ffmpeg backend, the PNG frames.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import n, one_torch_thread, t  # noqa: F401

from gaussianprediction_tpu import config as jcfg
from gaussianprediction_tpu.data.synthetic import orbit_camera
from gaussianprediction_tpu.eval import render as JR
from gaussianprediction_tpu.models import gcn as JG
from gaussianprediction_tpu.models import gaussians as jgauss
from gaussianprediction_tpu.motion import dataset as JD
from gaussianprediction_tpu.motion import gcn_train as JT
from gaussianprediction_tpu.train import loop as jloop
from gaussianprediction_tpu_torch import config as tcfg
from gaussianprediction_tpu_torch.convert import (
    gcn_from_arrays, gcn_to_arrays, state_from_params,
)
from gaussianprediction_tpu_torch.data.synthetic import (
    orbit_camera as torbit,
)
from gaussianprediction_tpu_torch.eval import render as TR
from gaussianprediction_tpu_torch.motion import dataset as TD
from gaussianprediction_tpu_torch.motion import gcn_train as TT

K = 5
CPU = torch.device("cpu")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_init(seed, cfg, n_kpts, no_mapping=False):
    """The initial tree exactly as JAX's train_gcn makes it."""
    key = jax.random.PRNGKey(seed)
    key, k_init = jax.random.split(key)
    return JG.init_gcn_xyzr(k_init, cfg.input_size, cfg.linear_size,
                            cfg.output_size, cfg.num_stage, n_kpts,
                            no_mapping)


def _windows(n_t=40, n_kpts=K, seed=0):
    """Smooth keypoint trajectories and their 10 -> 1 training windows."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(-1, 1, (n_kpts, 3))
    amp = rng.uniform(0.1, 0.3, (n_kpts, 3))
    phase = rng.uniform(0, 2 * np.pi, (n_kpts, 3))
    ts = np.linspace(0, 2.0, n_t)
    xyz = (base[None] + amp[None] * np.sin(
        np.pi * ts[:, None, None] + phase[None])).astype(np.float32)
    # unit quaternions about a fixed random axis per keypoint, every
    # component moving (a component constant over the windows would hand
    # the batch norm a feature of zero variance)
    axis = rng.normal(size=(n_kpts, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    ang = 0.6 * np.sin(np.pi * ts)[:, None] + rng.uniform(0.2, 1.0, n_kpts)
    rot = np.concatenate([np.cos(ang)[..., None],
                          np.sin(ang)[..., None] * axis[None]],
                         axis=-1).astype(np.float32)
    traj = JD.TrajectoryData(xyz[:30], rot[:30], xyz[30:], rot[30:],
                             list(ts[:30]), list(ts[30:]), n_kpts)
    return traj, JD.build_windows(traj, 10, 1, "train")


def _exact_zero_grad(key):
    """The biases of graph convolutions that feed a batch norm."""
    return "/gc" in key and key.endswith("/bias")


def _leaf_close(a, b, rel, what):
    for k in b:
        if _exact_zero_grad(k) or k.endswith("/mean"):
            continue
        scale = max(float(np.abs(b[k]).max()), 1e-30)
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=rel * scale,
                                   err_msg=f"{what}: {k}")


def _close(ours, ref, rel=1e-5):
    ref = np.asarray(ref)
    np.testing.assert_allclose(n(ours), ref, rtol=0,
                               atol=rel * max(1.0, np.abs(ref).max()))


def _jax_flat(params, bn):
    from gaussianprediction_tpu.train.checkpoint import _flatten

    return {k: np.asarray(v)
            for k, v in _flatten({"params": params, "bn": bn}).items()}


@pytest.mark.parametrize("no_mapping", [False, True],
                         ids=["mlp_head", "no_mapping"])
@pytest.mark.parametrize("batch", [6, 1])
def test_gcn_forward_matches_jax(no_mapping, batch):
    params, bn = JG.init_gcn_xyzr(jax.random.PRNGKey(3), 10, 32, 1, 2, K,
                                  no_mapping)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(batch, 3, K, 10)).astype(np.float32)
    r = rng.normal(size=(batch, 4, K, 10)).astype(np.float32)
    model = gcn_from_arrays(_np_tree(params), _np_tree(bn), "cpu")
    assert gcn_to_arrays(model).keys() == _jax_flat(params, bn).keys()
    # train mode: batch statistics and the running-statistics update
    xo, ro, bn2 = JG.gcn_xyzr_apply(params, bn, jnp.asarray(x),
                                    jnp.asarray(r), train=True)
    model.train()
    with torch.no_grad():
        txo, tro = model(t(x), t(r))
    _close(txo, xo)
    _close(tro, ro)
    ours = gcn_to_arrays(model)
    for k, v in _jax_flat(params, bn2).items():
        _close(ours[k], v)
    # eval mode from the moved statistics
    xo, ro, bn3 = JG.gcn_xyzr_apply(params, bn2, jnp.asarray(x),
                                    jnp.asarray(r), train=False)
    model.eval()
    with torch.no_grad():
        txo, tro = model(t(x), t(r))
    _close(txo, xo)
    _close(tro, ro)
    assert np.array_equal(gcn_to_arrays(model)["bn/rot/bn1/var"],
                          ours["bn/rot/bn1/var"])


def test_gcn_init_from_generator_is_seeded():
    cfg = TT.GCNConfig(linear_size=16, num_stage=1)
    a = gcn_to_arrays(TT.init_gcn(cfg, K, seed=7, device="cpu"))
    b = gcn_to_arrays(TT.init_gcn(cfg, K, seed=7, device="cpu"))
    c = gcn_to_arrays(TT.init_gcn(cfg, K, seed=8, device="cpu"))
    assert all(np.array_equal(a[k], b[k]) for k in a)
    w = a["params/xyz/gc1/weight"]
    assert not np.array_equal(w, c["params/xyz/gc1/weight"])
    # U(±1/sqrt(out_f)) for the graph convolutions, ±1/sqrt(in_f) the head
    assert np.abs(w).max() <= 1 / np.sqrt(16)
    assert np.array_equal(a["params/xyz/bn1/scale"], np.ones(15 * 16))


@pytest.fixture(scope="module")
def jax_training():
    """JAX's train_gcn over 5 epochs with the noise on, and its start."""
    _, w = _windows()
    cfg = JT.GCNConfig(input_size=10, output_size=1, linear_size=32,
                       num_stage=2, epochs=5, batch_size=16, noise_init=0.05,
                       noise_step=4, norm_rotation=True)
    init = _jax_init(11, cfg, K)
    params, bn, hist = JT.train_gcn(w, K, cfg, seed=11, verbose=False)
    return w, cfg, init, (params, bn, hist)


def _tcfg(jc):
    import dataclasses

    return TT.GCNConfig(**dataclasses.asdict(jc))


def test_train_gcn_matches_jax(jax_training):
    w, jc, (p0, bn0), (params, bn, hist) = jax_training
    start = gcn_from_arrays(_np_tree(p0), _np_tree(bn0), "cpu")
    model, thist = TT.train_gcn(w, K, _tcfg(jc), seed=11, verbose=False,
                                model=start)
    assert model is start and len(thist) == len(hist) == 5
    np.testing.assert_allclose(thist, hist, rtol=1e-4)
    _leaf_close(gcn_to_arrays(model), _jax_flat(params, bn), 2e-4,
                "after 5 epochs")


def test_train_step_matches_jax(jax_training):
    """The loss and gradients of one step from the JAX start model."""
    w, jc, (p0, bn0), _ = jax_training
    sel = np.arange(8)
    batch = [a[sel] for a in (w.xyz_inputs, w.rot_inputs, w.xyz_gt,
                              w.rot_gt)]
    xi, ri, xg, rg = (jnp.asarray(a) for a in batch)

    def loss_fn(params):
        xo, ro, _ = JT.gcn_forward(params, bn0, xi, ri, jc, train=True)
        return jnp.mean(jnp.linalg.norm(xo - xg, axis=-1)) + jnp.mean(
            jnp.linalg.norm(ro - rg, axis=-1))

    loss, grads = jax.value_and_grad(loss_fn)(p0)
    ref = {f"params/{k}": v for k, v in _jax_flat(grads, {}).items()
           if k.startswith("params/")}
    ref = {k[len("params/params/"):]: v for k, v in ref.items()}
    model = gcn_from_arrays(_np_tree(p0), _np_tree(bn0), "cpu")
    tloss, tgrads = TT.train_step(model, TT.init_adam(model), 0.01,
                                  *[t(a) for a in batch], _tcfg(jc))
    assert float(tloss) == pytest.approx(float(loss), rel=1e-5)
    names = [k[len("params/"):] for k in gcn_to_arrays(model)
             if k.startswith("params/")]
    assert sorted(names) == sorted(ref)
    for k, g in zip(names, tgrads):
        if _exact_zero_grad(k):
            # roundoff around 0: small beside the layer's weight gradient
            assert np.abs(ref[k]).max() < 1e-3 * np.abs(
                ref[k.replace("bias", "weight")]).max()
            continue
        scale = np.abs(ref[k]).max()
        np.testing.assert_allclose(n(g), ref[k], rtol=0, atol=1e-3 * scale,
                                   err_msg=k)


def test_rollout_matches_jax(jax_training):
    w, jc, _, (params, bn, _) = jax_training
    traj, _ = _windows()
    xw, rw = traj.kpts_xyz_train[-10:], traj.kpts_r_train[-10:]
    jk, jr = JT.rollout(params, bn, jc, xw, rw, frames=20)
    model = gcn_from_arrays(_np_tree(params), _np_tree(bn), "cpu")
    tk, tr = TT.rollout(model, _tcfg(jc), xw, rw, frames=20)
    assert tk.shape == (20, K, 3) and tr.shape == (20, K, 4)
    np.testing.assert_allclose(tk, jk, rtol=0, atol=1e-4 * np.abs(jk).max())
    np.testing.assert_allclose(tr, jr, rtol=0, atol=1e-4 * np.abs(jr).max())


def test_gcn_checkpoints_cross_both_ways(jax_training, tmp_path):
    w, jc, _, (params, bn, hist) = jax_training
    traj, _ = _windows()
    xw, rw = traj.kpts_xyz_train[-10:], traj.kpts_r_train[-10:]
    # JAX-written -> the port
    jpath = str(tmp_path / "jax_gcn_ckpt.npz")
    JT.save_gcn_checkpoint(jpath, params, bn, jc, K, hist)
    model, cfg, n_kpts, thist = TT.load_gcn_checkpoint(jpath, device="cpu")
    assert cfg == _tcfg(jc) and n_kpts == K and thist == pytest.approx(
        hist, rel=1e-6)
    jk, jr = JT.rollout(params, bn, jc, xw, rw, frames=6)
    tk, tr = TT.rollout(model, cfg, xw, rw, frames=6)
    np.testing.assert_allclose(tk, jk, rtol=0, atol=1e-5 * np.abs(jk).max())
    np.testing.assert_allclose(tr, jr, rtol=0, atol=1e-5 * np.abs(jr).max())
    # port-written -> JAX, bit for bit
    tpath = str(tmp_path / "gcn_ckpt.npz")
    TT.save_gcn_checkpoint(tpath, model, cfg, n_kpts, thist)
    p2, bn2, jcfg2, n2, hist2 = JT.load_gcn_checkpoint(tpath)
    assert jcfg2 == jc and n2 == K and hist2 == thist
    ours = gcn_to_arrays(model)
    theirs = _jax_flat(p2, bn2)
    assert ours.keys() == theirs.keys()
    for k in ours:
        assert ours[k].dtype == theirs[k].dtype
        assert np.array_equal(ours[k].view(np.int32),
                              theirs[k].view(np.int32)), k
    with np.load(tpath) as a, np.load(jpath) as b:
        assert sorted(a.files) == sorted(b.files)
    # the port's own round trip rolls out bit-identically
    m2, cfg2, _, _ = TT.load_gcn_checkpoint(tpath, device="cpu")
    k2, r2 = TT.rollout(m2, cfg2, xw, rw, frames=6)
    assert np.array_equal(k2, tk) and np.array_equal(r2, tr)


def test_build_windows_and_times_match_jax():
    traj, _ = _windows()
    ttraj = TD.TrajectoryData(*traj)
    for split, (i, o) in (("train", (10, 1)), ("test", (10, 1)),
                          ("test", (4, 3)), ("train", (40, 1))):
        a = JD.build_windows(traj, i, o, split)
        b = TD.build_windows(ttraj, i, o, split)
        for x, y in zip(a, b):
            assert x.shape == y.shape and x.dtype == y.dtype
            assert np.array_equal(x, y)
    from gaussianprediction_tpu.data.synthetic import orbit_camera

    cams = [orbit_camera(0.1 * i, width=8, height=8, time=tt, uid=i)
            for i, tt in enumerate([0.5, 0.1, 0.9, 0.79, 0.8, 0.3])]

    class Info:
        train_cameras, test_cameras = cams[:4], cams[4:]

    assert TD.times_from_scene(Info, 0.8) == JD.times_from_scene(Info, 0.8)


@pytest.fixture(scope="module")
def stage2_model():
    """A JAX `test`-preset stage-2 model of 16 blobs (keypoints set)."""
    jc = jcfg.get_preset("test")
    rng = np.random.default_rng(0)
    n_pts = 400
    centers = rng.uniform(-0.8, 0.8, (16, 3))
    pts = (np.repeat(centers, n_pts // 16, 0)
           + rng.normal(0, 0.03, (n_pts, 3))).astype(np.float32)
    cols = rng.uniform(0, 1, (n_pts, 3)).astype(np.float32)
    js = jax.jit(lambda k: jgauss.create_from_pcd(k, jc, pts, cols))(
        jax.random.PRNGKey(0))
    C = js.capacity
    feat = np.zeros((C, jc.model.feature_dim), np.float32)
    feat[:n_pts] = (np.repeat(rng.normal(0, 0.3, (16, feat.shape[1])),
                              n_pts // 16, 0)
                    + rng.normal(0, 0.01, (n_pts, feat.shape[1])))
    params = dict(js.params)
    params["motion_feature"] = jnp.asarray(feat)
    js = js.replace(params=params)
    js = jax.jit(lambda s, k: jloop.set_super_keypoints(s, jc, k))(
        js, jax.random.PRNGKey(9))
    ts = state_from_params(_np_tree(js.params), np.asarray(js.alive),
                           np.asarray(js.kpt_alive), device="cpu")
    return jc, js, ts


@pytest.mark.parametrize("past_anneal", [True, False],
                         ids=["past_anneal", "inside_anneal"])
def test_extract_trajectories_matches_jax(stage2_model, past_anneal):
    jc, js, ts = stage2_model
    s2 = jc.train.second_stage_iteration
    it = s2 + jc.train.xyz_noise_iteration + 5 if past_anneal else s2 + 3
    times = [0.0, 0.13, 0.4, 0.77]
    ref = JD.extract_trajectories(js, jc, times[:3], times[3:], it)
    # the draw JAX's PRNGKey(0) gives every timestamp
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(0),
                                         js.params["super_xyz"].shape))
    ours = TD.extract_trajectories(
        ts, tcfg.get_preset("test"), times[:3], times[3:], it,
        noise=None if past_anneal else t(noise))
    assert ours.n_kpts == ref.n_kpts == int(js.n_kpts()) > 0
    assert ours.train_times == ref.train_times
    for a, b in zip(ours[:4], ref[:4]):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * np.abs(b).max())
    if not past_anneal:     # the draw matters inside the anneal
        other = TD.extract_trajectories(ts, tcfg.get_preset("test"),
                                        times[:1], [], it)
        assert not np.allclose(other.kpts_xyz_train, ref.kpts_xyz_train[:1],
                               rtol=0, atol=1e-5)


def _past_anneal(jc):
    return jc.train.second_stage_iteration + jc.train.xyz_noise_iteration + 5


def _views(mod, times, theta0=0.6):
    return [mod(theta0 + 0.5 * i, width=64, height=64, time=tt, uid=i)
            for i, tt in enumerate(times)]


def _frames_close(ours, ref):
    assert len(ours) == len(ref) > 0
    for a, b in zip(ours, ref):
        assert a.shape == b.shape == (64, 64, 3)
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=2e-5)
    assert max(float(np.ptp(a)) for a in ours) > 0.05


def test_render_kpts_matches_jax(stage2_model, tmp_path):
    jc, js, ts = stage2_model
    it = _past_anneal(jc)
    times = [0.1, 0.35, 0.6]
    traj = JD.extract_trajectories(js, jc, times, [], it)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    # two views for three frames: the last frame reuses the last view
    ref = JR.render_kpts(js, jc, it, _views(orbit_camera, times[:2]), bg,
                         traj.kpts_xyz_train, traj.kpts_r_train,
                         interpret=True)
    stats = {}
    ours = TR.render_kpts(ts, tcfg.get_preset("test"), it,
                          _views(torbit, times[:2]), bg,
                          traj.kpts_xyz_train, traj.kpts_r_train,
                          out_dir=str(tmp_path), stats=stats)
    _frames_close(ours, ref)
    assert stats["n_dropped"] == [0, 0, 0] and len(stats["ms"]) == 3
    assert sorted(p.name for p in (tmp_path / "renders").iterdir()) == [
        "00000.png", "00001.png", "00002.png"]
    # view_id pins one view for every frame
    views = _views(torbit, times[:2])
    one = TR.render_kpts(ts, tcfg.get_preset("test"), it, views, bg,
                         traj.kpts_xyz_train[:1], traj.kpts_r_train[:1],
                         view_id=1)
    again = TR.render_kpts(ts, tcfg.get_preset("test"), it, views[1:], bg,
                           traj.kpts_xyz_train[:1], traj.kpts_r_train[:1])
    assert np.array_equal(one[0], again[0])


def test_render_video_and_train_sequence_match_jax(stage2_model, tmp_path):
    jc, js, ts = stage2_model
    it = _past_anneal(jc)
    tc = tcfg.get_preset("test")
    bg = np.zeros(3, np.float32)
    times = [0.2, 0.5, 0.8]
    ref = JR.render_video(js, jc, it, _views(orbit_camera, times), bg,
                          interpolation=2, interpret=True)
    stats = {}
    ours = TR.render_video(ts, tc, it, _views(torbit, times), bg,
                           interpolation=2, stats=stats,
                           out_path=str(tmp_path / "video.mp4"))
    _frames_close(ours, ref)
    assert len(ours) == 4 and stats["n_dropped"] == [0] * 4
    written = sorted(p.name for p in tmp_path.iterdir())
    assert written in (["video.mp4"],
                       [f"video_{i:05d}.png" for i in range(4)])
    train_views = _views(orbit_camera, times)
    ref = JR.render_train_sequence(js, jc, it, train_views,
                                   _views(orbit_camera, [0.0])[0], bg,
                                   interpret=True)
    ours = TR.render_train_sequence(ts, tc, it, _views(torbit, times),
                                    _views(torbit, [0.0])[0], bg,
                                    out_dir=str(tmp_path / "seq"))
    _frames_close(ours, ref)
    assert len(os.listdir(tmp_path / "seq")) == 3
