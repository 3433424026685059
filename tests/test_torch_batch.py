"""Parity of the port's gradient accumulation (train/step.py:
make_train_step_batched, train/loop.py: Trainer.train_batch) with the JAX
package's make_train_step_batched, and the Trainer's batch > 1 loop.

A `test`-preset model (300 Gaussians, 7 of them dead, SH degree 1, the
d=2 w=32 deform MLP) with random densification statistics and Adam second
moments (first moments 0, so the update stays smooth in the gradient, as
tests/test_torch_train.py starts it) takes one batched step of 3 members
at stage 1 (iteration 30, inside the noise anneals, time decay on) in
both packages at 32x32. The JAX step draws each member's xyz and time
noise from its key; the test draws the same numbers with jax.random and
hands them to the port. The views hold no Gaussian whose capped rect
has width but no height: for one the JAX stream emits a phantom
instance that misaligns its backward's runs (found in the reference,
tests/test_torch_stream.py::test_zero_height_rect_holds_no_instance;
the port emits none), and the JAX gradients there are not the reference's
to hold the port to. Held, with the JAX package's own bar for this
step (tests/test_training.py::TestBatchAccumulation): the loss (the sum
of the members') to 1e-5 relative and every parameter to 1e-6; the
statistics (radii by max, visibility by any, the summed screen-space
gradient's norm) as tests/test_torch_train.py holds them. Within the
port, the batched step's gradients are the members' single-render
gradients summed in member order, bit for bit.

The Trainer with cfg.train.batch = 2 runs the preset through the 0 -> 1
transition: train_batch takes the pairs that hold no host event, single
iterations the rest, and the parameters stay finite.
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
from gaussianprediction_tpu.train import step as jstep
from gaussianprediction_tpu_torch import config as tcfg
from gaussianprediction_tpu_torch.convert import (
    opt_state_from_arrays, state_from_params,
)
from gaussianprediction_tpu_torch.data.scene import (
    Scene, synthetic_scene_info,
)
from gaussianprediction_tpu_torch.data.synthetic import (
    orbit_camera as torbit,
)
from gaussianprediction_tpu_torch.train import optimizer as topt
from gaussianprediction_tpu_torch.train import step as tstep
from gaussianprediction_tpu_torch.train.loop import Trainer

W = H = 32
N = 300
B = 3
IT0 = 30
TOTAL_FRAME = 20
EXTENT = 1.3
TIMES = (0.1, 0.45, 0.8)


def _start():
    _, tc = jcfg.get_preset("test"), tcfg.get_preset("test")
    params, alive = stage1_params(tc, N, seed=21)
    rng = np.random.default_rng(22)
    stats = {
        "xyz_gradient_accum": rng.uniform(0, 1e-3, N).astype(np.float32),
        "xyz_gradient_accum_max": rng.uniform(0, 1e-4, N).astype(
            np.float32),
        "denom": rng.integers(0, 5, N).astype(np.float32),
        "max_radii2D": rng.integers(0, 9, N).astype(np.int32),
        "xyz_motion_accum_max": np.zeros(N, np.float32),
        "motion_denom": np.zeros(N, np.float32),
    }

    def second(x):
        s = np.abs(x).mean() + 1e-3
        return ((0.2 * s) ** 2 * rng.uniform(0.5, 1.5, x.shape)).astype(
            np.float32)

    opt = {"m": jax.tree.map(np.zeros_like, params),
           "v": jax.tree.map(second, params), "step": np.int32(4)}
    return params, alive, stats, opt


@pytest.fixture(scope="module")
def batched():
    jc, tc = jcfg.get_preset("test"), tcfg.get_preset("test")
    for c in (jc, tc):
        c.train.use_time_decay = True
    params, alive, stats, opt = _start()
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    views = [orbit_camera(0.4 + 0.8 * j, width=W, height=H, time=tm)
             for j, tm in enumerate(TIMES)]
    tviews = [torbit(0.4 + 0.8 * j, width=W, height=H, time=tm)
              for j, tm in enumerate(TIMES)]
    gts = np.random.default_rng(23).uniform(0, 1, (B, H, W, 3)).astype(
        np.float32)
    key = jax.random.PRNGKey(7)
    keys = jax.random.split(key, 2 * B).reshape(B, 2, -1)
    xyz_noise = [np.asarray(jax.random.normal(keys[j, 0], (N, 3)))
                 for j in range(B)]
    time_noise = [np.asarray(jax.random.normal(keys[j, 1], ()))
                  for j in range(B)]

    js = jax_state(params, alive).replace(
        **{k: jnp.asarray(v) for k, v in stats.items()})
    cams = jax.tree.map(lambda *xs: jnp.stack([jnp.asarray(x) for x in xs]),
                        *[v.to_device_dict() for v in views])
    jfn = jstep.make_train_step_batched(jc, 1, W, H, EXTENT, 1, TOTAL_FRAME,
                                        bg, B, interpret=True)
    js2, _, jm = jfn(js, jax.tree.map(jnp.asarray, opt), cams,
                     jnp.asarray(gts), jnp.asarray(TIMES, jnp.float32),
                     jnp.int32(IT0), key)

    ts = state_from_params(params, alive, device="cpu", stats=stats)
    tcams = [v.to_device_dict("cpu") for v in tviews]
    ttimes = [torch.tensor(tm, dtype=torch.float32) for tm in TIMES]
    step = tstep.make_train_step_batched(tc, 1, W, H, EXTENT, 1,
                                         TOTAL_FRAME, t(bg), B)
    ts2, _, tm = step(ts, opt_state_from_arrays(opt, device="cpu"), tcams,
                      [t(g) for g in gts], ttimes, IT0,
                      noises=[t(x) for x in xyz_noise],
                      time_noises=[t(x) for x in time_noise])
    # the members' single-render gradients, summed in member order
    loss_and_grads, _ = tstep._step_parts(tc, 1, W, H, EXTENT, 1, t(bg))
    total = None
    for j in range(B):
        tt = tstep.time_with_noise(tc, ttimes[j], None, TOTAL_FRAME,
                                   tstep.time_noise_anneal(tc, IT0 + j, 1),
                                   noise=t(time_noise[j]))
        _, g, _, _ = loss_and_grads(ts, tcams[j], t(gts[j]), tt, IT0 + j,
                                    None, None, t(xyz_noise[j]))
        total = g if total is None else topt.tree_map(torch.add, total, g)
    return js2, jm, ts2, tm, total


def test_batched_step_matches_jax(batched):
    js2, jm, ts2, tm, _ = batched
    assert int(tm["n_dropped"]) == int(jm["n_dropped"]) == 0
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm["l1"]), float(jm["l1"]), rtol=1e-5)
    for key in ts2.params:
        for a, b in zip(topt.tree_leaves(ts2.params[key]),
                        topt.tree_leaves(js2.params[key])):
            np.testing.assert_allclose(n(a), np.asarray(b), rtol=0,
                                       atol=1e-6, err_msg=key)
    for key in ("denom", "max_radii2D"):
        np.testing.assert_array_equal(n(getattr(ts2, key)),
                                      np.asarray(getattr(js2, key)))
    for key in ("xyz_gradient_accum", "xyz_gradient_accum_max"):
        ref = np.asarray(getattr(js2, key))
        np.testing.assert_allclose(n(getattr(ts2, key)), ref, rtol=0,
                                   atol=2e-4 * np.abs(ref).max())


def test_batched_gradients_are_the_members_summed(batched):
    _, _, _, tm, total = batched
    for key in total:
        for a, b in zip(topt.tree_leaves(tm["grads"][key]),
                        topt.tree_leaves(total[key])):
            assert torch.equal(a, b), key


def test_trainer_runs_batches(monkeypatch):
    cfg = tcfg.get_preset("test")
    cfg.train.batch = 2
    info = synthetic_scene_info(n_points=80, n_cams=6, n_test=1, width=32,
                                height=32, dynamic=True, device="cpu")
    tr = Trainer(cfg, Scene(info), device="cpu", quiet=True, log_every=4)
    spans = []
    orig = Trainer.train_batch
    monkeypatch.setattr(Trainer, "train_batch", lambda self, a, b: (
        spans.append((a, b)) or orig(self, a, b)))
    hist = tr.run(iterations=16)
    assert tr.iteration == 16
    # the stage-1 start at 10 cuts a pair; all else runs in pairs
    assert spans == [(1, 2), (3, 4), (5, 6), (7, 8), (10, 11), (12, 13),
                     (14, 15)]
    assert [h["iter"] for h in hist if "iter" in h] == [4, 8, 13]
    assert all(bool(torch.isfinite(x).all())
               for x in topt.tree_leaves(tr.state.params))
