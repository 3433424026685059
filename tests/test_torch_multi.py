"""Several iterations per call (train/step.py:make_train_step_multi), the
Trainer's chunks (steps_per_call) and profiler window, and the hash-grid
forward under GPT_HASH_FWD=sorted, on the CPU. The multi step against the
JAX package's is tests/test_torch_train.py::test_multi_step_matches_jax,
which shares that module's JAX jit.

- The multi step with K = 3 against three single steps, bit for bit
  (params, moments, statistics, the last metrics), at stages 0, 1 (the
  span crossing densify_until_iter) and 2 (crossing the keypoint-growth
  and teacher windows' end), the draws from one seeded generator each.
- Trainer(steps_per_call=4) against Trainer(steps_per_call=1) on the
  `test` preset over 16 iterations (densify events at 6 and 12, the
  1 -> 2 transition at 13): the final state and Adam state bit for bit.
- Trainer._chunk_end against the JAX Trainer's, called unbound on a stub.
- The profiler window writes a Chrome trace under <model_path>/profile.
- GPT_HASH_FWD=sorted, which the port ignores: its encoding is the
  default's bit for bit, and the JAX package's under the variable (an
  eager call, which takes the sorted gather) bit for bit.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import n, one_torch_thread, t  # noqa: F401

from gaussianprediction_tpu.config import get_preset as jget_preset
from gaussianprediction_tpu.ops import hashgrid as jhash
from gaussianprediction_tpu.train.loop import Trainer as JTrainer
from gaussianprediction_tpu_torch.config import get_preset
from gaussianprediction_tpu_torch.data.scene import (
    Scene, synthetic_scene_info,
)
from gaussianprediction_tpu_torch.models.gaussians import STATS
from gaussianprediction_tpu_torch.ops import hashgrid as thash
from gaussianprediction_tpu_torch.train import loop as L
from gaussianprediction_tpu_torch.train import optimizer as topt
from gaussianprediction_tpu_torch.train import step as tstep

CPU = "cpu"


# ----------------------------------------------------------- the port alone


@pytest.fixture(scope="module")
def small():
    """A `test`-preset Trainer on a 32x32 synthetic scene: its state, and
    three views (camera dict, time, ground truth)."""
    info = synthetic_scene_info(n_points=80, n_cams=6, n_test=1, width=32,
                                height=32, dynamic=True, device=CPU)
    tr = L.Trainer(get_preset("test"), Scene(info), device=CPU, quiet=True)
    views = [tr._view(c) for c in info.train_cameras[:3]]
    return tr, views


def _tree(state, opt_state, metrics):
    return topt.tree_leaves([state.params, opt_state, state.alive,
                             state.kpt_alive, metrics]) + \
        [getattr(state, k) for k in STATS]


@pytest.mark.parametrize("stage,it0", [(0, 1), (1, 20), (2, 62)])
def test_multi_equals_single_steps(small, stage, it0):
    """Three single steps and one multi step of K = 3 from one state, the
    draws from one seeded generator each. Stage 1 crosses
    densify_until_iter (21); stage 2 the ends of the keypoint-growth and
    teacher windows (63), with the teacher statistics on."""
    tr, views = small
    cfg = get_preset("test")
    cfg.model.capacity_multiplier = tr.cfg.model.capacity_multiplier
    cfg.train.use_time_decay = True
    cfg.opt.densify_until_iter = 21
    cfg.train.densify_from_teaching = True
    cfg.train.adaptive_from_iter, cfg.train.adaptive_end_iter = 1, 3
    state, opt_state = tr.state, tr.opt_state
    if stage == 2:
        state = L.set_super_keypoints(state, cfg,
                                      torch.Generator().manual_seed(0))
        opt_state = topt.init_adam(state.params)
    flags = tstep.step_scalars(cfg, stage, tr.extent, range(it0, it0 + 3))
    cols = tstep.scalar_columns(cfg, stage)
    want = {1: ("do_stats", [1.0, 0.0, 0.0]),
            2: ("kpt_window", [1.0, 0.0, 0.0])}.get(stage)
    if want:
        assert flags[:, cols.index(want[0])].tolist() == want[1]
    if stage == 2:
        assert flags[:, cols.index("teach_window")].tolist() == [1.0, 0, 0]
    args = (cfg, stage, 32, 32, tr.extent, 1, tr.scene.total_frame, tr._bg)
    single = tstep.make_train_step(*args)
    g = torch.Generator().manual_seed(7)
    s, o = state, opt_state
    for i, (cam, tm, gt) in enumerate(views):
        s, o, m = single(s, o, cam, gt, tm, it0 + i, generator=g,
                         active_deg=1)
    multi = tstep.make_train_step_multi(*args, 3)
    s3, o3, m3 = multi(state, opt_state, [v[0] for v in views],
                       [v[2] for v in views], [v[1] for v in views], it0,
                       active_deg=1,
                       generator=torch.Generator().manual_seed(7))
    a, b = _tree(s, o, m), _tree(s3, o3, m3)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert float(s.denom.sum()) > float(state.denom.sum())


def test_trainer_chunks_equal_single_steps(small, monkeypatch):
    """Trainer(steps_per_call=4) and Trainer(steps_per_call=1) over 16
    iterations of the `test` preset with its events moved close: stage 1
    from 1, densify at 6 and 12, the 1 -> 2 transition at 13. Chunks
    between the host events, the final state and Adam state bit for
    bit."""
    chunks = []
    orig = L.Trainer.train_chunk

    def spy(self, a, b):
        chunks.append((a, b))
        return orig(self, a, b)

    monkeypatch.setattr(L.Trainer, "train_chunk", spy)
    info = small[0].scene.info
    out = []
    for k in (1, 4):
        cfg = get_preset("test")
        cfg.train.use_time_decay = True
        cfg.train.jointly_iteration, cfg.train.second_stage_iteration = 1, 12
        cfg.opt.densify_from_iter, cfg.opt.densification_interval = 3, 6
        tr = L.Trainer(cfg, Scene(info), device=CPU, quiet=True,
                       steps_per_call=k)
        tr.run(iterations=16)
        out.append(tr)
    # every iteration is a chunk, of one (train_one) where steps_per_call
    # is 1; with 4, 5, 6, 11 and 12 run alone: the densify events at 6
    # and 12 and the transition at 13 cut their chunks short
    assert chunks == [(i, i) for i in range(1, 17)] + [
        (1, 4), (5, 5), (6, 6), (7, 10), (11, 11), (12, 12), (13, 16)]
    a, b = out
    assert a.iteration == b.iteration == 16 and int(a.state.n_kpts()) == 16
    for x, y in zip(_tree(a.state, a.opt_state, {}),
                    _tree(b.state, b.opt_state, {})):
        assert torch.equal(x, y)


class _Stub:
    def __init__(self, cfg, k):
        self.cfg, self.steps_per_call = cfg, k


@pytest.mark.parametrize("preset", ["test", "dnerf"])
def test_chunk_end_matches_jax(preset):
    """The port's _chunk_end equals the JAX Trainer's for every start and
    span; with a white background it also ends a chunk at the opacity reset
    of densify_from_iter, which the JAX chunks step over when
    densify_from_iter is no multiple of densification_interval."""
    jc, tc = jget_preset(preset), get_preset(preset)
    iters = tc.opt.iterations
    starts = range(1, iters + 1, 1 if iters < 1000 else 37)
    for span in (None, 2, 4, 9):
        for a in starts:
            assert L.Trainer._chunk_end(_Stub(tc, 4), a, iters, span) == \
                JTrainer._chunk_end(_Stub(jc, 4), a, iters, span)
    if preset == "test":
        jc.model.white_background = tc.model.white_background = True
        f = tc.opt.densify_from_iter                  # 20, the interval 50
        for a in range(1, 60):
            ours = L.Trainer._chunk_end(_Stub(tc, 8), a, iters)
            ref = JTrainer._chunk_end(_Stub(jc, 8), a, iters)
            assert ours == (f if a <= f < ref else ref)


def test_profile_window_writes_a_trace(small, tmp_path, capsys):
    cfg = get_preset("test")
    cfg.train.profile_from, cfg.train.profile_steps = 2, 2
    tr = L.Trainer(cfg, Scene(small[0].scene.info), device=CPU)
    tr.run(iterations=3, model_path=str(tmp_path))
    assert tr.iteration == 3
    assert f"[iter 3] profile trace -> {tmp_path / 'profile'}" in \
        capsys.readouterr().out
    files = os.listdir(tmp_path / "profile")
    assert files == ["trace_iter2-3.json"]
    with open(tmp_path / "profile" / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)


def test_hash_forward_ignores_the_sorted_mode(monkeypatch):
    """GPT_HASH_FWD=sorted is not ported (ROADMAP.md, "Not to port"): the
    JAX package's sorted gather gives its default's result, so the port,
    which ignores the variable, is its twin under it too: bit for bit
    its default's encoding, and the JAX encoding under it."""
    rng = np.random.default_rng(3)
    tables = {k: (v * 1e4).astype(np.float32) for k, v in
              thash.init_hashgrid(rng, n_levels=8, n_features=4,
                                  log2_T=12).items()}
    xyz = rng.uniform(-1.6, 1.6, (2000, 3)).astype(np.float32)
    tt = {k: t(v) for k, v in tables.items()}
    default = thash.hashgrid_encode_fast(tt, t(xyz), 1.6, 16, 2048)
    monkeypatch.setenv("GPT_HASH_FWD", "sorted")
    ours = thash.hashgrid_encode_fast(tt, t(xyz), 1.6, 16, 2048)
    assert torch.equal(ours, default)
    calls = []
    sorted_fwd = jhash._encode_from_flat_sorted
    monkeypatch.setattr(jhash, "_encode_from_flat_sorted", lambda *a: (
        calls.append(1), sorted_fwd(*a))[1])
    # eager, as the port runs: under jit XLA may round the positions'
    # scaling otherwise
    ref = jhash.hashgrid_encode_fast({k: jnp.asarray(v) for k, v in
                                      tables.items()}, jnp.asarray(xyz),
                                     1.6, 16, 2048)
    assert calls == [1]              # the JAX call took the sorted gather
    np.testing.assert_array_equal(n(ours), n(ref))
