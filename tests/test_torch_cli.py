"""The port's CLIs (gaussianprediction_tpu_torch/cli/) against the JAX
package's train.py, and end to end on the CPU.

resolve_config of the port and of train.py give the same config JSON for
the same argv, the parsers have the same flags and defaults, and a port
cfg.json loads in the JAX package's Config. The flags once refused train:
--steps_per_call 4 runs a chunk in one call, --profile_steps 2 writes a
trace (--n_devices > 1 without torchrun raises naming the launch line,
before any file is written); --weight_encoder brick|fourier, --distill_init_steps,
--batch 2 and --step_opacity --use_time_decay train across both stage
transitions. The CLIs refuse to run without a card
unless GPT_FORCE_CPU=1. End to end, under GPT_FORCE_CPU=1, on a 32x32 D-NeRF
tree on disk (the `test` preset, 100 iterations, max_time 0.75): train,
eval (--render_video --render_train), train_gcn (--metrics
--predict_more, then --load --evaluate), and show as a `python -m`
subprocess, with the outputs tests/test_cli.py checks of the JAX CLIs;
cli.train's final parameters equal bit for bit those of a Trainer run
directly on the same loaded scene and config.
"""
import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_port_util import one_torch_thread  # noqa: F401

from gaussianprediction_tpu import config as jcfg
from gaussianprediction_tpu_torch.cli import eval as TE
from gaussianprediction_tpu_torch.cli import show as TS
from gaussianprediction_tpu_torch.cli import train as TT
from gaussianprediction_tpu_torch.cli import train_gcn as TG

import train as jtrain  # the JAX package's train.py (tests/conftest.py)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ARGV = {
    "defaults": ["-s", "/data/scene", "-m", "/out/m"],
    "dnerf": ["-s", "/data/d-nerf/lego", "-m", "/out/lego", "--preset",
              "dnerf", "--max_time", "0.8", "--iterations", "1000",
              "--white_background", "--seed", "3"],
    "hyper": ["-s", "/data/hyper/chickchicken", "-m", "/out/c",
              "--preset", "chickchicken", "--ratio", "0.25",
              "--use_time_decay", "--step_opacity", "--time_freq", "12"],
    "staging": ["-s", "/data/hook", "-m", "/out/h", "--jointly_iteration",
                "50", "--second_stage_iteration", "200",
                "--third_stage_iteration", "300", "--densify_from_iter",
                "100", "--densify_until_iter", "201",
                "--position_lr_max_steps", "267", "--adaptive_from_iter",
                "20", "--adaptive_interval", "50", "--test_iterations", "10",
                "400", "--checkpoint_iterations", "300", "400",
                "--save_iterations", "400", "--max_points", "80",
                "--adaptive_points_num", "40", "--nearest_num", "4",
                "--feature_amplify", "2.5", "--norm_rotation"],
    "preset_from_path": ["-s", "/data/nerf/trex", "-m", "/out/t"],
}


@pytest.mark.parametrize("name", sorted(ARGV))
def test_resolve_config_equal(name):
    ours = TT.resolve_config(TT.build_parser().parse_args(ARGV[name]))
    ref = jtrain.resolve_config(jtrain.build_parser().parse_args(ARGV[name]))
    assert ours.to_json() == ref.to_json()
    # a port cfg.json loads in the JAX package's Config, and back
    assert jcfg.Config.from_json(ours.to_json()).to_json() == ours.to_json()
    assert type(ours).from_json(ref.to_json()).to_json() == ref.to_json()


def test_parser_flags_and_defaults_equal():
    def table(p):
        return {a.dest: (tuple(a.option_strings), a.default, a.nargs,
                         a.type, a.choices, a.const, a.required)
                for a in p._actions if a.dest != "help"}

    assert table(TT.build_parser()) == table(jtrain.build_parser())


@pytest.mark.parametrize("flags,item", [
    (["--n_devices", "2"], 8),
    (["--steps_per_call", "4"], 1),
    (["--profile_steps", "2", "--profile_from", "5"], 1),
])
def test_unported_flags_raise(trained, tmp_path, on_cpu, monkeypatch, flags,
                              item):
    """Flags once refused: several GPUs (ROADMAP item 8) need torchrun's
    process group, and without it --n_devices > 1 raises naming the
    launch line before any file is written; several steps a call and the
    profiler window (item 1) train."""
    from gaussianprediction_tpu_torch.train import loop as L

    model = tmp_path / "m"
    if item == 8:
        with pytest.raises(RuntimeError, match="torchrun --standalone"):
            TT.main(["-s", str(tmp_path), "-m", str(model), "--preset",
                     "test", *flags])
        assert not model.exists()
        return
    chunks = []
    orig = L.Trainer.train_chunk
    monkeypatch.setattr(L.Trainer, "train_chunk", lambda self, a, b: (
        chunks.append((a, b)), orig(self, a, b))[1])
    # the chunks cross the stage transitions; the profiler window needs 6
    # iterations of stage 0
    chunked = flags[0] == "--steps_per_call"
    run = SHORT_STAGES if chunked else [
        "--preset", "test", "--iterations", "6", "--max_time", "0.75",
        "--test_iterations", "6"]
    last = int(run[run.index("--iterations") + 1])
    tr, out = quiet_call(TT.main, ["-s", trained[0], "-m", str(model),
                                   *run, *flags])
    assert "Training complete" in out and tr.iteration == last
    # every iteration runs in a chunk, of one where none of 4 fits
    assert [i for a, b in chunks for i in range(a, b + 1)] == \
        list(range(1, last + 1))
    if chunked:
        # the stage starts at 4, 11 and 14 and the report at 16 leave one
        # whole chunk of 4
        assert tr.steps_per_call == 4 and \
            [(a, b) for a, b in chunks if b > a] == [(4, 7)]
    else:
        assert all(a == b for a, b in chunks)
        assert f"[iter 6] profile trace -> {model / 'profile'}" in out
        assert os.listdir(model / "profile") == ["trace_iter5-6.json"]


def test_clis_need_a_card_without_the_switch(tmp_path, monkeypatch):
    monkeypatch.delenv("GPT_FORCE_CPU", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, argv in (
            (TT.main, ["-s", str(tmp_path), "-m", str(tmp_path / "m")]),
            (TE.main, ["-m", str(tmp_path)]),
            (TG.main, ["-m", str(tmp_path)])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(argv)


def quiet_call(main, argv):
    """main(argv) with its stdout captured: (result, stdout)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = main(argv)
    return out, buf.getvalue()


TRAIN_FLAGS = ["--preset", "test", "--iterations", "100", "--max_time",
               "0.75", "--checkpoint_iterations", "100", "--test_iterations",
               "10", "100"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A 32x32 D-NeRF tree on disk (the port's render of an 80-Gaussian
    swirl, 12 frames) and cli.train's run on it: (scene dir, model dir,
    the Trainer, stdout)."""
    from gaussianprediction_tpu_torch.data.blender import (
        write_nerf_synthetic,
    )
    from gaussianprediction_tpu_torch.data.scene import synthetic_scene_info

    root = tmp_path_factory.mktemp("cli")
    info = synthetic_scene_info(n_points=80, n_cams=12, n_test=0, width=32,
                                height=32, dynamic=True, device="cpu")
    scene = str(root / "scene")
    write_nerf_synthetic(scene, info.train_cameras, info.points,
                         info.colors)
    model = str(root / "model")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GPT_FORCE_CPU", "1")
        tr, out = quiet_call(TT.main, ["-s", scene, "-m", model,
                                       *TRAIN_FLAGS])
    return scene, model, tr, out


@pytest.fixture
def on_cpu(monkeypatch):
    monkeypatch.setenv("GPT_FORCE_CPU", "1")


# a schedule that crosses the 1 -> 2 and 2 -> 3 transitions in 16
# iterations (train.py's own flags)
SHORT_STAGES = ["--preset", "test", "--iterations", "16", "--max_time",
                "0.75", "--jointly_iteration", "4",
                "--second_stage_iteration", "10",
                "--third_stage_iteration", "13", "--test_iterations", "16"]


@pytest.mark.parametrize("flags", [
    ["--weight_encoder", "brick"], ["--weight_encoder", "fourier"],
    ["--distill_init_steps", "10"], ["--batch", "2"],
    ["--step_opacity", "--use_time_decay"],
])
def test_encoder_and_distill_flags_train(trained, tmp_path, on_cpu, flags,
                                         monkeypatch):
    """The flags the port once refused train across both transitions:
    the keypoints set, the weight model trained (brick tables, or none for
    fourier), finite losses and a test report; distillation prints its
    first and last loss; --batch 2 accumulates pairs of iterations
    (Trainer.train_batch) wherever no host event falls inside one; the
    HyperNeRF presets' --step_opacity --use_time_decay train too."""
    from gaussianprediction_tpu_torch.train import loop as L
    from gaussianprediction_tpu_torch.train.optimizer import tree_leaves

    batches = []
    orig = L.Trainer.train_batch

    def spy(self, a, b):
        batches.append((a, b))
        return orig(self, a, b)

    monkeypatch.setattr(L.Trainer, "train_batch", spy)
    scene = trained[0]
    model = tmp_path / "m"
    tr, out = quiet_call(TT.main, ["-s", scene, "-m", str(model),
                                   *SHORT_STAGES, *flags])
    assert "Training complete" in out and tr.iteration == 16
    if flags[0] == "--batch":
        # events at 4 (stage 1), 11 (stage 2), 14 (stage 3) and the
        # report at 16 cut the pairs
        assert batches == [(1, 2), (4, 5), (6, 7), (8, 9), (11, 12),
                           (14, 15)]
    else:
        assert not batches
    assert tr.cfg.model.step_opacity == ("--step_opacity" in flags)
    assert "stage 2: keypoints initialized (16)" in out
    assert ("distill init: blend-teacher mse" in out) == \
        (flags[0] == "--distill_init_steps")
    enc = tr.cfg.model.weight_encoder
    p = tr.state.params
    assert ("hash_tables" in p) == (enc != "fourier")
    if enc == "brick":
        assert p["hash_tables"]["level_0"].shape[1] == \
            64 * tr.cfg.model.hash_features
    assert all(bool(torch.isfinite(x).all()) for x in tree_leaves(p))
    with open(model / "history.json") as f:
        hist = json.load(f)
    assert np.isfinite([h["loss"] for h in hist if "loss" in h]).all()
    assert [h["eval"]["iter"] for h in hist if "eval" in h] == [16]
    assert (model / "chkpnt16.npz").exists()


def test_train_writes_its_outputs(trained):
    scene, model, tr, out = trained
    assert "Training complete" in out and "9 train / 3 test" in out
    assert tr.iteration == 100 and tr.device.type == "cpu"
    for f in ("cfg.json", "chkpnt100.npz", "history.json"):
        assert os.path.exists(os.path.join(model, f)), f
    with open(os.path.join(model, "history.json")) as f:
        hist = json.load(f)
    assert hist and np.isfinite([h["loss"] for h in hist
                                 if "loss" in h]).all()
    reports = [h["eval"] for h in hist if "eval" in h]
    assert [r["iter"] for r in reports] == [10, 100]
    with open(os.path.join(model, "cfg.json")) as f:
        cfg = jcfg.Config.from_json(f.read())
    assert cfg.source_path == scene and cfg.model.max_time == 0.75
    assert tr.scene.decode_stats["draws"] == 100


def test_train_equals_a_direct_trainer(trained):
    """cli.train is the Trainer on the lazily loaded scene: the same config
    and scene through Trainer.run give the same parameters bit for bit."""
    from gaussianprediction_tpu_torch.config import Config
    from gaussianprediction_tpu_torch.data.scene import (
        Scene, load_scene_info,
    )
    from gaussianprediction_tpu_torch.train.loop import Trainer
    from gaussianprediction_tpu_torch.train.optimizer import tree_leaves

    scene, model, tr, _ = trained
    with open(os.path.join(model, "cfg.json")) as f:
        cfg = Config.from_json(f.read())
    cfg.model_path = ""                 # write nothing
    info = load_scene_info(cfg, lazy=True)
    direct = Trainer(cfg, Scene(info, seed=cfg.train.seed), device="cpu",
                     quiet=True)
    direct.run()
    a, b = tree_leaves(tr.state.params), tree_leaves(direct.state.params)
    assert len(a) == len(b)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert torch.equal(tr.state.alive, direct.state.alive)
    assert torch.equal(tr.state.kpt_alive, direct.state.kpt_alive)


def test_eval_gcn_and_show(trained, on_cpu):
    scene, model, tr, _ = trained
    res, out = quiet_call(TE.main, ["-m", model, "-s", scene,
                                    "--render_video", "--render_train"])
    assert "FPS" in out
    eval_dir = os.path.join(model + "eval", "test", "ours_100")
    assert res["out_dir"] == eval_dir
    with open(os.path.join(eval_dir, "results.json")) as f:
        metrics = json.load(f)
    assert metrics["PSNR"] is not None and metrics["PSNR"] > 5
    assert os.path.exists(os.path.join(eval_dir, "per_view.json"))
    assert len(os.listdir(os.path.join(eval_dir, "renders"))) == 3
    assert len(os.listdir(os.path.join(eval_dir, "gt"))) == 3
    assert len(os.listdir(os.path.join(eval_dir, "view_005"))) == 9
    assert os.listdir(os.path.join(eval_dir, "renders_video"))

    gcn_flags = ["-m", model, "--epoch", "5", "--num_stage", "1",
                 "--linear_size", "16", "--input_size", "4", "--metrics"]
    g, out = quiet_call(TG.main, [*gcn_flags, "--predict_more",
                                  "--frames", "3"])
    assert "GCN trained" in out
    gdir = os.path.join(model, "gcn")
    assert os.path.exists(os.path.join(gdir, "gcn_ckpt.npz"))
    assert len(g["predicted"]) == 3
    assert len(os.listdir(os.path.join(gdir, "predicted_more",
                                       "renders"))) == 3
    mres = os.path.join(gdir, "metrics_predicted", "results.json")
    with open(mres) as f:
        first = json.load(f)
    assert np.isfinite(first["PSNR"])
    # reloaded, the GCN predicts the same frames
    _, out = quiet_call(TG.main, [*gcn_flags, "--evaluate", "--load",
                                  os.path.join(gdir, "gcn_ckpt.npz")])
    assert "GCN reloaded" in out
    with open(mres) as f:
        assert json.load(f) == first

    r = subprocess.run(
        [sys.executable, "-m", "gaussianprediction_tpu_torch.cli.show",
         "-r", model + "eval", os.path.join(gdir, "metrics_predicted")],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "test/ours_100" in r.stdout and "metrics_predicted" in \
        r.stdout and "average" in r.stdout
    assert f"{metrics['PSNR']:.4f}" in r.stdout
    assert TS.main(["-r", os.path.join(model, "nothing")]) is None
