"""Evaluation and rendering CLI (the port's twin of eval.py).

Usage:
  python -m gaussianprediction_tpu_torch.cli.eval -m <model_dir> \
      [--ckpt_iteration 60000] [--render_video] [--render_train] \
      [--skip_metrics]

Loads cfg.json and the checkpoint (the newest one by default) from the
model dir, renders the test set into <model_dir>eval/test/ours_<iteration>/
(renders/, gt/) with its FPS (CUDA events around each render), writes the
metric suite to results.json and per_view.json there, and optionally
renders a pose- and time-interpolated video (renders_video/) or one
frozen view over the training times (view_<train_view>/). Runs on the
card (GPT_FORCE_CPU=1: on the CPU). --resize is parsed and unused, as in
eval.py.
"""
from __future__ import annotations

import argparse
import json
import os

from gaussianprediction_tpu_torch.cli import checkpoint_path, device_from_env


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-m", "--model_path", required=True)
    p.add_argument("-s", "--source_path", default=None)
    p.add_argument("--ckpt_iteration", type=int, default=None)
    p.add_argument("--render_video", action="store_true")
    p.add_argument("--render_train", action="store_true")
    p.add_argument("--train_view", type=int, default=5)
    p.add_argument("--interpolation", type=int, default=5)
    p.add_argument("--skip_metrics", action="store_true")
    p.add_argument("--resize", type=float, default=1.0)
    return p


def main(argv=None):
    """Evaluate from argv (None: sys.argv); returns {"out_dir", "fps",
    "results"} (results None under --skip_metrics)."""
    args = build_parser().parse_args(argv)
    dev = device_from_env()

    import numpy as np

    from gaussianprediction_tpu_torch.config import Config
    from gaussianprediction_tpu_torch.data.scene import (
        Scene, load_scene_info,
    )
    from gaussianprediction_tpu_torch.eval import metrics as M
    from gaussianprediction_tpu_torch.eval import render as R
    from gaussianprediction_tpu_torch.train.loop import Trainer

    with open(os.path.join(args.model_path, "cfg.json")) as f:
        cfg = Config.from_json(f.read())
    if args.source_path:
        cfg.source_path = args.source_path
    ckpt_path = checkpoint_path(args.model_path, args.ckpt_iteration)

    info = load_scene_info(cfg, lazy=True)
    scene = Scene(info, prefetch=0)
    trainer = Trainer(cfg, scene, device=dev, quiet=True)
    trainer.load_checkpoint(ckpt_path)
    print(f"loaded {ckpt_path} (iteration {trainer.iteration})")

    bg = (np.ones(3, np.float32) if cfg.model.white_background
          else np.zeros(3, np.float32))
    out_dir = os.path.join(
        args.model_path + "eval", "test", f"ours_{trainer.iteration}"
    )
    renders, gts, fps = R.render_set(
        trainer.state, cfg, trainer.iteration, scene.test_cameras, bg,
        out_dir=out_dir,
    )
    print(f"Rendering AVG FPS: {fps:.3f}")

    res = None
    if not args.skip_metrics and gts:
        res = M.evaluate_pairs(renders, gts, device=dev)
        with open(os.path.join(out_dir, "results.json"), "w") as f:
            json.dump(res["mean"], f, indent=2)
        with open(os.path.join(out_dir, "per_view.json"), "w") as f:
            json.dump(res["per_view"], f, indent=2)
        print("metrics:", dict(res["mean"]))

    if args.render_video:
        R.render_video(
            trainer.state, cfg, trainer.iteration, scene.render_cameras, bg,
            out_path=os.path.join(out_dir, "renders_video", "video.mp4"),
            interpolation=args.interpolation,
            # paired-rig (vrig) captures alternate cameras frame to frame:
            # stride 2, as the reference does
            step=2 if "vrig" in (cfg.source_path or "").lower() else 1,
        )
        print("video written")

    if args.render_train:
        freeze = scene.test_cameras[
            min(args.train_view, len(scene.test_cameras) - 1)
        ]
        R.render_train_sequence(
            trainer.state, cfg, trainer.iteration, scene.train_cameras,
            freeze, bg,
            out_dir=os.path.join(out_dir, f"view_{args.train_view:03d}"),
        )
        print("train sequence written")
    return {"out_dir": out_dir, "fps": fps, "results": res}


if __name__ == "__main__":
    main()
