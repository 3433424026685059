"""GCN motion-extrapolation CLI (the port's twin of train_gcn.py).

Usage:
  python -m gaussianprediction_tpu_torch.cli.train_gcn -m <model_dir> \
      [--ckpt_iteration 60000] [--epoch 2001] [--num_stage 6] \
      [--predict_more] [--metrics] [--frames 150]

Loads the stage-3 Gaussian checkpoint, extracts the keypoint trajectories
over the training timestamps (a max_time < 1.0 split), trains the GCN
(or reloads one with --load) into <model_dir>/<exp_name>/gcn_ckpt.npz and
optionally rolls out future frames: --predict_more renders --frames of
them from one test view (predicted_more/, and a video), --metrics renders
one at each test view and scores them (metrics_predicted/results.json).
Runs on the card (GPT_FORCE_CPU=1: on the CPU).
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
    p.add_argument("--exp_name", default="gcn")
    p.add_argument("--epoch", type=int, default=101)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--num_stage", type=int, default=4)
    p.add_argument("--linear_size", type=int, default=128)
    p.add_argument("--input_size", type=int, default=10)
    p.add_argument("--output_size", type=int, default=1)
    p.add_argument("--noise_init", type=float, default=0.1)
    p.add_argument("--noise_step", type=int, default=100)
    p.add_argument("--dropout", type=float, default=0.0,
                   help="GCN dropout prob (the reference's --dropout; its "
                        "recipes use the 0 default)")
    p.add_argument("--no_mapping", action="store_true",
                   help="graph-conv output head instead of the 2-layer "
                        "MLP (the reference's --no_mapping)")
    p.add_argument("--evaluate", action="store_true",
                   help="skip training; requires --load")
    p.add_argument("--predict_more", action="store_true")
    p.add_argument("--load", default=None, metavar="GCN_CKPT_NPZ",
                   help="reload a trained GCN from gcn_ckpt.npz instead of "
                        "training")
    p.add_argument("--metrics", action="store_true")
    p.add_argument("--frames", type=int, default=150)
    p.add_argument("--cam_id", type=int, default=0)
    return p


def main(argv=None):
    """Train (or load) the GCN from argv (None: sys.argv); returns
    {"model", "gcn_config", "history", "predicted", "results"}."""
    p = build_parser()
    args = p.parse_args(argv)
    dev = device_from_env()

    import numpy as np

    from gaussianprediction_tpu_torch.config import Config
    from gaussianprediction_tpu_torch.data.scene import (
        Scene, load_scene_info,
    )
    from gaussianprediction_tpu_torch.eval import metrics as M
    from gaussianprediction_tpu_torch.eval import render as R
    from gaussianprediction_tpu_torch.motion.dataset import (
        build_windows, extract_trajectories, times_from_scene,
    )
    from gaussianprediction_tpu_torch.motion.gcn_train import (
        GCNConfig, load_gcn_checkpoint, rollout, save_gcn_checkpoint,
        train_gcn,
    )
    from gaussianprediction_tpu_torch.train.loop import Trainer

    with open(os.path.join(args.model_path, "cfg.json")) as f:
        cfg = Config.from_json(f.read())
    if args.source_path:
        cfg.source_path = args.source_path
    if not cfg.model.max_time < 1.0:
        raise ValueError(
            "motion prediction requires a max_time<1.0 training split")
    if args.evaluate and not args.load:
        p.error("--evaluate requires --load <gcn_ckpt.npz>")

    info = load_scene_info(cfg, lazy=True)
    scene = Scene(info, prefetch=0)
    trainer = Trainer(cfg, scene, device=dev, quiet=True)
    trainer.load_checkpoint(checkpoint_path(args.model_path,
                                            args.ckpt_iteration))

    train_times, test_times = times_from_scene(info, cfg.model.max_time)
    print(f"extracting trajectories: {len(train_times)} train / "
          f"{len(test_times)} test timestamps")
    traj = extract_trajectories(
        trainer.state, cfg, train_times, test_times, trainer.iteration
    )
    windows = build_windows(traj, args.input_size, args.output_size, "train")
    print(f"{len(windows.xyz_inputs)} training windows over "
          f"{traj.n_kpts} keypoints")

    out_dir = os.path.join(args.model_path, args.exp_name)
    os.makedirs(out_dir, exist_ok=True)
    if args.load:
        model, gcfg, n_kpts, hist = load_gcn_checkpoint(args.load, dev)
        if n_kpts != traj.n_kpts:
            raise ValueError(
                f"checkpoint was trained with {n_kpts} keypoints, "
                f"scene has {traj.n_kpts}")
        print(f"GCN reloaded from {args.load} "
              f"(final train loss {hist[-1]:.5f})" if hist else
              f"GCN reloaded from {args.load}")
    else:
        gcfg = GCNConfig(
            input_size=args.input_size, output_size=args.output_size,
            linear_size=args.linear_size, num_stage=args.num_stage,
            epochs=args.epoch, batch_size=args.batch_size,
            noise_init=args.noise_init, noise_step=args.noise_step,
            norm_rotation=cfg.model.norm_rotation,
            no_mapping=args.no_mapping, dropout=args.dropout,
        )
        model, hist = train_gcn(windows, traj.n_kpts, gcfg, device=dev)
        save_gcn_checkpoint(
            os.path.join(out_dir, "gcn_ckpt.npz"), model, gcfg,
            traj.n_kpts, hist,
        )
        print(f"GCN trained: loss {hist[0]:.5f} -> {hist[-1]:.5f}")

    bg = (np.ones(3, np.float32) if cfg.model.white_background
          else np.zeros(3, np.float32))
    seed_xyz = traj.kpts_xyz_train[-gcfg.input_size:]
    seed_r = traj.kpts_r_train[-gcfg.input_size:]
    predicted = None
    if args.predict_more:
        kpts, kpts_r = rollout(model, gcfg, seed_xyz, seed_r,
                               frames=args.frames)
        predicted = R.render_kpts(
            trainer.state, cfg, trainer.iteration, scene.test_cameras, bg,
            kpts, kpts_r, view_id=args.cam_id,
            out_dir=os.path.join(out_dir, "predicted_more"),
        )
        R.save_video(
            os.path.join(out_dir, "predicted_more", "video.mp4"), predicted,
            fps=30,
        )
        print(f"rolled out + rendered {len(predicted)} future frames")

    res = None
    if args.metrics:
        n = len(scene.test_cameras)
        kpts, kpts_r = rollout(model, gcfg, seed_xyz, seed_r, frames=n)
        mdir = os.path.join(out_dir, "metrics_predicted")
        frames = R.render_kpts(
            trainer.state, cfg, trainer.iteration, scene.test_cameras, bg,
            kpts, kpts_r, out_dir=mdir,
        )
        gts = [c.load_image() for c in scene.test_cameras[: len(frames)]]
        res = M.evaluate_pairs(frames, gts, device=dev)
        with open(os.path.join(mdir, "results.json"), "w") as f:
            json.dump(res["mean"], f, indent=2)
        print("prediction metrics:", res["mean"])
    return {"model": model, "gcn_config": gcfg, "history": hist,
            "predicted": predicted, "results": res}


if __name__ == "__main__":
    main()
