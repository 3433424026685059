"""Training CLI: dynamic Gaussian splatting (the port's twin of train.py).

Usage:
  python -m gaussianprediction_tpu_torch.cli.train -s <scene_dir> \
      -m <model_dir> [--preset bouncingballs] [--max_time 0.8] \
      [--iterations 60000] ...

The dataset type is detected from the scene's files (COLMAP sparse/,
Blender transforms_train.json, HyperNeRF dataset.json). Per-scene presets
reproduce the reference's training scripts; any flag overrides the preset.
The flags, their defaults and the resolved config are train.py's: the same
argv gives the same cfg.json, written to the model dir. Runs on the card
(GPT_FORCE_CPU=1: on the CPU). --steps_per_call K trains K iterations a
device call where no host event intervenes (the same result as K = 1);
--profile_steps N [--profile_from I] writes a torch.profiler Chrome trace
of N iterations into <model_dir>/profile.

On several GPUs, one process a GPU (parallel/distributed.py):
  torchrun --standalone --nproc_per_node N \
      -m gaussianprediction_tpu_torch.cli.train -s <scene_dir> \
      -m <model_dir> --n_devices N [--n_data D]
trains on D camera groups of N / D tile bands each (--n_data defaults to
--n_devices); rank 0 alone writes the model dir.
"""
from __future__ import annotations

import argparse
import os

from gaussianprediction_tpu_torch.cli import device_from_env


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-s", "--source_path", required=True)
    p.add_argument("-m", "--model_path", required=True)
    p.add_argument("--preset", default=None,
                   help="per-scene preset name (see config.PRESETS)")
    p.add_argument("--max_time", type=float, default=None)
    p.add_argument("--iterations", type=int, default=None)
    p.add_argument("--max_points", type=int, default=None)
    p.add_argument("--adaptive_points_num", type=int, default=None)
    p.add_argument("--time_freq", type=int, default=None)
    p.add_argument("--nearest_num", type=int, default=None)
    p.add_argument("--feature_amplify", type=float, default=None)
    p.add_argument("--norm_rotation", action="store_true", default=None)
    p.add_argument("--step_opacity", action="store_true", default=None)
    p.add_argument("--use_time_decay", action="store_true", default=None)
    p.add_argument("--white_background", action="store_true", default=None)
    p.add_argument("--second_stage_iteration", type=int, default=None)
    p.add_argument("--third_stage_iteration", type=int, default=None)
    p.add_argument("--jointly_iteration", type=int, default=None)
    p.add_argument("--densify_from_iter", type=int, default=None)
    p.add_argument("--densify_until_iter", type=int, default=None)
    p.add_argument("--position_lr_max_steps", type=int, default=None)
    p.add_argument("--adaptive_from_iter", type=int, default=None)
    p.add_argument("--adaptive_interval", type=int, default=None)
    p.add_argument("--ratio", type=float, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--start_checkpoint", default=None)
    p.add_argument("--eval", action="store_true", default=True)
    p.add_argument("--save_iterations", nargs="+", type=int, default=None)
    p.add_argument("--checkpoint_iterations", nargs="+", type=int,
                   default=None)
    p.add_argument("--test_iterations", nargs="+", type=int, default=None)
    p.add_argument("--weight_encoder", default=None,
                   choices=("hashgrid", "fourier", "brick"),
                   help="stage-2/3 blend-weight encoder")
    p.add_argument("--distill_init_steps", type=int, default=None,
                   help=">0: pre-fit the blend-weight model at the stage-2 "
                        "transition")
    p.add_argument("--batch", type=int, default=None,
                   help="gradient accumulation: renders per optimizer step")
    p.add_argument("--n_devices", type=int, default=1,
                   help=">1: the sharded multi-GPU train path, one process "
                        "a GPU under torchrun")
    p.add_argument("--n_data", type=int, default=None,
                   help="data-parallel camera groups within --n_devices "
                        "(default: --n_devices; read only with --n_devices "
                        "> 1)")
    p.add_argument("--steps_per_call", type=int, default=1,
                   help=">1: several iterations per device call")
    p.add_argument("--profile_steps", type=int, default=None,
                   help="trace this many steps with torch.profiler into "
                        "<model_path>/profile")
    p.add_argument("--profile_from", type=int, default=None,
                   help="first iteration of the profiler trace window")
    return p


def resolve_config(args):
    from gaussianprediction_tpu_torch.config import PRESETS, get_preset

    preset = args.preset
    if preset is None:  # guess from path
        base = os.path.basename(os.path.normpath(args.source_path)).lower()
        preset = base if base in PRESETS else "dnerf"
    cfg = get_preset(preset)
    cfg.source_path = args.source_path
    cfg.model_path = args.model_path
    over_model = ["max_time", "max_points", "adaptive_points_num",
                  "nearest_num", "feature_amplify", "norm_rotation",
                  "step_opacity", "white_background", "weight_encoder"]
    over_opt = ["iterations", "time_freq", "densify_from_iter",
                "densify_until_iter", "position_lr_max_steps"]
    over_train = ["second_stage_iteration", "third_stage_iteration",
                  "jointly_iteration", "adaptive_from_iter",
                  "adaptive_interval", "seed", "save_iterations",
                  "checkpoint_iterations", "test_iterations",
                  "use_time_decay", "profile_steps", "profile_from",
                  "batch", "distill_init_steps"]
    for name in over_model:
        v = getattr(args, name)
        if v is not None:
            setattr(cfg.model, name, v)
    for name in over_opt:
        v = getattr(args, name)
        if v is not None:
            setattr(cfg.opt, name, v)
    for name in over_train:
        v = getattr(args, name)
        if v is not None:
            setattr(cfg.train, name,
                    tuple(v) if isinstance(v, list) else v)
    if args.ratio is not None:
        cfg.ratio = args.ratio
    return cfg


def main(argv=None):
    """Train from argv (None: sys.argv); returns the Trainer."""
    args = build_parser().parse_args(argv)
    cfg = resolve_config(args)
    from gaussianprediction_tpu_torch.parallel.distributed import (
        LAUNCH, maybe_initialize_distributed, opted_in, rank_device,
    )

    if args.n_devices > 1 and not opted_in():
        raise RuntimeError(f"--n_devices {args.n_devices} runs one process "
                           f"a GPU; launch it as: {LAUNCH}")
    dev = device_from_env()
    multi = maybe_initialize_distributed(device=dev)
    rank = 0
    if multi:
        import torch.distributed as dist

        dev, rank = rank_device(dev), dist.get_rank()
    say = print if rank == 0 else (lambda *a, **k: None)

    from gaussianprediction_tpu_torch.data.scene import (
        Scene, load_scene_info,
    )
    from gaussianprediction_tpu_torch.train.loop import Trainer

    if rank == 0:
        os.makedirs(cfg.model_path, exist_ok=True)
        with open(os.path.join(cfg.model_path, "cfg.json"), "w") as f:
            f.write(cfg.to_json())

    say(f"Loading scene from {cfg.source_path}")
    info = load_scene_info(cfg, lazy=True)
    scene = Scene(info, seed=cfg.train.seed)
    say(
        f"{len(scene.train_cameras)} train / {len(scene.test_cameras)} test "
        f"cameras, extent {scene.cameras_extent:.3f}, on {dev}"
    )
    try:
        trainer = Trainer(cfg, scene, device=dev, n_devices=args.n_devices,
                          n_data=args.n_data or args.n_devices,
                          steps_per_call=args.steps_per_call)
        if args.start_checkpoint:
            trainer.load_checkpoint(args.start_checkpoint)
            say(f"resumed from {args.start_checkpoint} @ "
                f"{trainer.iteration}")
        trainer.run(model_path=cfg.model_path)
    finally:
        scene.close()
    if rank == 0:
        trainer.save_checkpoint(
            os.path.join(cfg.model_path, f"chkpnt{trainer.iteration}.npz"))
    st = scene.decode_stats
    say(f"image decode: {st['waited']} of {st['draws']} camera draws "
        f"found their image not decoded yet ({st['wait_ms']:.1f} ms "
        f"waited on the decode workers)")
    say("\nTraining complete.")
    return trainer


if __name__ == "__main__":
    main()
