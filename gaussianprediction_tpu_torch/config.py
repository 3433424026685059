"""Typed configuration (replaces the reference's three-layer argparse).

A plain copy of gaussianprediction_tpu/config.py (pure Python), kept here so
the torch port imports nothing of the JAX package.

Mirrors every training-relevant flag of:
  reference/arguments/__init__.py:47-100 (ModelParams, PipelineParams,
  OptimizationParams: all LRs, densify schedule, SSIM weight, PE freqs)
  reference/options/gaussian_option.py:41-90 (Gaussian_Options.initial:
  stage schedule, keypoint budget, noise schedules, KNN mode, step-opacity)
plus per-scene presets reproducing the shell-script configs in
reference/scripts/train/ (SURVEY.md §6.2). Serialized as JSON next to
checkpoints (the reference's `cfg_args` eval() round-trip is intentionally
NOT replicated — SURVEY.md §5.6).

Static-capacity additions for XLA (SURVEY.md §5.8): `capacity` (padded
Gaussian buffer) and the keypoint capacity max_points+adaptive_points_num.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple


@dataclasses.dataclass
class OptimizationConfig:
    """LRs & schedules; defaults = arguments/__init__.py:72-100."""

    iterations: int = 30_000
    position_lr_init: float = 1.6e-4
    position_lr_final: float = 1.6e-6
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 2.5e-3
    opacity_lr: float = 5e-2
    scaling_lr: float = 5e-3
    rotation_lr: float = 1e-3
    mfeature_lr: float = 8e-4
    mfeature_lr_final: float = 8e-5
    kpts_lr: float = 8e-4
    kpts_lr_final: float = 8e-5
    hash_lr: float = 5e-3
    hash_lr_final: float = 5e-5
    mlp_lr: float = 8e-4
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 2e-4
    xyz_freq: int = 10
    time_freq: int = 6           # 10 for real (HyperNeRF) scenes


@dataclasses.dataclass
class ModelConfig:
    """Model structure; defaults = gaussian_option.py:41-90 + ModelParams."""

    sh_degree: int = 3
    white_background: bool = False
    max_time: float = 1.0
    feature_dim: int = 32        # motion feature dims
    d: int = 4                   # deform MLP depth
    w: int = 256                 # deform MLP width
    nearest_num: int = 6         # KNN K for keypoint blending
    max_points: int = 100        # initial keypoint count
    adaptive_points_num: int = 0  # extra keypoint budget
    knn_type: str = "hybird"     # "3D" | "hybird" (reference spelling)
    feature_amplify: float = 5.0
    norm_rotation: bool = False
    step_opacity: bool = False
    step_opacity_iteration: int = 5000
    opacity_type: str = "implicit"
    beta: float = 0.1
    # blend-weight model encoder:
    #   "hashgrid" — exact tcnn twin (gaussian_model.py:370-392) with a
    #                sort-based VJP (ops/hashgrid.py:hashgrid_encode_fast);
    #   "fourier"  — MXU-pure multi-scale Fourier encoder
    #                (ops/fourier_enc.py), the TPU-first fast path.
    #   "brick"    — overlapping-brick hash grid (ops/hashgrid.py,
    #                brickgrid_encode_fast): one 64F-wide row gather per
    #                (point, level) instead of 8 corner rows — ~8x fewer
    #                gather rows than the twin on the row-rate-bound TPU
    #                gather. Same family (multi-res hash + trilinear +
    #                MLP), different collision structure.
    weight_encoder: str = "hashgrid"
    fourier_per_level: int = 4
    hash_log2_Tb: int = 16       # brick-encoder table rows per hashed level
    weight_mlp_width: int = 64   # tcnn FullyFusedMLP: 2x64
    weight_mlp_depth: int = 2
    # hash-grid weight model (tcnn config, gaussian_model.py:370-392)
    hash_levels: int = 16
    hash_features: int = 4
    hash_log2_T: int = 19
    hash_min_res: int = 16
    hash_max_res: int = 2048
    hash_bound: float = 1.6
    # static capacities (XLA); reference caps at 200k (train.py:169-170)
    max_gaussian_size: int = 200_000
    capacity: Optional[int] = None   # padded buffer; default from max size
    # instance buffer = multiplier * capacity; every instance-stream cost
    # (sorts/gathers) scales with it — size for n_dropped == 0, no more.
    # capacity_auto=True (default): the Trainer probes the actual per-view
    # slot need at init / checkpoint load / densify cadence and sizes the
    # multiplier with 1.3x slack (growing + recompiling if a probe ever
    # approaches the buffer), so production steps match the probe-sized
    # bench instead of paying a worst-case static buffer. The static value
    # below is the fallback when capacity_auto=False.
    capacity_multiplier: float = 12
    capacity_auto: bool = True

    def padded_capacity(self) -> int:
        if self.capacity is not None:
            return self.capacity
        return ((self.max_gaussian_size + 1023) // 1024) * 1024 + 4096

    def kpt_capacity(self) -> int:
        return self.max_points + self.adaptive_points_num


@dataclasses.dataclass
class TrainConfig:
    """Stage schedule & noise; defaults = gaussian_option.py:41-90."""

    jointly_iteration: int = 1000        # warm-up end
    second_stage_iteration: int = 30_000
    third_stage_iteration: int = 40_000
    use_time_decay: bool = False
    time_noise_ratio: float = 0.5
    time_noise_iteration: int = 10_000
    xyz_noise_iteration: int = 10_000
    adaptive_from_iter: int = 3000
    adaptive_end_iter: int = 10_000
    adaptive_interval: int = 200
    densify_from_teaching: bool = False
    densify_from_grad: bool = True
    teaching_threshold: float = 0.2
    # >0: at the stage-2 transition, pre-fit the blend-weight model for
    # this many Adam steps so the keypoint-blended motion matches the
    # stage-1 motion field BEFORE stage-2 training starts (train/loop.py
    # distill_weight_init). The reference starts stage 2 from a random
    # weight model (gaussian_model.py:370-392), which re-smooths the
    # learned motion and causes a transition PSNR cliff; 0 = faithful.
    distill_init_steps: int = 0
    batch: int = 1
    seed: int = 1
    test_iterations: Tuple[int, ...] = (7000, 30000)
    save_iterations: Tuple[int, ...] = (7000, 30000)
    checkpoint_iterations: Tuple[int, ...] = ()
    # the profiler window (train/loop.py:Trainer.run): trace profile_steps
    # iterations from the first one >= profile_from with torch.profiler
    # into a Chrome trace under <model_path>/profile
    profile_from: int = 20
    profile_steps: int = 0


@dataclasses.dataclass
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    opt: OptimizationConfig = dataclasses.field(
        default_factory=OptimizationConfig
    )
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    source_path: str = ""
    model_path: str = ""
    ratio: float = 0.5           # HyperNeRF resolution ratio
    data_device: str = "cpu"

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, s: str) -> "Config":
        d = json.loads(s)
        return cls(
            model=ModelConfig(**d["model"]),
            opt=OptimizationConfig(**d["opt"]),
            train=TrainConfig(
                **{
                    k: tuple(v) if isinstance(v, list) else v
                    for k, v in d["train"].items()
                }
            ),
            **{k: v for k, v in d.items()
               if k not in ("model", "opt", "train")},
        )


def _dnerf_base(**over) -> Config:
    """All 8 D-NeRF scenes share one recipe
    (scripts/train/d-nerf/bouncingballs.sh and siblings)."""
    cfg = Config()
    cfg.model = ModelConfig(
        max_points=100, adaptive_points_num=100, norm_rotation=True,
        feature_amplify=0.5,
    )
    cfg.opt = OptimizationConfig(
        iterations=60_000, time_freq=6, densify_from_iter=3000,
        densify_until_iter=20_000, position_lr_max_steps=40_000,
    )
    cfg.train = TrainConfig(
        adaptive_interval=500, save_iterations=(29_999, 60_000),
        test_iterations=(60_000,),
        checkpoint_iterations=(29_999, 60_000),
    )
    for k, v in over.items():
        setattr(cfg, k, v)
    return cfg


def _hyper_base(max_points=100, adaptive=100, time_freq=8,
                step_opacity=False, **over) -> Config:
    """HyperNeRF recipe (scripts/train/hyper/*.sh)."""
    cfg = Config()
    cfg.model = ModelConfig(
        max_points=max_points, adaptive_points_num=adaptive,
        feature_amplify=5.0, step_opacity=step_opacity,
    )
    cfg.opt = OptimizationConfig(
        iterations=70_000, time_freq=time_freq, densify_from_iter=5000,
        densify_until_iter=15_000,
        opacity_reset_interval=(3_000_000 if step_opacity else 3000),
    )
    cfg.train = TrainConfig(
        use_time_decay=True, save_iterations=(70_000,),
        test_iterations=(7000, 30_000, 70_000),
        checkpoint_iterations=(30_000, 70_000),
    )
    for k, v in over.items():
        setattr(cfg, k, v)
    return cfg


PRESETS = {
    # D-NeRF synthetic (scripts/train/d-nerf/*.sh)
    "dnerf": _dnerf_base(),
    "bouncingballs": _dnerf_base(),
    "hellwarrior": _dnerf_base(),
    "hook": _dnerf_base(),
    "jumpingjacks": _dnerf_base(),
    "lego": _dnerf_base(),
    "mutant": _dnerf_base(),
    "standup": _dnerf_base(),
    "trex": _dnerf_base(),
    # HyperNeRF real scenes (scripts/train/hyper/*.sh)
    "lemon": _hyper_base(100, 200, time_freq=10, step_opacity=True,
                         train=TrainConfig(
                             use_time_decay=True, adaptive_interval=1000,
                             save_iterations=(70_000,),
                             checkpoint_iterations=(30_000, 70_000))),
    "chickchicken": _hyper_base(100, 100, time_freq=8),
    "torchocolate": _hyper_base(50, 100, time_freq=8),
    "printer": _hyper_base(150, 100, time_freq=8),
    # tiny test/dev preset
    "test": Config(
        model=ModelConfig(
            max_gaussian_size=512, capacity=512, max_points=16,
            adaptive_points_num=16, d=2, w=32, feature_dim=8, sh_degree=1,
            hash_levels=4, hash_features=2, hash_log2_T=10, hash_max_res=64,
        ),
        opt=OptimizationConfig(
            iterations=200, position_lr_max_steps=200, xyz_freq=4,
            time_freq=3, densify_from_iter=20, densification_interval=50,
            densify_until_iter=150, opacity_reset_interval=1000,
        ),
        train=TrainConfig(
            jointly_iteration=10, second_stage_iteration=60,
            third_stage_iteration=120, time_noise_iteration=50,
            xyz_noise_iteration=50, adaptive_from_iter=20,
            adaptive_end_iter=100, adaptive_interval=30,
        ),
    ),
}


def get_preset(name: str) -> Config:
    import copy

    return copy.deepcopy(PRESETS[name])
