"""The host training loop: stage schedule, densification cadence,
checkpoints, in-training evaluation.

Torch twin of gaussianprediction_tpu/train/loop.py: stage_of,
set_super_keypoints (the k-means keypoint initialization), the stage
transitions as a function (stage_transition) and the Trainer. The host owns
the rare, shape-changing or schedule-driven events; everything per
iteration is inside the stage's step (train/step.py):

  host: camera sampling, SH-degree bumps (1k cadence), stage transitions
        (k-means keypoints at second_stage + 1, fresh Adam at both),
        densify / prune / opacity-reset cadence, keypoint growth cadence,
        the instance-capacity probe, checkpoint and PLY saves, logging
  device: render + loss + backward + masked Adam + statistics

The Trainer owns one torch.Generator on its device, seeded from 2024 *
seed as the JAX Trainer seeds its PRNG key, and draws through one method
per kind of event, in the JAX Trainer's event order: _init_state (the
model's random parts), _step_noise (each step's xyz and time jitter),
_densify_noise (the split's offsets) and _kmeans_start (the k-means
seed). A subclass that overrides them replays another sequence of draws.

distill_weight_init, the twin of the JAX package's, pre-fits the blend-
weight model to the stage-1 motion at the stage-2 start when
cfg.train.distill_init_steps > 0 (off in every preset).

cfg.train.batch > 1 accumulates the gradients of `batch` iterations into
one optimizer step (train_batch, the JAX Trainer's; host events at the
batch's last iteration only), wherever _chunk_end finds a whole batch
free of host events; elsewhere single iterations run.

n_devices > 1 trains on a ('data', 'tile') mesh of ranks (parallel/):
every rank of an initialized process group (torchrun) runs a Trainer with
the same arguments; n_data camera groups of n_devices / n_data tile bands
each take one sharded step an iteration (train_one_sharded). Every rank
draws the same cameras and the same random numbers and runs every host
event on its replica of the state, so the replicas stay equal; only rank
0 prints and writes model_path.

steps_per_call > 1 runs whole chunks of that many iterations, found by
_chunk_end free of host events and inside one stage, in one call of
train/step.py:make_train_step_multi (train_chunk, the JAX Trainer's; the
SH bump and stage transition at the chunk's first iteration, the other
events at its last); the chunk's draws come from _chunk_noise, K
_step_noise draws in order. A single iteration (train_one) is the chunk
of one, so a run equals the run with steps_per_call = 1 bit for bit.

cfg.train.profile_steps > 0 traces that many iterations from the first
one >= profile_from with torch.profiler (the CPU, and CUDA on the card)
into a Chrome trace under <model_path>/profile (rank 0 alone under a
mesh).
"""
from __future__ import annotations

import json
import math
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from gaussianprediction_tpu_torch.config import Config
from gaussianprediction_tpu_torch.models.gaussians import GaussianState
from gaussianprediction_tpu_torch.ops.kmeans import feature_kmeans
from gaussianprediction_tpu_torch.train import optimizer as opt_mod


def stage_of(cfg: Config, iteration: int) -> int:
    if iteration < cfg.train.jointly_iteration:
        return 0
    if iteration <= cfg.train.second_stage_iteration:
        return 1
    if iteration <= cfg.train.third_stage_iteration:
        return 2
    return 3


def set_super_keypoints(state: GaussianState, cfg: Config,
                        generator: Optional[torch.Generator] = None,
                        start_idx=None) -> GaussianState:
    """k-means keypoint init: cluster the live Gaussians' [xyz,
    motion_feature] into max_points clusters; keypoint k is the mean xyz
    of cluster k's members with the cluster's feature centroid. The first
    max_points keypoint rows become alive, the others die. start_idx (the
    k-means seed) is drawn from `generator` when None."""
    p = state.params
    feats = torch.cat([p["xyz"], p["motion_feature"]], dim=-1)
    k = cfg.model.max_points
    super_xyz, super_feats = feature_kmeans(
        p["xyz"], feats, k, generator, valid=state.alive,
        start_idx=start_idx)
    params = dict(p)
    params["super_xyz"] = p["super_xyz"].clone()
    params["super_xyz"][:k] = super_xyz
    params["super_feature"] = p["super_feature"].clone()
    params["super_feature"][:k] = super_feats[:, 3:]
    kpt_alive = torch.zeros_like(state.kpt_alive)
    kpt_alive[:k] = True
    return state.replace(params=params, kpt_alive=kpt_alive)


def distill_weight_init(state: GaussianState, cfg: Config, n_steps: int,
                        n_times: int = 8):
    """Pre-fit the blend-weight model to the stage-1 motion field (the JAX
    package's distill_weight_init; the reference starts stage 2 from a
    random weight model).

    The teacher's deltas (the stage-1 MLP on every Gaussian) and the
    keypoints' deltas are computed once at n_times timestamps in [0, 1]
    (they do not depend on the weight model), the hybrid-KNN neighbour set
    is fixed (keypoints and canonical xyz do not move here), and only the
    encoder and its MLP are trained, by Adam at cfg.opt.hash_lr (b1 0.9,
    b2 0.999, eps 1e-15), to minimize the squared error of the blended
    xyz and normalized rotation deltas against the teacher's over the live
    Gaussians. Draws no random numbers. Returns (state with the new weight
    model, the loss of each step [n_steps])."""
    from gaussianprediction_tpu_torch.models import deform as D
    from gaussianprediction_tpu_torch.models.gaussians import rotation_act
    from gaussianprediction_tpu_torch.ops.mlp import mlp_apply

    p = state.params
    m = cfg.model
    K = m.nearest_num
    xyz = p["xyz"].detach()
    # jnp.linspace's values: i * (1 / (n - 1)), the last one 1
    times = torch.arange(n_times, dtype=xyz.dtype, device=xyz.device) \
        * (1.0 / max(n_times - 1, 1))
    if n_times > 1:
        times[-1] = 1.0
    kalive = state.kpt_alive[:, None]
    with torch.no_grad():
        ident = torch.zeros_like(p["super_xyz"][:, :1]).repeat(1, 4)
        ident[:, 0] = 1.0
        deltas = []
        for i in range(n_times):
            t_pe = D.time_encode(cfg, times[i:i + 1])
            tdx, tdq, _ = D.motion_delta(p, cfg, D.xyz_encode(cfg, xyz),
                                         p["motion_feature"], t_pe)
            kdx, kdq, _ = D.motion_delta(
                p, cfg, D.xyz_encode(cfg, p["super_xyz"]),
                p["super_feature"], t_pe)
            if m.norm_rotation:
                tdq, kdq = rotation_act(tdq), rotation_act(kdq)
            kdx = torch.where(kalive, kdx, torch.zeros_like(kdx))
            kdq = torch.where(kalive, kdq, ident)
            deltas.append((tdx, tdq, kdx, kdq))
        teach_dx, teach_dq, kpt_dx, kpt_dq = (torch.stack(d)
                                              for d in zip(*deltas))
        nn_idx = D.blend_weights(p, cfg, state)[0].to(torch.int64)
        # the keypoints' deltas gathered at each Gaussian's fixed set
        near_dx, near_dq = kpt_dx[:, nn_idx], kpt_dq[:, nn_idx]
        teach_q = rotation_act(teach_dq)
        alive_w = state.alive.to(xyz.dtype)[None, :, None]
        n_alive = torch.clamp(state.alive.sum(), min=1).to(xyz.dtype)
        enc_const = D.encode_weights(p, cfg, xyz) \
            if m.weight_encoder == "fourier" else None

    names = ["weight_mlp"] + (["hash_tables"] if "hash_tables" in p else [])
    wp = {k: opt_mod.tree_map(torch.Tensor.detach, p[k]) for k in names}

    def loss_fn(wp):
        enc = enc_const if enc_const is not None else D.encode_weights(
            wp, cfg, xyz)
        logits = mlp_apply(wp["weight_mlp"], enc)
        w_xyz = torch.softmax(logits[..., 0:K], dim=-1)
        w_r = torch.softmax(logits[..., K:2 * K], dim=-1)
        blend_dx = torch.einsum("nk,tnkc->tnc", w_xyz, near_dx)
        blend_dq = torch.einsum("nk,tnkc->tnc", w_r, near_dq)
        ex = torch.sum(((blend_dx - teach_dx) ** 2) * alive_w)
        eq = torch.sum(((rotation_act(blend_dq) - teach_q) ** 2) * alive_w)
        return (ex + eq) / (n_times * n_alive)

    lr = cfg.opt.hash_lr
    b1, b2, eps = 0.9, 0.999, 1e-15
    mom = opt_mod.tree_map(torch.zeros_like, wp)
    vel = opt_mod.tree_map(torch.zeros_like, wp)
    one = torch.ones((), dtype=xyz.dtype, device=xyz.device)
    losses = []
    for i in range(n_steps):
        leaves = opt_mod.tree_leaves(wp)
        for x in leaves:
            x.requires_grad_(True)
        loss = loss_fn(wp)
        grads = torch.autograd.grad(loss, leaves)
        losses.append(loss.detach())
        tf = one * (i + 1)
        bc1, bc2 = 1 - torch.pow(one * b1, tf), 1 - torch.pow(one * b2, tf)
        new = []
        with torch.no_grad():
            for x, g, mm, vv in zip(leaves, grads, opt_mod.tree_leaves(mom),
                                    opt_mod.tree_leaves(vel)):
                mm.mul_(b1).add_((1 - b1) * g)
                vv.mul_(b2).add_((1 - b2) * g * g)
                new.append(x - lr * (mm / bc1) / (torch.sqrt(vv / bc2) + eps))
        it = iter(new)
        wp = opt_mod.tree_map(lambda _: next(it), wp)
    params = dict(p)
    params.update(wp)
    losses = torch.stack(losses) if losses else xyz.new_zeros((0,))
    return state.replace(params=params), losses


def stage_transition(state: GaussianState, opt_state, cfg: Config,
                     iteration: int,
                     generator: Optional[torch.Generator] = None,
                     start_idx=None, quiet: bool = True):
    """The host event at the first iteration of a stage, as the JAX
    Trainer makes it: entering stage 2 (second_stage_iteration + 1) the
    keypoints are set by set_super_keypoints (when none is alive yet), the
    weight model pre-fit by distill_weight_init when
    cfg.train.distill_init_steps > 0 (its first and last loss printed
    unless quiet), and Adam starts afresh; entering stage 3 Adam starts
    afresh. At any other iteration nothing changes. Returns (state,
    opt_state)."""
    if iteration == cfg.train.second_stage_iteration + 1 \
            and int(state.n_kpts()) == 0:
        state = set_super_keypoints(state, cfg, generator, start_idx)
        n = cfg.train.distill_init_steps
        if n > 0:
            state, losses = distill_weight_init(state, cfg, n)
            if not quiet:
                print(f"[iter {iteration}] distill init: blend-teacher mse "
                      f"{float(losses[0]):.3e} -> {float(losses[-1]):.3e}")
        return state, opt_mod.init_adam(state.params)
    if iteration == cfg.train.third_stage_iteration + 1:
        return state, opt_mod.init_adam(state.params)
    return state, opt_state


class Trainer:
    """Owns the training state; `run()` trains to cfg.opt.iterations.

    `device` (None means CUDA) holds the state and runs every step and
    event; steps_per_call iterations go to it in one call where no host
    event intervenes. n_devices > 1 (the module docstring) needs a
    process group of n_devices ranks, n_devices % n_data == 0, and this
    rank's device (cuda:LOCAL_RANK, or the CPU)."""

    def __init__(self, cfg: Config, scene, seed: Optional[int] = None,
                 device=None, log_every: int = 100, quiet: bool = False,
                 steps_per_call: int = 1, n_devices: int = 1,
                 n_data: int = 1):
        from gaussianprediction_tpu_torch.device import resolve_device

        self.steps_per_call = steps_per_call
        self.mesh = None
        self.n_data = n_data
        self.rank = 0
        if n_devices > 1:
            self.mesh = _trainer_mesh(n_devices, n_data)
            self.rank = self.mesh.rank
            quiet = quiet or self.rank != 0
        self.cfg = cfg
        self.scene = scene
        self.device = resolve_device(device)
        self.log_every = log_every
        self.quiet = quiet
        seed = cfg.train.seed if seed is None else seed
        self.seed = seed
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(2024 * seed)
        self.state = self._init_state()
        self.opt_state = opt_mod.init_adam(self.state.params)
        self.iteration = 0
        self.active_sh_degree = 0
        self.bg = (np.ones(3, np.float32) if cfg.model.white_background
                   else np.zeros(3, np.float32))
        self._bg = torch.as_tensor(self.bg, device=self.device)
        cam0 = scene.train_cameras[0]
        self.width, self.height = cam0.width, cam0.height
        self.extent = float(scene.cameras_extent)
        self._batched_steps: Dict = {}   # (stage, batch) -> batched step
        self._multi_steps: Dict = {}     # (stage, k) -> multi step
        self._sharded_steps: Dict = {}   # (stage, multiplier) -> step
        self._views: Dict = {}     # camera -> (device dict, time, gt)
        self._history = []
        self._did_stage3 = False
        self._last_log = 0
        self._last_t_iter = 0
        self._warned_dropped = False
        self._last_cam = None
        self.tb = None  # TensorBoard event writer, created in run()
        if cfg.model.capacity_auto:
            self._auto_capacity(reason="init")

    # ---- random draws, one method per kind of event -----------------------
    def _init_state(self) -> GaussianState:
        """The model from the scene's point cloud; its random parts (motion
        features, deform MLP, blend-weight model) from the generator."""
        from gaussianprediction_tpu_torch.models.gaussians import (
            create_from_pcd,
        )

        info = self.scene.info
        return create_from_pcd(self.cfg, info.points, info.colors,
                               generator=self.generator, device=self.device)

    def _randn(self, shape):
        return torch.randn(shape, generator=self.generator,
                           device=self.device)

    def _step_noise(self, stage: int):
        """(xyz noise, time noise) of one step, N(0,1) before their
        anneals: [C, 3] in stage 1, [Ck, 3] (the keypoints) in stages 2/3,
        None in stage 0; the time noise a 0-d draw, None without
        use_time_decay."""
        p = self.state.params
        noise = None
        if stage >= 1:
            noise = self._randn(p["xyz" if stage == 1 else "super_xyz"].shape)
        time_noise = self._randn(()) if self.cfg.train.use_time_decay \
            else None
        return noise, time_noise

    def _sharded_noise(self, stage: int):
        """The sharded step's draws: _step_noise's, then one more time
        noise for each further data group."""
        noise, time_noise = self._step_noise(stage)
        if time_noise is None:
            return noise, None
        return noise, [time_noise] + [self._randn(())
                                      for _ in range(self.n_data - 1)]

    def _chunk_noise(self, stage: int, k: int):
        """The draws of k steps (a chunk, or a batch's members): (xyz
        noises, time noises), k _step_noise draws in order."""
        draws = [self._step_noise(stage) for _ in range(k)]
        return [d[0] for d in draws], [d[1] for d in draws]

    def _densify_noise(self):
        """The split's N(0,1) offsets [2, C, 3], before the scale."""
        return self._randn((2, self.state.capacity, 3))

    def _kmeans_start(self):
        """The k-means seed row, uniform in [0, C)."""
        return torch.randint(0, self.state.capacity, (),
                             generator=self.generator, device=self.device)

    # ---- instance capacity -------------------------------------------------
    def _probe_need(self, n_cams: int = 8) -> int:
        """The largest slot need of the canonical Gaussians over up to
        n_cams training cameras (one device sync per camera)."""
        from gaussianprediction_tpu_torch.models.gaussians import (
            opacity_act, scaling_act,
        )
        from gaussianprediction_tpu_torch.ops.instance_stream import (
            probe_slot_need,
        )

        cams = self.scene.train_cameras
        sample = cams[:: max(1, len(cams) // n_cams)][:n_cams]
        p = self.state.params
        with torch.no_grad():
            scaling, opacity = scaling_act(p["scaling"]), \
                opacity_act(p["opacity"])
            return max(int(probe_slot_need(
                p["xyz"], scaling, p["rotation"], opacity,
                self._view(c)[0], self.width, self.height,
                alive=self.state.alive)) for c in sample)

    def _auto_capacity(self, reason: str, slack: float = 1.3,
                       iteration: Optional[int] = None):
        """Size capacity_multiplier from the probed slot need, in steps of
        0.5 with 1.3x slack. Growing always applies; shrinking by a whole
        step or more applies at init and load, or while footprints are
        stable (past half an opacity-reset interval), so the collapse after
        a reset is not taken only to grow back. The steps read the
        multiplier at each call, so the next step uses it."""
        need = self._probe_need()
        cap = max(self.state.capacity, 1)
        mult = max(2.0, math.ceil(slack * need / cap * 2.0) / 2.0)
        cur = float(self.cfg.model.capacity_multiplier)
        grow = mult > cur
        ri = max(self.cfg.opt.opacity_reset_interval, 1)
        it = self.iteration if iteration is None else iteration
        stable = (it % ri) > ri // 2
        shrink = mult <= cur - 1.0 and (stable or reason in ("init", "load"))
        if reason in ("init", "load") or grow or shrink:
            self.cfg.model.capacity_multiplier = mult
            if not self.quiet:
                print(f"[capacity] {reason}: probe {need} slots; multiplier "
                      f"{cur:.2f} -> {mult:.2f}")

    # ---- the steps ---------------------------------------------------------
    def _batched_step_fn(self, stage: int, batch: int):
        key = (stage, batch)
        if key not in self._batched_steps:
            from gaussianprediction_tpu_torch.train.step import (
                make_train_step_batched,
            )

            self._batched_steps[key] = make_train_step_batched(
                self.cfg, stage, self.width, self.height, self.extent,
                self.cfg.model.sh_degree, self.scene.total_frame, self._bg,
                batch)
        return self._batched_steps[key]

    def _sharded_step_fn(self, stage: int):
        """The sharded step at the current capacity multiplier (a re-probe
        reaches the next step, as it reaches the single one)."""
        mult = float(self.cfg.model.capacity_multiplier)
        key = (stage, mult)
        if key not in self._sharded_steps:
            from gaussianprediction_tpu_torch.parallel.shard import (
                make_sharded_train_step,
            )

            self._sharded_steps[key] = make_sharded_train_step(
                self.cfg, stage, self.width, self.height, self.extent,
                self.cfg.model.sh_degree, self.scene.total_frame, self._bg,
                self.mesh, capacity_multiplier=mult)[0]
        return self._sharded_steps[key]

    def _chunk_end(self, a: int, iterations: int,
                   span: Optional[int] = None) -> int:
        """The largest b >= a, at most a + span - 1 (span defaults to
        steps_per_call), such that iterations [a, b] hold no host event:
        no SH bump or stage start in (a, b], no densify, reset,
        keypoint-growth, save, checkpoint or report iteration in [a, b)
        (the JAX Trainer's). One event more than the JAX Trainer's: the
        white-background opacity reset at densify_from_iter, which the
        JAX chunks step over where densify_from_iter is no multiple of
        densification_interval."""
        o, t = self.cfg.opt, self.cfg.train
        span = self.steps_per_call if span is None else span

        def next_mult(x, m):
            return (x // m + 1) * m

        pre = [next_mult(a, 1000)] + [
            e for e in (t.jointly_iteration, t.second_stage_iteration + 1,
                        t.third_stage_iteration + 1) if e > a]
        post = [next_mult(a - 1, o.densification_interval),
                next_mult(a - 1, o.opacity_reset_interval),
                next_mult(a - 1, t.adaptive_interval)]
        post += [e for e in (list(t.save_iterations)
                             + list(t.checkpoint_iterations)
                             + list(t.test_iterations)) if e >= a]
        if self.cfg.model.white_background and \
                a <= o.densify_from_iter < o.densify_until_iter:
            post.append(o.densify_from_iter)
        return min(a + span - 1, iterations, min(pre) - 1, min(post))

    def _multi_step_fn(self, stage: int, k: int):
        """The multi step of k iterations (k = 1 for train_one); it reads
        the capacity multiplier at each call."""
        key = (stage, k)
        if key not in self._multi_steps:
            from gaussianprediction_tpu_torch.train.step import (
                make_train_step_multi,
            )

            self._multi_steps[key] = make_train_step_multi(
                self.cfg, stage, self.width, self.height, self.extent,
                self.cfg.model.sh_degree, self.scene.total_frame, self._bg,
                k)
        return self._multi_steps[key]

    def _view(self, cam):
        """(camera dict, time, ground truth) on the device, made once per
        camera."""
        key = id(cam)
        if key not in self._views:
            gt = cam.load_image()
            self._views[key] = (
                cam.to_device_dict(self.device),
                torch.tensor(cam.time, dtype=torch.float32,
                             device=self.device),
                None if gt is None else torch.tensor(
                    np.asarray(gt, np.float32), device=self.device))
        return self._views[key]

    # ---- host events -------------------------------------------------------
    def _maybe_stage_transition(self, iteration: int):
        cfg = self.cfg
        if (iteration == cfg.train.second_stage_iteration + 1
                and int(self.state.n_kpts()) == 0):
            self.state, self.opt_state = stage_transition(
                self.state, self.opt_state, cfg, iteration,
                start_idx=self._kmeans_start(), quiet=self.quiet)
            if not self.quiet:
                print(f"[iter {iteration}] stage 2: keypoints initialized "
                      f"({int(self.state.n_kpts())})")
        if (iteration == cfg.train.third_stage_iteration + 1
                and not self._did_stage3):
            self._did_stage3 = True
            self.opt_state = opt_mod.init_adam(self.state.params)
            if not self.quiet:
                print(f"[iter {iteration}] stage 3: joint optimization")

    def _densification(self, iteration: int, stage: int):
        """The JAX Trainer's decisions, each host read of a count made only
        where the event's other conditions hold."""
        from gaussianprediction_tpu_torch.train import densify as dn

        cfg = self.cfg
        o = cfg.opt
        if iteration < o.densify_until_iter:
            cadence = (iteration > o.densify_from_iter
                       and iteration % o.densification_interval == 0)
            if cadence and int(self.state.n_alive()) < \
                    cfg.model.max_gaussian_size:
                self.state, self.opt_state = dn.densify_and_prune_clone_split(
                    self.state, self.opt_state, cfg, self.extent,
                    noise=self._densify_noise())
            if iteration % o.opacity_reset_interval == 0 or (
                    cfg.model.white_background
                    and iteration == o.densify_from_iter):
                self.state, self.opt_state = dn.reset_opacity(
                    self.state, self.opt_state)
            if cadence:
                size_thr = 20 if iteration > o.opacity_reset_interval \
                    else None
                self.state = dn.prune(self.state, cfg, self.extent, size_thr)
                if cfg.model.capacity_auto:
                    self._auto_capacity(reason="densify",
                                        iteration=iteration)

        # keypoint growth: from the teaching residual first, then from the
        # gradients (the reference's in-loop order)
        t = cfg.train
        if stage >= 2 and (t.densify_from_grad or t.densify_from_teaching):
            s2 = t.second_stage_iteration
            if (t.adaptive_from_iter + s2 < iteration
                    < t.adaptive_end_iter + s2
                    and iteration % t.adaptive_interval == 0
                    and int(self.state.n_kpts()) < cfg.model.kpt_capacity()):
                max_new = max(cfg.model.adaptive_points_num, 1)
                if t.densify_from_teaching:
                    self.state, self.opt_state = \
                        dn.grow_keypoints_from_teaching(
                            self.state, self.opt_state, cfg, max_new)
                if t.densify_from_grad:
                    self.state, self.opt_state = dn.grow_keypoints_from_grads(
                        self.state, self.opt_state, cfg, max_new)
                if not self.quiet:
                    print(f"[iter {iteration}] keypoints -> "
                          f"{int(self.state.n_kpts())}")

    def training_report(self, iteration: int) -> Dict:
        """In-training evaluation: render the test split and 5 train views
        at a fixed stride, log the mean L1 and PSNR to stdout, the history
        and TensorBoard."""
        from gaussianprediction_tpu_torch.eval.render import render_set
        from gaussianprediction_tpu_torch.utils.image import psnr

        scene = self.scene
        n_train = len(scene.train_cameras)
        train_sample = [scene.train_cameras[idx % n_train]
                        for idx in range(5, 30, 5)] if n_train else []
        report: Dict = {"iter": iteration}
        for name, views in (("test", scene.test_cameras),
                            ("train", train_sample)):
            if not views:
                continue
            renders, gts, _ = render_set(
                self.state, self.cfg, iteration, views, self.bg,
                sh_degree=self.active_sh_degree)
            l1s, psnrs = [], []
            for r, g in zip(renders, gts):
                l1s.append(float(np.mean(np.abs(r - g))))
                psnrs.append(float(psnr(torch.tensor(r), torch.tensor(g))))
            report[f"{name}_l1"] = float(np.mean(l1s))
            report[f"{name}_psnr"] = float(np.mean(psnrs))
            if not self.quiet:
                print(f"[ITER {iteration}] eval {name}: "
                      f"L1 {report[f'{name}_l1']:.5f} "
                      f"PSNR {report[f'{name}_psnr']:.2f}")
            if self.tb is not None:
                self.tb.add_scalar(f"{name}/loss_viewpoint_l1",
                                   report[f"{name}_l1"], iteration)
                self.tb.add_scalar(f"{name}/loss_viewpoint_psnr",
                                   report[f"{name}_psnr"], iteration)
                if renders:
                    self.tb.add_image(f"{name}/render",
                                      np.clip(renders[0], 0, 1), iteration)
        if self.tb is not None:
            alive = self.state.alive.cpu().numpy()
            opac = torch.sigmoid(self.state.params["opacity"]).reshape(-1)
            self.tb.add_histogram("scene/opacity_histogram",
                                  opac.cpu().numpy()[alive], iteration)
            self.tb.add_scalar("total_points", float(alive.sum()), iteration)
            self.tb.flush()
        self._history.append({"eval": report})
        return report

    # ---- main loop ---------------------------------------------------------
    def _start(self, iteration: int) -> int:
        """The host events that open an iteration (the SH bump every 1k, a
        stage transition); returns its stage."""
        if iteration % 1000 == 0 and \
                self.active_sh_degree < self.cfg.model.sh_degree:
            self.active_sh_degree += 1
        self._maybe_stage_transition(iteration)
        return stage_of(self.cfg, iteration)

    def _next_views(self, k: int):
        """The next k training cameras' (camera dicts, targets, times)."""
        cams = [self.scene.next_train_camera() for _ in range(k)]
        views = [self._view(c) for c in cams]
        self._last_cam = cams[-1]
        return [v[0] for v in views], [v[2] for v in views], \
            [v[1] for v in views]

    def train_one(self, iteration: int) -> Dict:
        return self.train_chunk(iteration, iteration)

    def train_one_sharded(self, iteration: int) -> Dict:
        """One sharded step: n_data cameras (their gradients summed over
        'data'), each frame split into tile bands over 'tile'."""
        stage = self._start(iteration)
        cams, gts, times = self._next_views(self.n_data)
        noise, time_noises = self._sharded_noise(stage)
        self.state, self.opt_state, metrics = self._sharded_step_fn(stage)(
            self.state, self.opt_state, cams, gts, times, iteration,
            active_deg=self.active_sh_degree, noise=noise,
            time_noises=time_noises)
        metrics.pop("grads", None)
        self._densification(iteration, stage)
        return metrics

    def train_batch(self, a: int, b: int) -> Dict:
        """Gradient accumulation over iterations [a, b] with ONE optimizer
        step (the reference's --batch). The SH bump and the stage
        transition happen at a, the other host events at b only (the
        caller picks [a, b] by _chunk_end)."""
        return self._train_span(a, b, self._batched_step_fn)

    def train_chunk(self, a: int, b: int) -> Dict:
        """Iterations [a, b] in one call of the multi step (the caller
        picks [a, b] by _chunk_end, in one stage; train_one is the chunk
        [a, a]). The SH bump and the stage transition happen at a, the
        other host events at b."""
        return self._train_span(a, b, self._multi_step_fn)

    def _train_span(self, a: int, b: int, step_fn) -> Dict:
        """Iterations [a, b] through step_fn(stage, b - a + 1): the SH
        bump and the stage transition at a, the next b - a + 1 cameras
        and _chunk_noise's draws, the other host events at b."""
        stage = self._start(a)
        k = b - a + 1
        cams, gts, times = self._next_views(k)
        noises, time_noises = self._chunk_noise(stage, k)
        self.state, self.opt_state, metrics = step_fn(stage, k)(
            self.state, self.opt_state, cams, gts, times, a,
            active_deg=self.active_sh_degree, noises=noises,
            time_noises=time_noises)
        metrics.pop("grads", None)
        self._densification(b, stage)
        return metrics

    def _profile_stop(self, prof, first: int, last: int, prof_dir: str):
        """Synchronise, stop the profiler and write its Chrome trace of
        iterations [first, last] into prof_dir."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        os.makedirs(prof_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            prof_dir, f"trace_iter{first}-{last}.json"))
        if not self.quiet:
            print(f"[iter {last}] profile trace -> {prof_dir}")

    def run(self, iterations: Optional[int] = None,
            model_path: Optional[str] = None):
        cfg = self.cfg
        iterations = iterations or cfg.opt.iterations
        # under a mesh every rank trains and rank 0 alone reports and writes
        model_path = (model_path or cfg.model_path) if self.rank == 0 \
            else None
        if model_path and self.tb is None:
            from gaussianprediction_tpu_torch.utils.tb_writer import (
                SummaryWriter,
            )

            self.tb = SummaryWriter(os.path.join(model_path, "tb"))
        t0 = time.time()
        t_last = t0
        iteration = self.iteration
        batch = max(1, cfg.train.batch)
        k = self.steps_per_call
        # the profiler window: profile_steps iterations from the first one
        # >= profile_from (a chunk counts as its iterations), rank 0 only
        prof_n = cfg.train.profile_steps if self.rank == 0 else 0
        prof_dir = os.path.join(model_path or ".", "profile")
        prof = None
        while iteration < iterations:
            a = iteration + 1
            if prof_n > 0 and prof is None and a >= cfg.train.profile_from:
                from torch.profiler import ProfilerActivity, profile

                acts = [ProfilerActivity.CPU] + (
                    [ProfilerActivity.CUDA] if self.device.type == "cuda"
                    else [])
                prof = profile(activities=acts)
                prof.start()
                prof_first, prof_end = a, a + prof_n - 1
            if self.mesh is not None:
                metrics = self.train_one_sharded(a)
                iteration = a
            elif batch > 1:
                b = self._chunk_end(a, iterations, batch)
                if b - a + 1 == batch:
                    metrics = self.train_batch(a, b)
                    iteration = b
                else:
                    metrics = self.train_one(a)
                    iteration = a
            elif k > 1:
                b = self._chunk_end(a, iterations)
                if b - a + 1 == k and stage_of(cfg, a) == stage_of(cfg, b):
                    metrics = self.train_chunk(a, b)
                    iteration = b
                else:
                    metrics = self.train_one(a)
                    iteration = a
            else:
                metrics = self.train_one(a)
                iteration = a
            self.iteration = iteration
            if prof is not None and iteration >= prof_end:
                self._profile_stop(prof, prof_first, iteration, prof_dir)
                prof, prof_n = None, 0
            if iteration - self._last_log >= self.log_every:
                self._last_log = iteration
                t_last = self._log(iteration, iterations, metrics, t0, t_last)
            if iteration in cfg.train.test_iterations and self.rank == 0:
                self.training_report(iteration)
            if model_path and iteration % 5000 == 0:
                self._save_train_images(model_path, iteration)
            if model_path:
                if iteration in cfg.train.save_iterations:
                    from gaussianprediction_tpu_torch.models.gaussians import (
                        save_ply,
                    )

                    save_ply(self.state, os.path.join(
                        model_path, f"point_cloud/iteration_{iteration}",
                        "point_cloud.ply"))
                if iteration in cfg.train.checkpoint_iterations:
                    self.save_checkpoint(os.path.join(
                        model_path, f"chkpnt{iteration}.npz"))
        if prof is not None:        # the run ended inside the window
            self._profile_stop(prof, prof_first, iteration, prof_dir)
        if model_path:
            os.makedirs(model_path, exist_ok=True)
            with open(os.path.join(model_path, "history.json"), "w") as f:
                json.dump(self._history, f)
        if self.tb is not None:
            self.tb.flush()
        return self._history

    def _log(self, iteration: int, iterations: int, metrics, t0: float,
             t_last: float) -> float:
        """One history entry (and TensorBoard scalars) at the log cadence;
        the only host reads of the step's metrics. Returns the time."""
        loss = float(metrics["loss"])
        p = float(metrics["psnr"])
        nd = int(metrics.get("n_dropped", 0))
        if nd > 0 and not self._warned_dropped:
            self._warned_dropped = True
            print(f"WARNING [iter {iteration}]: instance buffer overflow — "
                  f"{nd} tile instances dropped; rendered images and "
                  f"gradients are biased. Raise "
                  f"cfg.model.capacity_multiplier.")
        now = time.time()
        iter_ms = (now - t_last) * 1000.0 / max(
            iteration - self._last_t_iter, 1)
        self._last_t_iter = iteration
        entry = {"iter": iteration, "loss": loss, "psnr": p,
                 "n_gaussians": int(self.state.n_alive()),
                 "n_kpts": int(self.state.n_kpts()),
                 "n_dropped": nd, "elapsed": now - t0}
        self._history.append(entry)
        if self.tb is not None:
            self.tb.add_scalar("train_loss_patches/total_loss", loss,
                               iteration)
            self.tb.add_scalar("train/psnr", p, iteration)
            self.tb.add_scalar("iter_time", iter_ms, iteration)
            self.tb.add_scalar("total_points", entry["n_gaussians"],
                               iteration)
        if not self.quiet:
            print(f"[{iteration}/{iterations}] loss {loss:.5f} psnr {p:.2f} "
                  f"n={entry['n_gaussians']}")
        return now

    def _save_train_images(self, model_path: str, iteration: int):
        """Render the last training camera at the current parameters (at
        the max SH degree: inactive coefficients are still zero) into
        <model_path>/train_imgs/ beside its ground truth. The noise of the
        render comes from a generator of its own, seeded 0."""
        cam = self._last_cam
        if cam is None:
            return
        from gaussianprediction_tpu_torch.eval.render import save_image
        from gaussianprediction_tpu_torch.train.step import render_at_time

        cam_d, t, gt = self._view(cam)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(0)
        with torch.no_grad():
            pkg, _ = render_at_time(
                self.state.params, self.cfg, self.state, cam_d, t, iteration,
                gen, stage_of(self.cfg, iteration), self.width, self.height,
                self._bg, self.cfg.model.sh_degree)
        d = os.path.join(model_path, "train_imgs")
        save_image(os.path.join(d, f"render_{iteration:05d}.png"),
                   torch.clamp(pkg["render"], 0.0, 1.0).cpu().numpy())
        if gt is not None:
            save_image(os.path.join(d, f"gt_{iteration:05d}.png"),
                       gt.cpu().numpy())

    def save_checkpoint(self, path: str):
        from gaussianprediction_tpu_torch.train import checkpoint as ckpt

        ckpt.save_checkpoint(path, self.state, self.opt_state,
                             self.iteration, self.generator, self.seed)

    def load_checkpoint(self, path: str):
        """Restore a checkpoint of either package; the generator's state
        too where the checkpoint has it (the port's own)."""
        from gaussianprediction_tpu_torch.train import checkpoint as ckpt

        self.state, self.opt_state, self.iteration, gen = \
            ckpt.load_checkpoint(path, self.device)
        if gen is not None:
            self.generator.set_state(gen)
        # resume the SH warm-up where the run left off (one degree per 1k)
        self.active_sh_degree = min(self.cfg.model.sh_degree,
                                    self.iteration // 1000)
        if self.cfg.model.capacity_auto:
            self._auto_capacity(reason="load")


def _trainer_mesh(n_devices: int, n_data: int):
    """The Trainer's mesh: n_data x (n_devices / n_data) over every rank of
    the process group, which must have n_devices ranks."""
    import torch.distributed as dist

    from gaussianprediction_tpu_torch.parallel.distributed import LAUNCH
    from gaussianprediction_tpu_torch.parallel.mesh import make_mesh

    if n_data < 1 or n_devices % n_data:
        raise ValueError(f"n_devices ({n_devices}) must be a multiple of "
                         f"n_data ({n_data})")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n_devices:
        raise RuntimeError(
            f"n_devices={n_devices} needs a process group of {n_devices} "
            f"ranks, one a GPU; this process is one of {world}. Launch it "
            f"as: {LAUNCH}")
    return make_mesh(n_data=n_data, n_tile=n_devices // n_data)
