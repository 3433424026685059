"""The training step of every stage, and the deform + render entry.

Torch twin of gaussianprediction_tpu/train/step.py (time_with_noise,
deform_for_stage, render_at_time, make_train_step). One step: time noise;
deform (stage 0: the canonical Gaussians, stage 1: the per-Gaussian deform
MLP, stages 2/3: the keypoint blend through the hash-grid weight model);
render with the NDC-scale means2d carrier; loss = (1-λ)L1 + λ(1-SSIM) +
the motion-feature regularizer; backward (the blend, instance-stream and
table-gradient kernels' own backward); the densification statistics from
the carrier's gradient norm (from stage 2 on also inside the keypoint-
growth window, and the teacher residual under densify_from_teaching);
masked per-group Adam.

Random draws come from a torch.Generator, or are passed pre-drawn (the
parity tests hand both packages the same N(0,1) draws; the Trainer,
train/loop.py, passes its own). The batched steps wait for a later slice
(ROADMAP.md).
"""
from __future__ import annotations

from typing import Optional

import torch

from gaussianprediction_tpu_torch.config import Config
from gaussianprediction_tpu_torch.models import deform as D
from gaussianprediction_tpu_torch.models.gaussians import (
    GaussianState, get_shs,
)
from gaussianprediction_tpu_torch.ops import rasterize
from gaussianprediction_tpu_torch.train import optimizer as opt_mod
from gaussianprediction_tpu_torch.train.loop import stage_of  # noqa: F401
from gaussianprediction_tpu_torch.utils.image import (
    dssim_l1_loss, l1_loss, psnr,
)
from gaussianprediction_tpu_torch.utils.schedules import linear_anneal


def _randn(shape, generator: Optional[torch.Generator], device):
    gdev = generator.device if generator is not None else device
    return torch.randn(shape, generator=generator, device=gdev).to(device)


def deform_for_stage(params, cfg: Config, state: GaussianState, t,
                     iteration: int, generator: Optional[torch.Generator],
                     stage: int, noise=None):
    if stage == 0:
        assert noise is None, "pre-drawn noise only applies to stage 1"
        return D.deform_warmup(params, cfg)
    if stage == 1:
        return D.deform_stage1(params, cfg, state, t, iteration, generator,
                               noise=noise)
    return D.deform_stage23(params, cfg, state, t, iteration, generator,
                            noise=noise)


def time_with_noise(cfg: Config, t, iteration: int,
                    generator: Optional[torch.Generator], stage: int,
                    total_frame: int, noise=None):
    """t + N(0,1) * time_noise_ratio / total_frame * anneal, when
    use_time_decay is on; from stage 2 on the anneal restarts at the
    stage-2 start and runs twice as long. `noise` is the N(0,1) draw, or
    None to draw it from `generator`."""
    if not cfg.train.use_time_decay:
        return t
    if stage >= 2:
        anneal = linear_anneal(iteration - cfg.train.second_stage_iteration,
                               1.0, cfg.train.time_noise_iteration * 2)
    else:
        anneal = linear_anneal(iteration, 1.0,
                               cfg.train.time_noise_iteration)
    if noise is None:
        noise = _randn((), generator, t.device)
    noise = torch.as_tensor(noise, dtype=torch.float32, device=t.device)
    return t + noise * cfg.train.time_noise_ratio / total_frame * \
        anneal.to(t.device)


def render_at_time(params, cfg: Config, state: GaussianState, cam, t,
                   iteration: int, generator: Optional[torch.Generator],
                   stage: int, width: int, height: int, bg, sh_degree: int,
                   need_tidx: bool = False, active_sh_degree=None,
                   noise=None, means2d_dummy=None):
    """Deform + render one view at time t (a 0-d f32 tensor).

    active_sh_degree zeroes the coefficients beyond (deg+1)^2 under the
    max-degree basis, as the JAX twin does."""
    out = deform_for_stage(params, cfg, state, t, iteration, generator,
                           stage, noise=noise)
    shs = get_shs(params)          # [C, 3, K]
    if active_sh_degree is not None:
        kidx = torch.arange(shs.shape[-1], device=shs.device)
        shs = torch.where(kidx[None, None, :] < (active_sh_degree + 1) ** 2,
                          shs, torch.zeros_like(shs))
    pkg = rasterize.render(
        out.xyz, out.scaling, out.rotation, out.opacity, shs, cam, width,
        height, bg, sh_degree=sh_degree, alive=state.alive,
        capacity_multiplier=cfg.model.capacity_multiplier,
        need_tidx=need_tidx, means2d_dummy=means2d_dummy,
    )
    return pkg, out


def make_train_step(cfg: Config, stage: int, width: int, height: int,
                    spatial_scale: float, sh_degree: int, total_frame: int,
                    bg):
    """The training step of one stage:

    step(state, opt_state, cam, gt, t, iteration, generator=None,
         active_deg=None, noise=None, time_noise=None)
      -> (state, opt_state, metrics)

    gt is the [H, W, 3] target, t a 0-d f32 tensor, iteration the global
    iteration. noise and time_noise (0-d) are the N(0,1) draws of the xyz
    and time jitter, drawn from `generator` when None; noise is [C, 3] (the
    Gaussians) in stage 1 and [Ck, 3] (the keypoints) in stages 2/3.
    metrics: loss, l1, psnr, n_dropped, and grads (the gradient of every
    trainable param, the JAX package's tree layout)."""
    opt_stage = max(stage, 1)
    s2 = cfg.train.second_stage_iteration
    groups = opt_mod.active_groups(cfg, opt_stage)

    def loss_and_grads(state, cam, gt, t, iteration, generator, active_deg,
                       noise):
        trainable = [k for k in state.params
                     if opt_mod.GROUP_OF_PARAM[k] in groups]
        params = dict(state.params)
        for k in trainable:
            params[k] = opt_mod.tree_map(
                lambda x: x.detach().requires_grad_(True), params[k])
        dummy = torch.zeros((state.capacity, 2), dtype=torch.float32,
                            device=state.device, requires_grad=True)
        pkg, dout = render_at_time(
            params, cfg, state, cam, t, iteration, generator, stage, width,
            height, bg, sh_degree, active_sh_degree=active_deg, noise=noise,
            means2d_dummy=dummy)
        img = pkg["render"]
        loss = dssim_l1_loss(img, gt, cfg.opt.lambda_dssim) + \
            D.motion_feature_reg(params, stage)
        leaves = [x for k in trainable for x in opt_mod.tree_leaves(params[k])]
        got = torch.autograd.grad(loss, leaves + [dummy], allow_unused=True)
        got = [torch.zeros_like(x) if g is None else g
               for x, g in zip(leaves + [dummy], got)]
        it = iter(got)
        grads = {k: opt_mod.tree_map(lambda _: next(it), params[k])
                 for k in trainable}
        aux = {
            "l1": l1_loss(img, gt).detach(),
            "psnr": psnr(img, gt).detach(),
            "radii": pkg["radii"],
            "visibility": pkg["visibility_filter"],
            "n_dropped": pkg["n_dropped"],
            "delta_xyz": (None if dout.delta_xyz is None
                          else dout.delta_xyz.detach()),
        }
        return loss.detach(), grads, next(it), aux

    def step(state: GaussianState, opt_state, cam, gt, t, iteration: int,
             generator: Optional[torch.Generator] = None, active_deg=None,
             noise=None, time_noise=None):
        t = time_with_noise(cfg, t, iteration, generator, stage, total_frame,
                            noise=time_noise)
        loss, grads, vs_grads, aux = loss_and_grads(
            state, cam, gt, t, iteration, generator, active_deg, noise)
        with torch.no_grad():
            # densification statistics
            vis = aux["visibility"]
            vs_norm = torch.linalg.norm(vs_grads, dim=-1)
            do_stats = vis if iteration < cfg.opt.densify_until_iter \
                else torch.zeros_like(vis)
            if stage >= 2 and iteration < cfg.train.adaptive_end_iter + s2:
                # the keypoint-growth window, while free keypoint rows last
                do_stats = do_stats | (
                    vis & (state.n_kpts() < cfg.model.kpt_capacity()))
            state = state.replace(
                max_radii2D=torch.where(
                    do_stats, torch.maximum(state.max_radii2D, aux["radii"]),
                    state.max_radii2D),
                xyz_gradient_accum=state.xyz_gradient_accum + torch.where(
                    do_stats, vs_norm, torch.zeros_like(vs_norm)),
                xyz_gradient_accum_max=torch.where(
                    do_stats & (vs_norm > state.xyz_gradient_accum_max),
                    vs_norm, state.xyz_gradient_accum_max),
                denom=state.denom + do_stats.to(torch.float32),
            )
            if stage >= 2 and cfg.train.densify_from_teaching:
                in_window = (cfg.train.adaptive_from_iter + s2 <= iteration
                             < cfg.train.adaptive_end_iter + s2)
                if in_window:
                    resid = D.teacher_motion_residual(
                        state.params, cfg, D.time_encode(cfg, t),
                        aux["delta_xyz"])
                    state = state.replace(
                        xyz_motion_accum_max=torch.where(
                            resid > state.xyz_motion_accum_max, resid,
                            state.xyz_motion_accum_max),
                        motion_denom=state.motion_denom + 1.0)
            new_params, opt_state = opt_mod.adam_step(
                state.params, grads, opt_state, cfg, opt_stage,
                spatial_scale, iteration)
        state = state.replace(params=new_params)
        metrics = {"loss": loss, "l1": aux["l1"], "psnr": aux["psnr"],
                   "n_dropped": aux["n_dropped"], "grads": grads}
        return state, opt_state, metrics

    return step
