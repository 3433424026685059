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
train/loop.py, passes its own). What a step reads per iteration
(learning rates, noise anneals, the statistics' window flags) is computed
on the host and reaches the device as one table (step_scalars), so a
step makes no host synchronisation on the card.
make_train_step_multi runs K iterations in one call (make_train_step is
its body run once); make_train_step_batched accumulates the gradients of
several renders into one optimizer step.
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
                     stage: int, noise=None, sigma=None):
    """The stage's deform; noise and sigma as models/deform.py:_jitter
    takes them (stages 1-3)."""
    if stage == 0:
        assert noise is None, "pre-drawn noise only applies to stage 1"
        return D.deform_warmup(params, cfg)
    if stage == 1:
        return D.deform_stage1(params, cfg, state, t, iteration, generator,
                               noise=noise, sigma=sigma)
    return D.deform_stage23(params, cfg, state, t, iteration, generator,
                            noise=noise, sigma=sigma)


def time_noise_anneal(cfg: Config, iteration: int, stage: int):
    """The time jitter's anneal at a global iteration, a 0-d f32 tensor:
    1 down to 0 at time_noise_iteration; from stage 2 on it restarts at
    the stage-2 start and runs twice as long."""
    if stage >= 2:
        return linear_anneal(iteration - cfg.train.second_stage_iteration,
                             1.0, cfg.train.time_noise_iteration * 2)
    return linear_anneal(iteration, 1.0, cfg.train.time_noise_iteration)


def time_with_noise(cfg: Config, t, generator: Optional[torch.Generator],
                    total_frame: int, anneal, noise=None):
    """t + N(0,1) * time_noise_ratio / total_frame * anneal, when
    use_time_decay is on. `anneal` is time_noise_anneal as a 0-d tensor
    on t's device (the step's row of step_scalars); `noise` the N(0,1)
    draw, or None to draw it from `generator`."""
    if not cfg.train.use_time_decay:
        return t
    if noise is None:
        noise = _randn((), generator, t.device)
    noise = torch.as_tensor(noise, dtype=torch.float32, device=t.device)
    return t + noise * cfg.train.time_noise_ratio / total_frame * anneal


def render_at_time(params, cfg: Config, state: GaussianState, cam, t,
                   iteration: int, generator: Optional[torch.Generator],
                   stage: int, width: int, height: int, bg, sh_degree: int,
                   need_tidx: bool = False, active_sh_degree=None,
                   noise=None, means2d_dummy=None, sigma=None):
    """Deform + render one view at time t (a 0-d f32 tensor).

    active_sh_degree zeroes the coefficients beyond (deg+1)^2 under the
    max-degree basis, as the JAX twin does."""
    out = deform_for_stage(params, cfg, state, t, iteration, generator,
                           stage, noise=noise, sigma=sigma)
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


def trainable_params(state: GaussianState, groups):
    """(names of the params of the optimizer `groups`, the params with
    those leaves detached and requiring grad)."""
    trainable = [k for k in state.params
                 if opt_mod.GROUP_OF_PARAM[k] in groups]
    params = dict(state.params)
    for k in trainable:
        params[k] = opt_mod.tree_map(
            lambda x: x.detach().requires_grad_(True), params[k])
    return trainable, params


# step_scalars' columns after the learning rates: the xyz jitter's sigma
# (0 in stage 0), the time jitter's anneal, and 0/1 flags of the
# statistics' iteration windows
SCALARS = ("sigma", "time_anneal", "do_stats", "kpt_window", "teach_window")


def scalar_columns(cfg: Config, stage: int):
    """The names of step_scalars' columns at a stage: the learning rate of
    each optimizer group the stage trains, then SCALARS."""
    return opt_mod.active_groups(cfg, max(stage, 1)) + SCALARS


def row_lrs(cfg: Config, stage: int, row):
    """adam_step's learning rates {group: 0-d} from a row of step_scalars'
    table."""
    groups = opt_mod.active_groups(cfg, max(stage, 1))
    return {g: row[i] for i, g in enumerate(groups)}


def step_scalars(cfg: Config, stage: int, spatial_scale: float,
                 iterations) -> torch.Tensor:
    """What a step reads per iteration, as one [K, S] f32 table on the CPU
    for the K `iterations` (columns: scalar_columns): each trained
    optimizer group's learning rate, the xyz jitter's sigma, the time
    jitter's anneal, and the flags of the densification statistics
    (do_stats: iteration < densify_until_iter; kpt_window: stages 2/3
    before the keypoint-growth window's end; teach_window: stages 2/3
    inside that window, the teacher residual's). Every value is computed
    in f32 through utils/schedules.py one iteration at a time, as the
    host computes it for a single step: the card's exp, log and sin may
    round otherwise."""
    o, tr = cfg.opt, cfg.train
    s2 = tr.second_stage_iteration
    groups = opt_mod.active_groups(cfg, max(stage, 1))
    rows = []
    for it in iterations:
        late = stage >= 2 and it < tr.adaptive_end_iter + s2
        vals = [opt_mod.group_lr(g, cfg, spatial_scale, it) for g in groups]
        vals += [D.xyz_noise_sigma(cfg, it, stage) if stage
                 else torch.zeros(()), time_noise_anneal(cfg, it, stage)]
        vals += [torch.tensor(float(f)) for f in (
            it < o.densify_until_iter, late,
            late and it >= tr.adaptive_from_iter + s2)]
        rows.append(torch.stack([v.to(torch.float32).reshape(())
                                 for v in vals]))
    return torch.stack(rows)


def device_scalars(table, device):
    """step_scalars' table on `device`: on the card, one copy from pinned
    memory that does not block the host."""
    device = torch.device(device)
    if device.type != "cuda":
        return table.to(device)
    return table.pin_memory().to(device, non_blocking=True)


def _jitters(cfg: Config, stage: int, state: GaussianState, t, generator,
             total_frame: int, noise, time_noise, row, host_row):
    """(t with its time jitter, the xyz noise or None) of a step, from its
    row of step_scalars' table on the device and the same row on the
    host. Draws not given come from `generator`: the
    time noise, then the xyz noise where the host row's sigma is not 0,
    the order in which the deform drew them."""
    cols = scalar_columns(cfg, stage)
    t = time_with_noise(cfg, t, generator, total_frame,
                        row[cols.index("time_anneal")], noise=time_noise)
    if noise is None and stage >= 1 and \
            float(host_row[cols.index("sigma")]) != 0.0:
        x = state.params["xyz" if stage == 1 else "super_xyz"]
        noise = _randn(x.shape, generator, x.device)
    return t, noise


def _step_parts(cfg: Config, stage: int, width: int, height: int,
                spatial_scale: float, sh_degree: int, bg):
    """The two halves of a step, shared by every training step:
    loss_and_grads (one render, its loss and gradients; the graph is
    freed on return) and finish (the densification statistics and the
    masked Adam update)."""
    opt_stage = max(stage, 1)
    groups = opt_mod.active_groups(cfg, opt_stage)
    col = {k: i for i, k in enumerate(scalar_columns(cfg, stage))}

    def loss_and_grads(state, cam, gt, t, iteration, generator, active_deg,
                       noise, sigma=None):
        trainable, params = trainable_params(state, groups)
        dummy = torch.zeros((state.capacity, 2), dtype=torch.float32,
                            device=state.device, requires_grad=True)
        pkg, dout = render_at_time(
            params, cfg, state, cam, t, iteration, generator, stage, width,
            height, bg, sh_degree, active_sh_degree=active_deg, noise=noise,
            means2d_dummy=dummy, sigma=sigma)
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

    @torch.no_grad()
    def finish(state, opt_state, grads, vs_grads, radii, vis, row, t_resid,
               delta_xyz):
        """Statistics from the carrier's gradient vs_grads, the radii and
        the visibility, the teacher residual at time t_resid against
        delta_xyz (none when delta_xyz is None: the sharded step's, as
        the JAX sharded step keeps no teacher statistics), then Adam. row:
        the iteration's row of step_scalars' table on the state's device;
        its flags gate the statistics (torch.where, no host branch) and
        its learning rates drive Adam."""
        # row-major: the norm's rounding depends on the layout, and the
        # sharded step's all-reduced carrier gradient is row-major
        vs_norm = torch.linalg.norm(vs_grads.contiguous(), dim=-1)
        do_stats = vis & (row[col["do_stats"]] > 0)
        if stage >= 2:
            # the keypoint-growth window, while free keypoint rows last
            do_stats = do_stats | (
                vis & (row[col["kpt_window"]] > 0)
                & (state.n_kpts() < cfg.model.kpt_capacity()))
        state = state.replace(
            max_radii2D=torch.where(
                do_stats, torch.maximum(state.max_radii2D, radii),
                state.max_radii2D),
            xyz_gradient_accum=state.xyz_gradient_accum + torch.where(
                do_stats, vs_norm, torch.zeros_like(vs_norm)),
            xyz_gradient_accum_max=torch.where(
                do_stats & (vs_norm > state.xyz_gradient_accum_max),
                vs_norm, state.xyz_gradient_accum_max),
            denom=state.denom + do_stats.to(torch.float32),
        )
        if stage >= 2 and cfg.train.densify_from_teaching and \
                delta_xyz is not None:
            win = row[col["teach_window"]]
            resid = D.teacher_motion_residual(
                state.params, cfg, D.time_encode(cfg, t_resid), delta_xyz)
            state = state.replace(
                xyz_motion_accum_max=torch.where(
                    (win > 0) & (resid > state.xyz_motion_accum_max), resid,
                    state.xyz_motion_accum_max),
                motion_denom=state.motion_denom + win)
        new_params, opt_state = opt_mod.adam_step(
            state.params, grads, opt_state, cfg, opt_stage,
            row_lrs(cfg, stage, row))
        return state.replace(params=new_params), opt_state

    return loss_and_grads, finish


def _run_steps(cfg: Config, stage: int, width: int, height: int,
               spatial_scale: float, sh_degree: int, total_frame: int, bg):
    """run(state, opt_state, cams, gts, times, iteration0, generator,
    active_deg, noises, time_noises) -> (state, opt_state, the last
    step's metrics): len(cams) steps at iterations iteration0,
    iteration0 + 1, ..., one after another, their scalars uploaded as one
    table. The body of make_train_step (one step) and of
    make_train_step_multi (K)."""
    loss_and_grads, finish = _step_parts(cfg, stage, width, height,
                                         spatial_scale, sh_degree, bg)
    c_sigma = scalar_columns(cfg, stage).index("sigma")

    def run(state, opt_state, cams, gts, times, iteration0, generator,
            active_deg, noises, time_noises):
        its = [iteration0 + i for i in range(len(cams))]
        host = step_scalars(cfg, stage, spatial_scale, its)
        rows = device_scalars(host, state.device)
        for i, it in enumerate(its):
            t, noise = _jitters(cfg, stage, state, times[i], generator,
                                total_frame, noises[i], time_noises[i],
                                rows[i], host[i])
            loss, grads, vs_grads, aux = loss_and_grads(
                state, cams[i], gts[i], t, it, generator, active_deg, noise,
                rows[i, c_sigma])
            state, opt_state = finish(
                state, opt_state, grads, vs_grads, aux["radii"],
                aux["visibility"], rows[i], t, aux["delta_xyz"])
        metrics = {"loss": loss, "l1": aux["l1"], "psnr": aux["psnr"],
                   "n_dropped": aux["n_dropped"], "grads": grads}
        return state, opt_state, metrics

    return run


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
    trainable param, the JAX package's tree layout). The step is
    make_train_step_multi's body run once."""
    run = _run_steps(cfg, stage, width, height, spatial_scale, sh_degree,
                     total_frame, bg)

    def step(state: GaussianState, opt_state, cam, gt, t, iteration: int,
             generator: Optional[torch.Generator] = None, active_deg=None,
             noise=None, time_noise=None):
        return run(state, opt_state, [cam], [gt], [t], iteration, generator,
                   active_deg, [noise], [time_noise])

    return step


def make_train_step_multi(cfg: Config, stage: int, width: int, height: int,
                          spatial_scale: float, sh_degree: int,
                          total_frame: int, bg, k_steps: int):
    """k_steps iterations in one call, the twin of the JAX
    make_train_step_multi (a lax.scan of the single step):

    multi(state, opt_state, cams, gts, times, iteration0, active_deg=None,
          noises=None, time_noises=None, generator=None)
      -> (state, opt_state, metrics)

    Step i renders cams[i] against gts[i] at times[i] (sequences of K
    camera dicts, [H, W, 3] targets and 0-d times) at iteration
    iteration0 + i, with noises[i] / time_noises[i] as the single step's
    noise / time_noise (None, or a None entry: drawn from `generator` in
    the single step's order). The steps run one after another on the
    state's device through make_train_step's body, so a call equals K
    single steps bit for bit. What they read per iteration (learning
    rates, anneals, the statistics' window flags) goes to the device as
    one table (step_scalars) in one copy from pinned memory; with the
    draws made on the device beforehand, a call makes no host
    synchronisation on the card between its entry and its return (the
    first call also builds the kernel library and the per-device
    constants). metrics: the last step's (loss, l1, psnr, n_dropped,
    grads)."""
    run = _run_steps(cfg, stage, width, height, spatial_scale, sh_degree,
                     total_frame, bg)
    none = [None] * k_steps

    def multi(state: GaussianState, opt_state, cams, gts, times,
              iteration0: int, active_deg=None, noises=None,
              time_noises=None, generator: Optional[torch.Generator] = None):
        if not (len(cams) == len(gts) == len(times) == k_steps):
            raise ValueError(f"{k_steps} cameras, targets and times")
        return run(state, opt_state, cams, gts, times, iteration0, generator,
                   active_deg, none if noises is None else noises,
                   none if time_noises is None else time_noises)

    return multi


def make_train_step_batched(cfg: Config, stage: int, width: int,
                            height: int, spatial_scale: float,
                            sh_degree: int, total_frame: int, bg,
                            batch: int):
    """Gradient accumulation over `batch` renders and ONE optimizer step,
    the JAX make_train_step_batched (the reference's --batch):

    step(state, opt_state, cams, gts, times, iteration0, generator=None,
         active_deg=None, noises=None, time_noises=None)
      -> (state, opt_state, metrics)

    Member j renders cams[j] against gts[j] at times[j] (0-d tensors) and
    iteration iteration0 + j, with noises[j] / time_noises[j] as the
    single step's noise / time_noise (None, or a None entry: drawn from
    `generator`). The members run one after another, one backward graph
    alive at a time. Losses, gradients and the carrier's screen-space
    gradients are summed in member order, radii combined by max and
    visibility by any; the statistics and Adam then run once, at
    iteration iteration0 + batch - 1, the teacher residual (stages 2/3)
    from the last member's delta_xyz at its time before the noise.
    metrics: loss (the sum), l1 and psnr (the members' means), n_dropped
    (the largest), grads (the summed gradients)."""
    loss_and_grads, finish = _step_parts(cfg, stage, width, height,
                                         spatial_scale, sh_degree, bg)
    c_sigma = scalar_columns(cfg, stage).index("sigma")

    def step(state: GaussianState, opt_state, cams, gts, times,
             iteration0: int, generator: Optional[torch.Generator] = None,
             active_deg=None, noises=None, time_noises=None):
        if not (len(cams) == len(gts) == len(times) == batch):
            raise ValueError(f"a batch of {batch} cameras, targets and "
                             "times")
        noises = noises or [None] * batch
        time_noises = time_noises or [None] * batch
        its = [iteration0 + j for j in range(batch)]
        host = step_scalars(cfg, stage, spatial_scale, its)
        rows = device_scalars(host, state.device)
        grads = vs_grads = radii = vis = loss = None
        l1s, psnrs, drops = [], [], []
        for j, it in enumerate(its):
            t, noise = _jitters(cfg, stage, state, times[j], generator,
                                total_frame, noises[j], time_noises[j],
                                rows[j], host[j])
            lj, gj, vj, aux = loss_and_grads(state, cams[j], gts[j], t, it,
                                             generator, active_deg, noise,
                                             rows[j, c_sigma])
            if grads is None:
                grads, vs_grads, loss = gj, vj, lj
                radii, vis = aux["radii"], aux["visibility"]
            else:
                grads = opt_mod.tree_map(torch.add, grads, gj)
                vs_grads = vs_grads + vj
                loss = loss + lj
                radii = torch.maximum(radii, aux["radii"])
                vis = vis | aux["visibility"]
            l1s.append(aux["l1"])
            psnrs.append(aux["psnr"])
            drops.append(aux["n_dropped"])
        state, opt_state = finish(
            state, opt_state, grads, vs_grads, radii, vis, rows[-1],
            times[-1], aux["delta_xyz"])
        metrics = {"loss": loss, "l1": torch.stack(l1s).mean(),
                   "psnr": torch.stack(psnrs).mean(),
                   "n_dropped": torch.stack(drops).max(), "grads": grads}
        return state, opt_state, metrics

    return step
