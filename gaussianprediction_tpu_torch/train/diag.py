"""Stage-2 transition diagnostics.

Torch twin of gaussianprediction_tpu/train/diag.py. At the stage-2 start
the reference re-parameterizes each Gaussian's motion onto k-means
keypoints with a fresh weight model: the blended motion starts as a
near-uniform softmax over each Gaussian's K nearest keypoints' deltas, a
smoothed copy of the stage-1 motion. transition_diagnostics measures how
much of the PSNR drop after the transition is that smoothing, how much the
restarted keypoint-position noise, and how much anything else.

A pure function of the post-transition state: it changes nothing. The
noisy case draws its keypoint noise as the JAX package does, from
jax.random's PRNGKey(0) (reproduced with numpy, utils/jax_random.py).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from gaussianprediction_tpu_torch.models import deform as D
from gaussianprediction_tpu_torch.train.step import render_at_time
from gaussianprediction_tpu_torch.utils import jax_random
from gaussianprediction_tpu_torch.utils.image import psnr as psnr_fn


def _masked_rms(x, mask):
    num = torch.sum(torch.where(mask[:, None], x, torch.zeros_like(x)) ** 2)
    den = x.shape[-1] * torch.clamp(mask.sum(), min=1)
    return torch.sqrt(num / den)


def transition_diagnostics(trainer, n_times: int = 5,
                           n_views: int = 3) -> Dict:
    """Decompose the stage-2 transition error on the trainer's current
    state (past the keypoint init). Returns a JSON-ready dict:

      teacher_rms      RMS of the stage-1 motion field
      err_blend        RMS(blended delta - teacher), keypoint noise off:
                       the re-parameterization's own error
      err_blend_noise  the same with the restarted keypoint noise at its
                       first sigma (what training sees at s2 + 1)
      err_uniform_nn   RMS(uniform K-NN mean of keypoint deltas - teacher):
                       where any fresh softmax starts
      weight_entropy   mean softmax entropy (log K is uniform)
      kpt_spacing      mean nearest-neighbour distance among keypoints
      n_kpts           live keypoints
      views            per test view: PSNR under the stage-1 deformation,
                       blended (noise off), blended (noisy)
      per_time         the delta statistics at each of n_times times
    """
    cfg = trainer.cfg
    state = trainer.state
    params = state.params
    s2 = cfg.train.second_stage_iteration
    it_teacher = 10 ** 8                         # stage-1 noise decayed
    it_nonoise = s2 + cfg.train.xyz_noise_iteration + 10
    it_noisy = s2 + 1
    dev = params["xyz"].device
    noise = torch.as_tensor(jax_random.normal(
        jax_random.key_data(0), tuple(params["super_xyz"].shape)),
        device=dev)
    alive = state.alive

    def delta_stats(t):
        teach = D.deform_stage1(params, cfg, state, t, it_teacher).delta_xyz
        o_nn = D.deform_stage23(params, cfg, state, t, it_nonoise)
        o_noisy = D.deform_stage23(params, cfg, state, t, it_noisy,
                                   noise=noise)
        unif = torch.mean(o_nn.kpts_xyz_motion[o_nn.nn_idx.to(torch.int64)],
                          dim=1)
        w = o_nn.weights_xyz
        entropy = -torch.sum(w * torch.log(torch.clamp(w, min=1e-12)),
                             dim=-1)
        n_alive = torch.clamp(alive.sum(), min=1)
        stats = {
            "teacher_rms": _masked_rms(teach, alive),
            "err_blend": _masked_rms(o_nn.delta_xyz - teach, alive),
            "err_blend_noise": _masked_rms(o_noisy.delta_xyz - teach, alive),
            "err_uniform_nn": _masked_rms(unif - teach, alive),
            "weight_entropy": torch.sum(torch.where(
                alive, entropy, torch.zeros_like(entropy))) / n_alive,
        }
        # in sorted order, as the JAX package's jitted dict comes back
        return {k: stats[k] for k in sorted(stats)}

    with torch.no_grad():
        per_t = []
        for t in np.linspace(0.0, 1.0, n_times):
            tt = torch.tensor(t, dtype=torch.float32, device=dev)
            per_t.append({k: float(v) for k, v in delta_stats(tt).items()})
    agg: Dict = {k: float(np.mean([e[k] for e in per_t])) for k in per_t[0]}

    # keypoint spacing (3-D): mean nearest-neighbour distance among the
    # live keypoints
    ka = state.kpt_alive.cpu().numpy()
    kk = params["super_xyz"].detach().cpu().numpy()[ka]
    if len(kk) >= 2:
        d2 = np.sum((kk[:, None] - kk[None]) ** 2, -1)
        np.fill_diagonal(d2, np.inf)
        agg["kpt_spacing"] = float(np.mean(np.sqrt(d2.min(1))))
    agg["n_kpts"] = int(ka.sum())

    # per view: stage 1 vs blended (no noise) vs blended (noisy)
    sh = cfg.model.sh_degree
    bg = torch.as_tensor(trainer.bg, device=dev)

    def render(cam_d, t, stage, it, nz=None):
        pkg, _ = render_at_time(params, cfg, state, cam_d, t, it, None,
                                stage, trainer.width, trainer.height, bg, sh,
                                noise=nz)
        return torch.clamp(pkg["render"], 0.0, 1.0)

    views = []
    with torch.no_grad():
        for cam in trainer.scene.test_cameras[:n_views]:
            cam_d, t, gt = trainer._view(cam)
            views.append({
                "time": float(cam.time),
                "psnr_stage1": float(psnr_fn(
                    render(cam_d, t, 1, it_teacher), gt)),
                "psnr_blend": float(psnr_fn(
                    render(cam_d, t, 2, it_nonoise), gt)),
                "psnr_blend_noise": float(psnr_fn(
                    render(cam_d, t, 2, it_noisy, noise), gt)),
            })
    agg["views"] = views
    agg["per_time"] = per_t
    return agg
