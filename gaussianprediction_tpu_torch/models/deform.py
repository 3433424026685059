"""Deformation of the canonical Gaussians, the three training stages.

Torch twin of gaussianprediction_tpu/models/deform.py:

  warm-up  (iter <  jointly_iteration): canonical Gaussians, no deformation
  stage 1  (iter <= second_stage_iteration): per-Gaussian deformation —
           MLP([motion_feature, PE(xyz + annealed noise), PE(t)])
           -> (Δxyz, Δq[, Δo])
  stage2/3 (iter >  second_stage_iteration): the MLP runs on the keypoints
           only; each Gaussian's motion is a softmax-weighted blend of its
           K nearest keypoints' deltas, the blend logits from the weight
           model (the hash grid, the brick grid or Fourier features, then
           an MLP)

The blend keeps the JAX package's KNN-sparse form (a gather of K rows per
Gaussian) in the forward. Its backward into the keypoint rows is the
reference's dense form: the [C, Ck] matrix of blend weights (fill_nearest)
times the incoming gradient, one GEMM. Autograd's own backward of the
gather would sum 1.2M rows into at most a few hundred with atomics, in an
order that changes from run to run; the GEMM gives the same sums in a
fixed order, so a step run twice is bit-identical.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gaussianprediction_tpu_torch.config import Config
from gaussianprediction_tpu_torch.models.gaussians import (
    GaussianState,
    deform_input_dims,
    opacity_act,
    rotation_act,
    scaling_act,
)
from gaussianprediction_tpu_torch.ops.fourier_enc import (
    fourier_encode, model_dirs,
)
from gaussianprediction_tpu_torch.ops.hashgrid import (
    brickgrid_encode_fast, hashgrid_encode_fast,
)
from gaussianprediction_tpu_torch.ops.knn import hybrid_knn, knn
from gaussianprediction_tpu_torch.ops.mlp import mlp_apply
from gaussianprediction_tpu_torch.utils.math import (
    positional_encoding,
    quat_mul,
    sharp_sigmoid,
    step_opacity_fn,
)
from gaussianprediction_tpu_torch.utils.schedules import linear_anneal


class DeformOut(NamedTuple):
    xyz: torch.Tensor
    rotation: torch.Tensor     # normalized quats
    scaling: torch.Tensor      # activated
    opacity: torch.Tensor      # activated [C, 1]
    kpts_xyz_motion: Optional[torch.Tensor] = None
    kpts_rotation_motion: Optional[torch.Tensor] = None
    nn_idx: Optional[torch.Tensor] = None        # [C, K] int32
    weights_xyz: Optional[torch.Tensor] = None   # [C, K] softmaxed
    weights_r: Optional[torch.Tensor] = None
    delta_xyz: Optional[torch.Tensor] = None     # per Gaussian


def motion_delta(params, cfg: Config, xyz_embed, motion_feature, t_pe):
    """Deform-MLP evaluation: (Δxyz, Δq, Δo or None)."""
    n = motion_feature.shape[0]
    t_rep = t_pe[None, :].expand(n, t_pe.shape[-1])
    inp = torch.cat([motion_feature, xyz_embed, t_rep], dim=-1)
    delta = mlp_apply(params["df_mlp"], inp)
    delta_o = delta[..., 7:8] if cfg.model.step_opacity else None
    return delta[..., 0:3], delta[..., 3:7], delta_o


def time_encode(cfg: Config, t):
    time_dim, _ = deform_input_dims(cfg)
    return positional_encoding(torch.reshape(t, (1,)), time_dim // 2)


def xyz_encode(cfg: Config, xyz):
    _, xyz_dim = deform_input_dims(cfg)
    return positional_encoding(xyz, xyz_dim // 6)


def encode_weights(params, cfg: Config, xyz):
    """The weight encoder's features of (detached) positions, by
    cfg.model.weight_encoder: the hash grid, the brick grid, or the
    Fourier features of the fixed frequency matrix."""
    m = cfg.model
    if m.weight_encoder == "fourier":
        return fourier_encode(model_dirs(m, xyz.device).to(xyz.dtype), xyz,
                              m.hash_bound)
    enc = brickgrid_encode_fast if m.weight_encoder == "brick" \
        else hashgrid_encode_fast
    return enc(params["hash_tables"], xyz, m.hash_bound, m.hash_min_res,
               m.hash_max_res)


def blend_weights(params, cfg: Config, state: GaussianState):
    """The weight model (encoder + MLP) on the detached Gaussian
    positions, the K nearest keypoints ("3D" or the 35-d "hybird" KNN) and
    a softmax over each Gaussian's K logits.
    Returns (nn_idx [C, K] int32, weights_xyz [C, K], weights_r [C, K])."""
    K = cfg.model.nearest_num
    m = cfg.model
    xyz = params["xyz"].detach()
    enc = encode_weights(params, cfg, xyz)
    logits = mlp_apply(params["weight_mlp"], enc)                # [C, 2K]
    # the [C, Ck] distances to a few hundred keypoints fit in one block
    block = xyz.shape[0]
    with torch.no_grad():
        if m.knn_type == "3D":
            _, nn_idx = knn(xyz, params["super_xyz"], K,
                            point_valid=state.kpt_alive, block=block)
        else:  # "hybird" (the reference's spelling)
            _, nn_idx = hybrid_knn(xyz, params["motion_feature"],
                                   params["super_xyz"],
                                   params["super_feature"], K,
                                   m.feature_amplify,
                                   point_valid=state.kpt_alive, block=block)
    weights_xyz = torch.softmax(logits[..., 0:K], dim=-1)
    weights_r = torch.softmax(logits[..., K:2 * K], dim=-1)
    return nn_idx, weights_xyz, weights_r


class _KnnBlend(torch.autograd.Function):
    """out[n] = Σ_k w[n, k] · rows[nn[n, k]]: a gather forward; the
    backward into rows is dense(w)ᵀ @ g (dense(w) the [C, Ck] matrix with
    w[n, k] at (n, nn[n, k]); the K indices of a row are distinct)."""

    @staticmethod
    def forward(ctx, w, rows, nn_idx):
        ctx.save_for_backward(w, rows, nn_idx)
        return torch.einsum("nk,nkc->nc", w, rows[nn_idx.to(torch.int64)])

    @staticmethod
    def backward(ctx, g):
        w, rows, nn_idx = ctx.saved_tensors
        nn64 = nn_idx.to(torch.int64)
        gw = grows = None
        if ctx.needs_input_grad[0]:
            gw = torch.einsum("nc,nkc->nk", g, rows[nn64])
        if ctx.needs_input_grad[1]:
            dense = w.new_zeros((w.shape[0], rows.shape[0]))
            dense.scatter_(1, nn64, w)
            grows = dense.T @ g
        return gw, grows, None


def knn_blend(w, rows, nn_idx):
    """Σ_k w[n, k] · rows[nn_idx[n, k]] -> [C, D], with a deterministic
    backward (the module's docstring says why)."""
    return _KnnBlend.apply(w, rows, nn_idx)


def apply_deltas(params, delta_xyz, delta_q):
    """(xyz + Δxyz, normalised Δq ⊗ rotation, normalised)."""
    xyz = params["xyz"] + delta_xyz
    q = rotation_act(quat_mul(rotation_act(delta_q), params["rotation"]))
    return xyz, q


def _lifecycle_opacity(params, cfg: Config, t, t_pe, iteration: int):
    """Step-opacity lifecycle: re-evaluates the MLP on canonical inputs
    for Δo once step opacity is on."""
    base = opacity_act(params["opacity"])
    if (not cfg.model.step_opacity
            or iteration <= cfg.model.step_opacity_iteration):
        return base
    xyz_embed = xyz_encode(cfg, params["xyz"])
    _, _, delta_o = motion_delta(
        params, cfg, xyz_embed, params["motion_feature"], t_pe
    )
    if cfg.model.opacity_type == "explicit":
        return base * step_opacity_fn(t, params["opacity_thres"],
                                      cfg.model.beta)
    return base * sharp_sigmoid(delta_o, cfg.model.beta)


def deform_warmup(params, cfg: Config) -> DeformOut:
    """Warm-up: static 3DGS."""
    return DeformOut(
        xyz=params["xyz"],
        rotation=rotation_act(params["rotation"]),
        scaling=scaling_act(params["scaling"]),
        opacity=opacity_act(params["opacity"]),
    )


def xyz_noise_sigma(cfg: Config, iteration: int, stage: int):
    """The xyz jitter's sigma at a global iteration, a 0-d f32 tensor: 0.1
    annealed linearly to 0 at xyz_noise_iteration, counted from 0 for the
    Gaussians of stage 1 and from second_stage_iteration for the
    keypoints of stages 2/3."""
    if stage >= 2:
        iteration = iteration - cfg.train.second_stage_iteration
    return linear_anneal(iteration, 0.1, cfg.train.xyz_noise_iteration)


def _jitter(x, iteration: int, cfg: Config, stage: int, generator, noise,
            sigma):
    """x + sigma * noise. With sigma None, sigma is xyz_noise_sigma on the
    host, and `noise` (N(0,1) of x's shape, before the anneal) is drawn
    from `generator` when None and sigma != 0; past the anneal nothing is
    drawn. A given sigma (a 0-d tensor on x's device, the training steps'
    per-iteration table) applies the given noise, and None means no
    jitter."""
    if sigma is None:
        sigma = float(xyz_noise_sigma(cfg, iteration, stage))
        if sigma != 0.0 and noise is None:
            gdev = generator.device if generator is not None else x.device
            noise = torch.randn(x.shape, generator=generator,
                                device=gdev).to(x.device)
    return x if noise is None else x + sigma * noise


def deform_stage1(params, cfg: Config, state: GaussianState, t, iteration,
                  generator: Optional[torch.Generator] = None,
                  noise=None, sigma=None) -> DeformOut:
    """Stage 1: per-Gaussian deformation.

    The xyz jitter (_jitter): sigma anneals to 0 at xyz_noise_iteration,
    `noise` is N(0,1) [C, 3] before the anneal: the draws differ from
    jax.random's, so tests that compare with the JAX package pass the
    same pre-drawn noise to both."""
    t_pe = time_encode(cfg, t)
    xyz_in = _jitter(params["xyz"].detach(), iteration, cfg, 1, generator,
                     noise, sigma)
    xyz_embed = xyz_encode(cfg, xyz_in)
    delta_xyz, delta_q, _ = motion_delta(
        params, cfg, xyz_embed, params["motion_feature"], t_pe
    )
    if cfg.model.norm_rotation:
        delta_q = rotation_act(delta_q)
    xyz, q = apply_deltas(params, delta_xyz, delta_q)
    return DeformOut(
        xyz=xyz, rotation=q, scaling=scaling_act(params["scaling"]),
        opacity=_lifecycle_opacity(params, cfg, t, t_pe, iteration),
        kpts_xyz_motion=delta_xyz, kpts_rotation_motion=delta_q,
        delta_xyz=delta_xyz,
    )


def keypoint_motion(params, cfg: Config, state: GaussianState, t, iteration,
                    generator: Optional[torch.Generator] = None, noise=None,
                    sigma=None):
    """The deform MLP on the keypoints (their positions jittered by an
    annealed N(0, 1) draw, _jitter; `noise` [Ck, 3]): (Δxyz, Δq, t's
    positional encoding), Δxyz zero on dead keypoint rows."""
    t_pe = time_encode(cfg, t)
    kpt_in = _jitter(params["super_xyz"], iteration, cfg, 2, generator,
                     noise, sigma)
    xyz_embed = xyz_encode(cfg, kpt_in)
    kpt_dxyz, kpt_dq, _ = motion_delta(
        params, cfg, xyz_embed, params["super_feature"], t_pe
    )
    if cfg.model.norm_rotation:
        kpt_dq = rotation_act(kpt_dq)
    alive = state.kpt_alive[:, None]
    kpt_dxyz = torch.where(alive, kpt_dxyz, torch.zeros_like(kpt_dxyz))
    return kpt_dxyz, kpt_dq, t_pe


def deform_stage23(params, cfg: Config, state: GaussianState, t, iteration,
                   generator: Optional[torch.Generator] = None,
                   noise=None, sigma=None) -> DeformOut:
    """Stages 2/3: the keypoints' motion (keypoint_motion), blended onto
    each Gaussian by its K nearest keypoints' softmax weights. Dead
    keypoint rows blend as zero motion and the identity rotation."""
    nn_idx, w_xyz, w_r = blend_weights(params, cfg, state)
    kpt_dxyz, kpt_dq, t_pe = keypoint_motion(params, cfg, state, t,
                                             iteration, generator, noise,
                                             sigma)
    ident = torch.zeros_like(kpt_dq)
    ident[:, 0] = 1.0
    kpt_dq_safe = torch.where(state.kpt_alive[:, None], kpt_dq, ident)

    delta_xyz = knn_blend(w_xyz, kpt_dxyz, nn_idx)
    delta_q = knn_blend(w_r, kpt_dq_safe, nn_idx)
    xyz, q = apply_deltas(params, delta_xyz, delta_q)
    return DeformOut(
        xyz=xyz, rotation=q, scaling=scaling_act(params["scaling"]),
        opacity=_lifecycle_opacity(params, cfg, t, t_pe, iteration),
        kpts_xyz_motion=kpt_dxyz, kpts_rotation_motion=kpt_dq,
        nn_idx=nn_idx, weights_xyz=w_xyz, weights_r=w_r,
        delta_xyz=delta_xyz,
    )


def teacher_motion_residual(params, cfg: Config, t_pe, delta_xyz_blended):
    """||blended Δxyz - the stage-1 per-Gaussian ("teacher") Δxyz|| per
    Gaussian: the statistic of teacher-guided keypoint growth."""
    xyz_embed = xyz_encode(cfg, params["xyz"])
    teach_dxyz, _, _ = motion_delta(
        params, cfg, xyz_embed, params["motion_feature"], t_pe
    )
    return torch.linalg.norm(delta_xyz_blended - teach_dxyz, dim=-1)


def motion_feature_reg(params, stage: int):
    """1e-5 * mean|motion_feature| (the reference's get_loss); stages 2/3
    regularize the keypoint features (every row, as the JAX package)."""
    feat = params["super_feature"] if stage >= 2 else \
        params["motion_feature"]
    return 1e-5 * torch.mean(torch.abs(feat))
