"""GCN training and the autoregressive motion-extrapolation rollout.

Torch twin of gaussianprediction_tpu/motion/gcn_train.py: Adam (lr 0.01,
eps 1e-15) with cosine annealing to 1e-4 over the epochs, shuffled
drop-last minibatches, annealed uniform input noise (noise_init ·
max(1 - epoch/noise_step, 0), halved for rotations), loss = mean ||Δxyz||_2
+ mean ||Δq||_2 over keypoints; then a rollout that feeds each prediction
back into the input window.

The batches and the noise come from np.random.default_rng(seed), drawn in
the JAX package's order (the permutation of each epoch, then per batch the
xyz noise and the rotation noise), so that from the same start model both
packages see the same batches and the same noise. The initial model comes
from a CPU torch.Generator seeded `seed` (models/gcn.py), or is passed in
as `model`. The Adam update is written out as the JAX package writes it,
eps added to sqrt(v / bc2) (torch.optim.Adam places eps otherwise).

The GCN takes windows laid out [B, C, K, frames]; the windows are
[B, frames, K, C].
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional

import numpy as np
import torch

from gaussianprediction_tpu_torch.device import resolve_device
from gaussianprediction_tpu_torch.models.gcn import GCNxyzr
from gaussianprediction_tpu_torch.motion.dataset import Windows

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-15


@dataclasses.dataclass
class GCNConfig:
    """The GCN's training flags (the reference's gcn_training options;
    the per-scene predict scripts set num_stage 6 for D-NeRF, 16 for
    HyperNeRF)."""

    input_size: int = 10
    output_size: int = 1
    linear_size: int = 128
    num_stage: int = 4
    epochs: int = 101
    batch_size: int = 32
    lr: float = 0.01
    lr_min: float = 1e-4
    noise_init: float = 0.1
    noise_step: int = 100
    norm_rotation: bool = False
    no_mapping: bool = False
    dropout: float = 0.0


def init_gcn(cfg: GCNConfig, n_kpts: int, seed: int = 0,
             device=None) -> GCNxyzr:
    """A fresh GCNxyzr from a CPU generator seeded `seed`."""
    return GCNxyzr(cfg.input_size, cfg.linear_size, cfg.output_size,
                   cfg.num_stage, n_kpts, cfg.no_mapping,
                   generator=torch.Generator().manual_seed(seed),
                   device=resolve_device(device))


def _to_model_layout(x):
    """[B, frames, K, C] <-> [B, C, K, frames]."""
    return x.permute(0, 3, 2, 1)


def gcn_forward(model: GCNxyzr, xyz_in, rot_in, cfg: GCNConfig,
                generator: Optional[torch.Generator] = None):
    """Window [B, frames, K, C] -> prediction [B, output, K, C] in the
    model's mode (train or eval)."""
    xo, ro = model(_to_model_layout(xyz_in), _to_model_layout(rot_in),
                   cfg.dropout, generator)
    xo = _to_model_layout(xo)
    ro = _to_model_layout(ro)
    if cfg.norm_rotation:
        ro = ro / torch.clamp(torch.linalg.norm(ro, dim=-1, keepdim=True),
                              min=1e-12)
    return xo, ro


def init_adam(model: GCNxyzr) -> Dict:
    params = list(model.parameters())
    return {"m": [torch.zeros_like(p) for p in params],
            "v": [torch.zeros_like(p) for p in params], "step": 0}


def train_step(model: GCNxyzr, opt: Dict, lr: float, xi, ri, xg, rg,
               cfg: GCNConfig, generator: Optional[torch.Generator] = None):
    """One Adam step in train mode (the batch-norm running statistics
    move): returns (loss, grads) with grads in model.parameters() order;
    the model and `opt` are updated in place."""
    model.train()
    params = list(model.parameters())
    xo, ro = gcn_forward(model, xi, ri, cfg, generator)
    loss = torch.mean(torch.linalg.norm(xo - xg, dim=-1)) + torch.mean(
        torch.linalg.norm(ro - rg, dim=-1))
    grads = torch.autograd.grad(loss, params)
    opt["step"] += 1
    t = np.float32(opt["step"])
    bc1 = float(np.float32(1.0) - np.float32(ADAM_B1) ** t)
    bc2 = float(np.float32(1.0) - np.float32(ADAM_B2) ** t)
    with torch.no_grad():
        for p, g, m, v in zip(params, grads, opt["m"], opt["v"]):
            m.copy_(ADAM_B1 * m + (1 - ADAM_B1) * g)
            v.copy_(ADAM_B2 * v + (1 - ADAM_B2) * g * g)
            p.copy_(p - lr * (m / bc1) / (torch.sqrt(v / bc2) + ADAM_EPS))
    return loss.detach(), grads


def train_gcn(windows: Windows, n_kpts: int, cfg: GCNConfig, seed: int = 0,
              verbose: bool = True, device=None,
              model: Optional[GCNxyzr] = None):
    """Train on the windows; returns (model, loss_history), one mean loss
    per epoch. `model` (default: init_gcn(cfg, n_kpts, seed)) is trained
    in place on its own device."""
    if model is None:
        model = init_gcn(cfg, n_kpts, seed, device)
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(seed)   # dropout masks
    opt = init_adam(model)
    n = len(windows.xyz_inputs)
    bs = min(cfg.batch_size, max(n, 1))
    rng = np.random.default_rng(seed)
    history: List[float] = []

    def to_dev(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    for epoch in range(cfg.epochs):
        lr = cfg.lr_min + 0.5 * (cfg.lr - cfg.lr_min) * (
            1 + np.cos(np.pi * epoch / cfg.epochs))
        lr = float(np.float32(lr))
        noise_xyz = cfg.noise_init * max(1.0 - epoch / cfg.noise_step, 0.0)
        noise_r = noise_xyz * 0.5
        perm = rng.permutation(n)
        losses = []
        for b in range(n // bs):
            sel = perm[b * bs:(b + 1) * bs]
            xi = windows.xyz_inputs[sel]
            ri = windows.rot_inputs[sel]
            if noise_xyz > 0:
                xi = xi + (2 * rng.random(xi.shape) - 1) * noise_xyz
                ri_n = ri + (2 * rng.random(ri.shape) - 1) * noise_r
                if cfg.norm_rotation:
                    ri_n = ri_n / np.maximum(
                        np.linalg.norm(ri_n, axis=-1, keepdims=True), 1e-12)
                ri = ri_n
            loss, _ = train_step(model, opt, lr, to_dev(xi), to_dev(ri),
                                 to_dev(windows.xyz_gt[sel]),
                                 to_dev(windows.rot_gt[sel]), cfg, gen)
            losses.append(loss)
        if losses:
            history.append(float(np.mean(
                torch.stack(losses).cpu().numpy().astype(np.float64))))
            if verbose and epoch % max(cfg.epochs // 10, 1) == 0:
                print(f"[gcn epoch {epoch}] loss {history[-1]:.5f} "
                      f"lr {lr:.4f}")
    return model, history


def save_gcn_checkpoint(path: str, model: GCNxyzr, cfg: GCNConfig,
                        n_kpts: int, loss_history):
    """The JAX package's GCN .npz: the flat params/... and bn/... keys,
    the config and n_kpts as a JSON string under __gcn_meta__, the loss
    history as f32 under __loss_history__."""
    from gaussianprediction_tpu_torch.convert import gcn_to_arrays

    flat = gcn_to_arrays(model)
    flat["__gcn_meta__"] = np.array(json.dumps(
        {**dataclasses.asdict(cfg), "n_kpts": int(n_kpts)}))
    flat["__loss_history__"] = np.asarray(loss_history, np.float32)
    np.savez(path, **flat)


def load_gcn_checkpoint(path: str, device=None):
    """A GCN .npz of either package -> (model, cfg, n_kpts, loss_history)."""
    from gaussianprediction_tpu_torch.convert import gcn_from_arrays

    with np.load(path, allow_pickle=False) as f:
        flat = {k: f[k] for k in f.files}
    meta = json.loads(str(flat.pop("__gcn_meta__")))
    hist = [float(x) for x in flat.pop("__loss_history__")]
    n_kpts = meta.pop("n_kpts")
    cfg = GCNConfig(**meta)

    def under(prefix):
        return {k[len(prefix):]: v for k, v in flat.items()
                if k.startswith(prefix)}

    model = gcn_from_arrays(under("params/"), under("bn/"), device)
    return model, cfg, n_kpts, hist


@torch.no_grad()
def rollout(model: GCNxyzr, cfg: GCNConfig, xyz_window, rot_window,
            frames: int):
    """Autoregressive rollout in eval mode, on the model's device and in
    its dtype: xyz_window [input, K, 3] and rot_window [input, K, 4] seed
    the window, which shifts by output_size after each prediction. Returns
    numpy (kpts [frames, K, 3], kpts_rotation [frames, K, 4])."""
    model.eval()
    p = next(model.parameters())
    xi = torch.as_tensor(np.asarray(xyz_window), dtype=p.dtype,
                         device=p.device)
    ri = torch.as_tensor(np.asarray(rot_window), dtype=p.dtype,
                         device=p.device)
    k = cfg.output_size
    out_x, out_r = [], []
    for _ in range(frames):
        xo, ro = gcn_forward(model, xi[None], ri[None], cfg)
        out_x.append(xo[0, -k:])
        out_r.append(ro[0, -k:])
        xi = torch.cat([xi[k:], xo[0, -k:]], 0)
        ri = torch.cat([ri[k:], ro[0, -k:]], 0)
    if not out_x:
        K = xi.shape[1]
        return (np.zeros((0, K, 3), np.float32),
                np.zeros((0, K, 4), np.float32))
    return (torch.cat(out_x, 0)[:frames].cpu().numpy(),
            torch.cat(out_r, 0)[:frames].cpu().numpy())
