"""Render entry points: test sets, interpolated videos, GCN-predicted
frames.

Torch twin of gaussianprediction_tpu/eval/render.py: render_set (per-view
renders and their timing), render_video (slerp pose and time interpolation
between consecutive views), render_train_sequence (one frozen view over the
training times), render_kpts (renders driven by externally predicted
keypoint positions and rotations: xyz + Σ_k w_xyz · (kpts - super_xyz),
the rotation through Σ_k w_r · kpts_rotation on the canonical rotations),
save_image and save_video. Every render goes through ops/rasterize.py:render
and so through the hand-written kernels on the card.

Each of them takes `stats`, a dict that receives per-frame "ms" (CUDA
events on the card, a host clock on the CPU; the copy to the host
excluded) and "n_dropped".
"""
from __future__ import annotations

import os
import time
from typing import List, Optional

import numpy as np
import torch

from gaussianprediction_tpu_torch.config import Config
from gaussianprediction_tpu_torch.models import deform as D
from gaussianprediction_tpu_torch.models.gaussians import (
    GaussianState, get_shs, opacity_act, scaling_act,
)
from gaussianprediction_tpu_torch.ops import rasterize
from gaussianprediction_tpu_torch.train.step import render_at_time, stage_of
from gaussianprediction_tpu_torch.utils.camera import (
    Camera, interpolate_cameras,
)


def save_image(path: str, img: np.ndarray):
    """[H, W, C] in [0, 1] -> an 8-bit PNG (data/image_io.py:write_png)."""
    from gaussianprediction_tpu_torch.data.image_io import write_png

    write_png(path, (np.clip(img, 0, 1) * 255).astype(np.uint8))


def save_video(path: str, frames: List[np.ndarray], fps: int = 30):
    """Frames [H, W, 3] in [0, 1] -> an mp4 through imageio; where imageio
    or its ffmpeg backend is absent, per-frame PNGs {path without
    .mp4}_{i:05d}.png instead."""
    from gaussianprediction_tpu_torch.data.image_io import write_png

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arr = np.stack(
        [(np.clip(f, 0, 1) * 255).astype(np.uint8) for f in frames])
    try:
        import imageio.v2 as imageio

        imageio.mimwrite(path, arr, fps=fps)
    except Exception:  # no imageio or no ffmpeg: fall back to PNGs
        base = os.path.splitext(path)[0]
        for i, f in enumerate(arr):
            write_png(f"{base}_{i:05d}.png", f)


class _Frames:
    """Runs renders, timing each and keeping its clipped image and
    n_dropped (the image copied to the host after the timed region)."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.images, self.ms, self.n_dropped = [], [], []

    def add(self, render):
        """render() -> a pkg dict of ops/rasterize.py:render."""
        if self.dev.type == "cuda":
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
            pkg = render()
            ev1.record()
            ev1.synchronize()
            self.ms.append(ev0.elapsed_time(ev1))
        else:
            t0 = time.perf_counter()
            pkg = render()
            self.ms.append((time.perf_counter() - t0) * 1e3)
        img = torch.clamp(pkg["render"], 0.0, 1.0).cpu().numpy()
        self.n_dropped.append(int(pkg["n_dropped"]))
        self.images.append(img)
        return img

    def report(self, stats: Optional[dict]):
        if stats is not None:
            stats["ms"] = self.ms
            stats["n_dropped"] = self.n_dropped


def _view_renderer(state: GaussianState, cfg: Config, iteration: int,
                   width: int, height: int, bg, sh_degree: int):
    stage = stage_of(cfg, iteration)
    bg = torch.as_tensor(bg, dtype=torch.float32, device=state.device)
    gen = torch.Generator(device=state.device)

    @torch.no_grad()
    def fn(cam, t):
        # An iteration inside the xyz-noise anneal draws noise: from a
        # generator re-seeded to 0 for every view, so that a view renders
        # the same bits every time (the JAX package passes PRNGKey(0)).
        gen.manual_seed(0)
        pkg, _ = render_at_time(
            state.params, cfg, state, cam, t, iteration, gen, stage, width,
            height, bg, sh_degree, need_tidx=True,
        )
        return pkg

    return fn


def make_render_fn(state: GaussianState, cfg: Config, iteration: int,
                   width: int, height: int, bg, sh_degree: int):
    """One view-render closure reused across views: (cam, t) -> (rgb,
    depth, tidx)."""
    fn = _view_renderer(state, cfg, iteration, width, height, bg, sh_degree)

    def render_view(cam, t):
        pkg = fn(cam, t)
        return pkg["render"], pkg["depth"], pkg["tidx"]

    return render_view


def render_set(state: GaussianState, cfg: Config, iteration: int,
               views: List[Camera], bg, out_dir: Optional[str] = None,
               sh_degree: Optional[int] = None, save_gt: bool = True,
               stats: Optional[dict] = None):
    """Render every view on the state's device; returns (renders, gts,
    fps) with renders clipped to [0, 1] as numpy [H, W, 3].

    The time of each render is taken with CUDA events on the card (a host
    clock on the CPU) and excludes the copy to the host. `stats`, when a
    dict, receives per-view "ms" and "n_dropped" lists."""
    if not views:
        return [], [], 0.0
    W, H = views[0].width, views[0].height
    sh_degree = cfg.model.sh_degree if sh_degree is None else sh_degree
    dev = state.device
    fn = _view_renderer(state, cfg, iteration, W, H, bg, sh_degree)
    frames = _Frames(dev)
    gts = []
    for i, view in enumerate(views):
        cam = view.to_device_dict(dev)
        t = torch.tensor(view.time, dtype=torch.float32, device=dev)
        img = frames.add(lambda: fn(cam, t))
        if out_dir:
            save_image(os.path.join(out_dir, "renders", f"{i:05d}.png"), img)
        if save_gt and view.image is not None or view.image_path:
            gt = view.load_image()
            gts.append(gt)
            if out_dir:
                save_image(os.path.join(out_dir, "gt", f"{i:05d}.png"), gt)
    frames.report(stats)
    fps = len(views) / max(sum(frames.ms) / 1e3, 1e-9)
    return frames.images, gts, fps


def render_video(state: GaussianState, cfg: Config, iteration: int,
                 views: List[Camera], bg, out_path: Optional[str] = None,
                 interpolation: int = 5, fps: int = 30, step: int = 1,
                 stats: Optional[dict] = None):
    """Interpolate pose (slerp) and time between consecutive views,
    `interpolation` frames a pair. step strides over the view list first
    (the reference uses 2 for HyperNeRF-vrig captures, whose paired-rig
    views alternate cameras frame to frame)."""
    if len(views) < 2:
        return []
    W, H = views[0].width, views[0].height
    dev = state.device
    fn = _view_renderer(state, cfg, iteration, W, H, bg, cfg.model.sh_degree)
    frames = _Frames(dev)
    for idx in range(step, len(views), step):
        for cam in interpolate_cameras(views[idx - step], views[idx],
                                       interpolation):
            cam_d = cam.to_device_dict(dev)
            t = torch.tensor(cam.time, dtype=torch.float32, device=dev)
            frames.add(lambda: fn(cam_d, t))
    frames.report(stats)
    if out_path:
        save_video(out_path, frames.images, fps=fps)
    return frames.images


def render_train_sequence(state: GaussianState, cfg: Config, iteration: int,
                          train_views: List[Camera], freeze_view: Camera,
                          bg, out_dir: Optional[str] = None,
                          stats: Optional[dict] = None):
    """Freeze one viewpoint and sweep the training timestamps."""
    W, H = freeze_view.width, freeze_view.height
    dev = state.device
    fn = _view_renderer(state, cfg, iteration, W, H, bg, cfg.model.sh_degree)
    cam = freeze_view.to_device_dict(dev)
    frames = _Frames(dev)
    for i, tv in enumerate(train_views):
        t = torch.tensor(tv.time, dtype=torch.float32, device=dev)
        img = frames.add(lambda: fn(cam, t))
        if out_dir:
            save_image(os.path.join(out_dir, f"{i:05d}.png"), img)
    frames.report(stats)
    return frames.images


def render_kpts(state: GaussianState, cfg: Config, iteration: int,
                views: List[Camera], bg, kpts: np.ndarray,
                kpts_rotation: np.ndarray, out_dir: Optional[str] = None,
                view_id: Optional[int] = None,
                stats: Optional[dict] = None):
    """Drive the Gaussians from predicted keypoints: kpts [F, K, 3]
    positions and kpts_rotation [F, K, 4] rotation deltas of the K alive
    keypoints, one frame each, rendered at views[view_id] (default: the
    i-th view, the last one for the frames past it).

    The blend's neighbours and weights (models/deform.py:blend_weights)
    depend on neither the time nor the keypoint noise, so they are
    computed once. Per frame, each keypoint's offset from its canonical
    position (zero on dead rows; their rotation the identity) is blended
    onto the Gaussians through models/deform.py:knn_blend, as
    deform_stage23 blends; the opacity is the canonical one, and the
    render keeps ops/rasterize.py:render's default capacity."""
    if not views:
        return []
    W, H = views[0].width, views[0].height
    dev = state.device
    p = state.params
    n_kpts = kpts.shape[1]
    Ck = state.kpt_capacity
    bg_t = torch.as_tensor(bg, dtype=torch.float32, device=dev)
    alive_k = state.kpt_alive[:, None]
    ident = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev)

    def pad_k(arr):
        out = torch.zeros((Ck,) + arr.shape[1:], dtype=torch.float32,
                          device=dev)
        out[:n_kpts] = torch.as_tensor(np.asarray(arr, np.float32),
                                       device=dev)
        return out

    with torch.no_grad():
        nn_idx, w_xyz, w_r = D.blend_weights(p, cfg, state)
        scaling = scaling_act(p["scaling"])
        opacity = opacity_act(p["opacity"])
        shs = get_shs(p)

        def render_frame(cam, kpt_xyz, kpt_rot):
            dxyz_k = torch.where(alive_k, kpt_xyz - p["super_xyz"],
                                 torch.zeros_like(kpt_xyz))
            rot_k = torch.where(alive_k, kpt_rot, ident)
            xyz_t, q_t = D.apply_deltas(
                p, D.knn_blend(w_xyz, dxyz_k, nn_idx),
                D.knn_blend(w_r, rot_k, nn_idx))
            return rasterize.render(
                xyz_t, scaling, q_t, opacity, shs, cam, W, H, bg_t,
                sh_degree=cfg.model.sh_degree, alive=state.alive)

        frames = _Frames(dev)
        for i in range(len(kpts)):
            view = views[view_id if view_id is not None
                         else min(i, len(views) - 1)]
            cam = view.to_device_dict(dev)
            kx, kr = pad_k(kpts[i]), pad_k(kpts_rotation[i])
            img = frames.add(lambda: render_frame(cam, kx, kr))
            if out_dir:
                save_image(os.path.join(out_dir, "renders", f"{i:05d}.png"),
                           img)
    frames.report(stats)
    return frames.images
