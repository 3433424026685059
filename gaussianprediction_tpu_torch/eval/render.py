"""Render entry points: the test-set render with its timing.

Torch twin of gaussianprediction_tpu/eval/render.py:make_render_fn,
render_set and save_image. render_video, render_train_sequence and
render_kpts wait for a later slice of the port.
"""
from __future__ import annotations

import os
import time
from typing import List, Optional

import numpy as np
import torch

from gaussianprediction_tpu_torch.config import Config
from gaussianprediction_tpu_torch.models.gaussians import GaussianState
from gaussianprediction_tpu_torch.train.step import render_at_time, stage_of
from gaussianprediction_tpu_torch.utils.camera import Camera


def save_image(path: str, img: np.ndarray):
    import imageio.v2 as imageio

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    imageio.imwrite(path, (np.clip(img, 0, 1) * 255).astype(np.uint8))


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
    renders, gts, ms = [], [], []
    n_dropped = []
    for i, view in enumerate(views):
        cam = view.to_device_dict(dev)
        t = torch.tensor(view.time, dtype=torch.float32, device=dev)
        if dev.type == "cuda":
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
            pkg = fn(cam, t)
            ev1.record()
            ev1.synchronize()
            ms.append(ev0.elapsed_time(ev1))
        else:
            t0 = time.perf_counter()
            pkg = fn(cam, t)
            ms.append((time.perf_counter() - t0) * 1e3)
        img = torch.clamp(pkg["render"], 0.0, 1.0).cpu().numpy()
        n_dropped.append(int(pkg["n_dropped"]))
        renders.append(img)
        if out_dir:
            save_image(os.path.join(out_dir, "renders", f"{i:05d}.png"), img)
        if save_gt and view.image is not None or view.image_path:
            gt = view.load_image()
            gts.append(gt)
            if out_dir:
                save_image(os.path.join(out_dir, "gt", f"{i:05d}.png"), gt)
    if stats is not None:
        stats["ms"] = ms
        stats["n_dropped"] = n_dropped
    fps = len(views) / max(sum(ms) / 1e3, 1e-9)
    return renders, gts, fps
