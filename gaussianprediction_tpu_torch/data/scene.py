"""Scene: dataset detection, camera lists, the camera extent and the
training-camera order.

Torch twin of gaussianprediction_tpu/data/scene.py (load_scene_info, Scene,
synthetic_scene_info). load_scene_info detects the dataset by its marker
files, in the JAX package's order (sparse/ -> COLMAP,
transforms_train.json -> Blender/D-NeRF, dataset.json -> HyperNeRF). The
order of the training cameras comes from Python's random.Random(seed)
consumed exactly as the JAX package's sampler consumes it, so one seed
gives one camera sequence in both packages, whatever the prefetch depth.
Cameras loaded lazily are decoded ahead on a thread pool while the device
steps.
"""
from __future__ import annotations

import os
import random
import time
from typing import List

import numpy as np
import torch

from gaussianprediction_tpu_torch.config import Config
from gaussianprediction_tpu_torch.data.scene_types import (
    SceneInfo, nerfpp_norm,
)
from gaussianprediction_tpu_torch.utils.camera import Camera


def load_scene_info(cfg: Config, lazy: bool = False) -> SceneInfo:
    """The reference's sceneLoadTypeCallbacks dispatch on
    cfg.source_path."""
    path = cfg.source_path
    if os.path.exists(os.path.join(path, "sparse")):
        from gaussianprediction_tpu_torch.data.colmap import (
            read_colmap_scene,
        )

        return read_colmap_scene(path, eval_split=True, lazy=lazy)
    if os.path.exists(os.path.join(path, "transforms_train.json")):
        from gaussianprediction_tpu_torch.data.blender import (
            read_nerf_synthetic,
        )

        return read_nerf_synthetic(
            path, cfg.model.white_background, eval_split=True,
            max_time=cfg.model.max_time, lazy=lazy,
        )
    if os.path.exists(os.path.join(path, "dataset.json")):
        from gaussianprediction_tpu_torch.data.hypernerf import (
            read_hyper_scene,
        )

        return read_hyper_scene(
            path, max_time=cfg.model.max_time, ratio=cfg.ratio, lazy=lazy,
        )
    raise ValueError(f"Could not recognize scene type at {path}")


class Scene:
    """Cameras, the camera extent and random-without-replacement epochs of
    training cameras.

    `prefetch` > 0 decodes the images of the next `prefetch` cameras of
    the epoch on two worker threads while the device steps; the decoded
    image stays on its Camera, so only the first epoch decodes.
    next_train_camera waits for its camera's decode before it returns
    it. `decode_stats` counts the draws ("draws"), those that found their
    camera's image not decoded yet ("waited": the caller decodes it, or
    waits on the worker that does) and the milliseconds spent waiting on
    a worker ("wait_ms")."""

    def __init__(self, info: SceneInfo, seed: int = 0, prefetch: int = 4):
        self.info = info
        self.train_cameras: List[Camera] = info.train_cameras
        self.test_cameras: List[Camera] = info.test_cameras
        self.render_cameras: List[Camera] = info.render_cameras
        self.total_frame = info.total_frame
        self.cameras_extent = nerfpp_norm(info.train_cameras)["radius"]
        self._rng = random.Random(seed)
        self._order: List[int] = []
        self._prefetch = prefetch
        self._pool = None
        if prefetch > 0:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(
                max_workers=2, thread_name_prefix="scene-prefetch")
        self._inflight: dict = {}
        self.decode_stats = {"draws": 0, "waited": 0, "wait_ms": 0.0}

    def _refill_epoch(self):
        # the reference's pop-based sampler: stack.pop(randrange(len))
        # repeated; the order is the pop sequence
        stack = list(range(len(self.train_cameras)))
        order = []
        while stack:
            order.append(stack.pop(self._rng.randrange(len(stack))))
        self._order = order

    def _warm(self, idx: int):
        cam = self.train_cameras[idx]
        if cam.image is None and idx not in self._inflight:
            self._inflight[idx] = self._pool.submit(cam.load_image)

    def next_train_camera(self) -> Camera:
        if not self._order:
            self._refill_epoch()
        idx = self._order.pop(0)
        cam = self.train_cameras[idx]
        st = self.decode_stats
        st["draws"] += 1
        fut = self._inflight.pop(idx, None)
        if fut is not None:
            st["waited"] += not fut.done()
            t0 = time.perf_counter()
            fut.result()    # the decode finished (its image is on cam)
            st["wait_ms"] += (time.perf_counter() - t0) * 1e3
        elif cam.image is None:
            st["waited"] += 1
        if self._pool is not None:
            for j in self._order[: self._prefetch]:
                self._warm(j)
        return cam

    def close(self):
        """Stop the decode workers (a decode in flight runs to its end)."""
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None
            self._inflight.clear()


def synthetic_scene_info(n_points: int = 400, n_cams: int = 12,
                         n_test: int = 3, width: int = 64, height: int = 64,
                         dynamic: bool = False, seed: int = 0,
                         device=None) -> SceneInfo:
    """An in-memory scene whose ground truth is the port's render of a
    random Gaussian cloud (colors_precomp) from orbit cameras, so training
    can fit it exactly; dynamic=True moves the cloud by the analytic swirl
    (data/synthetic.py) over the cameras' times. The same cameras, numpy
    draws and test-view interleave as the JAX package's; the images are
    rendered on `device` (None means CUDA) with the instance capacity the
    cloud needs (the JAX package's fixed default drops instances of large
    clouds at large sizes; where it drops none the images agree)."""
    from gaussianprediction_tpu_torch.data.synthetic import (
        orbit_camera, random_gaussians, swirl_positions,
    )
    from gaussianprediction_tpu_torch.device import resolve_device
    from gaussianprediction_tpu_torch.ops.instance_stream import (
        probe_slot_need,
    )
    from gaussianprediction_tpu_torch.ops.rasterize import render

    dev = resolve_device(device)
    g = random_gaussians(n_points, seed=seed, scale_range=(-3.2, -2.0))
    opac = (1.0 / (1.0 + np.exp(-(g["opacity_logit"] + 1.5)))).astype(
        np.float32)
    cams = []
    total = n_cams + n_test
    for i in range(total):
        t = i / max(total - 1, 1)
        cams.append(orbit_camera(
            theta=2.4 * t + 0.3, phi=0.3 + 0.2 * np.sin(3 * t), width=width,
            height=height, time=t if dynamic else 0.0, uid=i))

    def dev_t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    scales = torch.exp(dev_t(g["log_scales"]))
    rot, op, col = dev_t(g["rotation"]), dev_t(opac[:, 0]), \
        dev_t(g["colors"])
    bg = torch.zeros(3, device=dev)
    with torch.no_grad():
        for cam in cams:
            xyz = dev_t(swirl_positions(g["xyz"], cam.time) if dynamic
                        else g["xyz"])
            cam_d = cam.to_device_dict(dev)
            # the JAX package renders at its default capacity (24 slots a
            # Gaussian), which drops instances once the cloud covers many
            # tiles (20k points at 800x800); size it from the slot need
            need = int(probe_slot_need(xyz, scales, rot, op, cam_d, width,
                                       height))
            mult = max(24, -(-need // max(n_points, 1)) + 1)
            out = render(xyz, scales, rot, op, None, cam_d, width, height,
                         bg, colors_precomp=col, capacity_multiplier=mult)
            if int(out["n_dropped"]):
                raise RuntimeError("the ground-truth render dropped "
                                   f"{int(out['n_dropped'])} instances")
            cam.image = torch.clamp(out["render"], 0.0, 1.0).cpu().numpy()
    rng = np.random.default_rng(seed + 1)
    init_pts = g["xyz"] + rng.normal(0, 0.05, g["xyz"].shape).astype(
        np.float32)
    # test views interleaved within the orbit and time range (the datasets'
    # eval protocol is interpolation: D-NeRF's test frames sit inside the
    # training trajectory)
    test_idx = set(
        int(round(x)) for x in np.linspace(1, total - 2, n_test)
    ) if n_test else set()
    train_cams = [c for i, c in enumerate(cams) if i not in test_idx]
    test_cams = [c for i, c in enumerate(cams) if i in test_idx]
    return SceneInfo(points=init_pts, colors=g["colors"],
                     train_cameras=train_cams, test_cameras=test_cams,
                     render_cameras=test_cams, total_frame=len(train_cams))
