"""Scene: camera lists, the camera extent and the training-camera order.

Torch twin of gaussianprediction_tpu/data/scene.py (Scene,
synthetic_scene_info). The order of the training cameras comes from
Python's random.Random(seed) consumed exactly as the JAX package's
sampler consumes it, so one seed gives one camera sequence in both
packages. The JAX Scene also decodes the next cameras' images on a thread
pool while the device steps; the port's scenes hold their images in
memory (synthetic_scene_info), so it has no such prefetch. Loading a
dataset from disk (load_scene_info) waits for the loaders (ROADMAP.md,
Queue 1).
"""
from __future__ import annotations

import random
from typing import List

import numpy as np
import torch

from gaussianprediction_tpu_torch.config import Config
from gaussianprediction_tpu_torch.data.scene_types import (
    SceneInfo, nerfpp_norm,
)
from gaussianprediction_tpu_torch.utils.camera import Camera


def load_scene_info(cfg: Config) -> SceneInfo:
    raise NotImplementedError(
        "the dataset loaders (COLMAP, Blender/D-NeRF, HyperNeRF) are not "
        "ported yet (ROADMAP.md, Queue 1 item 7); use synthetic_scene_info")


class Scene:
    """Cameras, the camera extent and random-without-replacement epochs of
    training cameras."""

    def __init__(self, info: SceneInfo, seed: int = 0):
        self.info = info
        self.train_cameras: List[Camera] = info.train_cameras
        self.test_cameras: List[Camera] = info.test_cameras
        self.render_cameras: List[Camera] = info.render_cameras
        self.total_frame = info.total_frame
        self.cameras_extent = nerfpp_norm(info.train_cameras)["radius"]
        self._rng = random.Random(seed)
        self._order: List[int] = []

    def _refill_epoch(self):
        # the reference's pop-based sampler: stack.pop(randrange(len))
        # repeated; the order is the pop sequence
        stack = list(range(len(self.train_cameras)))
        order = []
        while stack:
            order.append(stack.pop(self._rng.randrange(len(stack))))
        self._order = order

    def next_train_camera(self) -> Camera:
        if not self._order:
            self._refill_epoch()
        return self.train_cameras[self._order.pop(0)]


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
