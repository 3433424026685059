"""Procedural synthetic scenes for tests and benchmarks.

No datasets ship with this environment, so correctness tests and the bench
harness build scenes procedurally: random clouds of Gaussians in the
D-NeRF-style [-1.3, 1.3]^3 box (mirroring the random 50k-point init of
readNerfSyntheticInfo, reference/scene/dataset_readers.py:253-262)
viewed by orbit cameras, plus an animated variant (rigid swirl + breathing)
that exercises the dynamic pipeline with a known ground-truth motion model.
"""
from __future__ import annotations

import math

import numpy as np

from gaussianprediction_tpu_torch.utils.camera import Camera, focal2fov


def orbit_camera(theta: float, phi: float = 0.35, radius: float = 4.0,
                 width: int = 128, height: int = 128, fov_deg: float = 50.0,
                 time: float = 0.0, uid: int = 0) -> Camera:
    """Camera on a sphere looking at the origin (OpenCV convention: z fwd)."""
    cx = radius * math.cos(phi) * math.sin(theta)
    cy = radius * math.sin(phi)
    cz = radius * math.cos(phi) * math.cos(theta)
    center = np.array([cx, cy, cz])
    forward = -center / np.linalg.norm(center)
    up = np.array([0.0, -1.0, 0.0])
    right = np.cross(up, forward)
    right /= np.linalg.norm(right)
    down = np.cross(forward, right)
    R_c2w = np.stack([right, down, forward], axis=1)  # columns
    # world->cam: R_w2c = R_c2w.T, t = -R_w2c @ center
    t = -R_c2w.T @ center
    fov = math.radians(fov_deg)
    fovy = focal2fov(
        width / (2 * math.tan(fov / 2)), height
    )
    return Camera(
        uid=uid, R=R_c2w, T=t, fovx=fov, fovy=fovy, image=None,
        image_name=f"orbit_{uid}", width=width, height=height, time=time,
    )


def random_gaussians(n: int, seed: int = 0, box: float = 1.3,
                     scale_range=(-5.5, -3.5)):
    """Random raw Gaussian parameters (pre-activation, reference layout)."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-box, box, (n, 3)).astype(np.float32)
    log_scales = rng.uniform(*scale_range, (n, 1)).astype(np.float32)
    log_scales = np.repeat(log_scales, 3, 1) + rng.uniform(
        -0.3, 0.3, (n, 3)
    ).astype(np.float32)
    rots = rng.normal(size=(n, 4)).astype(np.float32)
    opacity_logit = rng.uniform(-2.0, 3.0, (n, 1)).astype(np.float32)
    colors = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    return dict(
        xyz=xyz,
        log_scales=log_scales,
        rotation=rots,
        opacity_logit=opacity_logit,
        colors=colors,
    )


def swirl_positions(xyz: np.ndarray, t: float, amp: float = 0.35):
    """Analytic motion: rotation about y by amp*sin(2πt) plus breathing.

    Used as ground truth for dynamic-pipeline tests: the deformation field
    must learn it, and the GCN must extrapolate it.
    """
    ang = amp * math.sin(2 * math.pi * t)
    ca, sa = math.cos(ang), math.sin(ang)
    x = ca * xyz[:, 0] + sa * xyz[:, 2]
    z = -sa * xyz[:, 0] + ca * xyz[:, 2]
    breathe = 1.0 + 0.08 * math.sin(2 * math.pi * t + 1.0)
    return np.stack([x, xyz[:, 1] * breathe, z], axis=1).astype(np.float32)
