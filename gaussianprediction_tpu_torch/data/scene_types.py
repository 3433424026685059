"""Scene containers shared by the dataset loaders and the Trainer.

Torch-port copy of gaussianprediction_tpu/data/scene_types.py (numpy only;
the port imports nothing of the JAX package): SceneInfo, a loader's output
(the reference's SceneInfo), and nerfpp_norm, the camera extent that sets
the spatial learning-rate scale and the densification thresholds.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from gaussianprediction_tpu_torch.utils.camera import Camera, world_to_view


@dataclasses.dataclass
class SceneInfo:
    """Loader output: the initial point cloud and the camera splits."""

    points: np.ndarray
    colors: np.ndarray
    train_cameras: List[Camera]
    test_cameras: List[Camera]
    render_cameras: List[Camera]
    ply_path: Optional[str] = None
    total_frame: int = 1


def nerfpp_norm(cameras: List[Camera]) -> dict:
    """Camera-extent normalization (the reference's getNerfppNorm): radius
    = 1.1 * the largest distance of a camera centre from their mean."""
    centers = []
    for cam in cameras:
        W2C = world_to_view(cam.R, cam.T)
        centers.append(np.linalg.inv(W2C)[:3, 3:4])
    centers = np.hstack(centers)
    avg = centers.mean(axis=1, keepdims=True)
    dist = np.linalg.norm(centers - avg, axis=0)
    diagonal = float(dist.max())
    return {"translate": -avg.flatten(), "radius": diagonal * 1.1}
