"""Blender / D-NeRF synthetic dataset loader.

Torch-port copy of gaussianprediction_tpu/data/blender.py (numpy only), the
twin of the reference's readNerfSyntheticInfo / readCamerasFromTransforms:
transforms_{train,test,render}.json, the OpenGL -> COLMAP axis flip, the
alpha composite onto the background, the `max_time` train/test split along
time (the prediction protocol) and the random 50k-point init when no
points3d.ply exists, drawn in the JAX package's order.

One difference from the JAX package: a camera loaded lazily carries the
background (Camera.background) and decodes to the composited image that
the eager load gives; the JAX lazy camera drops the alpha.
"""
from __future__ import annotations

import json
import os
from typing import List, Optional, Tuple

import numpy as np

from gaussianprediction_tpu_torch.data import image_io
from gaussianprediction_tpu_torch.data.scene_types import SceneInfo
from gaussianprediction_tpu_torch.utils.camera import (
    Camera, focal2fov, fov2focal, world_to_view,
)
from gaussianprediction_tpu_torch.utils.ply import (
    fetch_point_cloud, store_point_cloud,
)
from gaussianprediction_tpu_torch.utils.sh import C0


def read_cameras_from_transforms(
    path: str, transformsfile: str, white_background: bool,
    extension: str = ".png", max_time: float = 1.0, lazy: bool = False,
) -> Tuple[List[Camera], List[Camera]]:
    """Returns (cams with time < max_time, cams with time >= max_time)."""
    background = 1.0 if white_background else 0.0
    cams, cams_late = [], []
    with open(os.path.join(path, transformsfile)) as f:
        contents = json.load(f)
    fovx = contents["camera_angle_x"]
    for idx, frame in enumerate(contents["frames"]):
        img_path = os.path.join(path, frame["file_path"] + extension)
        time = float(frame.get("time", 0.0))
        c2w = np.array(frame["transform_matrix"], dtype=np.float64)
        c2w[:3, 1:3] *= -1  # OpenGL -> COLMAP axes
        w2c = np.linalg.inv(c2w)
        R = np.transpose(w2c[:3, :3])
        T = w2c[:3, 3]
        image = None if lazy else image_io.load_image_composited(
            img_path, background)
        if image is not None:
            h, w = image.shape[:2]
        else:
            w, h = image_io.image_size(img_path)
        fovy = focal2fov(fov2focal(fovx, w), h)
        cam = Camera(
            uid=idx, R=R, T=T, fovx=fovx, fovy=fovy, image=image,
            image_name=os.path.splitext(os.path.basename(img_path))[0],
            width=w, height=h, time=time, image_path=img_path,
            background=background,
        )
        (cams if time < max_time else cams_late).append(cam)
    return cams, cams_late


def read_nerf_synthetic(
    path: str, white_background: bool, eval_split: bool,
    extension: str = ".png", max_time: float = 1.0, lazy: bool = False,
    rng: Optional[np.random.Generator] = None,
) -> SceneInfo:
    """readNerfSyntheticInfo twin."""
    train_cams, test_cams = read_cameras_from_transforms(
        path, "transforms_train.json", white_background, extension,
        max_time=max_time, lazy=lazy,
    )
    if max_time == 1.0 and os.path.exists(
        os.path.join(path, "transforms_test.json")
    ):
        test_cams, _ = read_cameras_from_transforms(
            path, "transforms_test.json", white_background, extension,
            lazy=lazy,
        )
    render_path = os.path.join(path, "transforms_render.json")
    if os.path.exists(render_path):
        render_cams, _ = read_cameras_from_transforms(
            path, "transforms_render.json", white_background, extension,
            lazy=lazy,
        )
    else:
        render_cams = test_cams
    if not eval_split:
        train_cams = train_cams + test_cams
        test_cams = []

    ply_path = os.path.join(path, "points3d.ply")
    if not os.path.exists(ply_path):
        # random init inside the synthetic scene bounds
        num_pts = 50_000
        rng = rng or np.random.default_rng(0)
        xyz = rng.random((num_pts, 3)) * 2.6 - 1.3
        shs = rng.random((num_pts, 3)) / 255.0
        rgb = shs * C0 + 0.5
        store_point_cloud(ply_path, xyz.astype(np.float32), rgb * 255)
    points, colors, _ = fetch_point_cloud(ply_path)
    return SceneInfo(
        points=points, colors=colors,
        train_cameras=train_cams, test_cameras=test_cams,
        render_cameras=render_cams, ply_path=ply_path,
        total_frame=max(len(train_cams), 1),
    )


def write_nerf_synthetic(path: str, cameras: List[Camera],
                         points: np.ndarray, colors: np.ndarray) -> None:
    """Write cameras that hold their images as a D-NeRF tree that
    read_nerf_synthetic reads back: transforms_train.json (every camera,
    in the order given, with its time; camera_angle_x of the first),
    train/r_<i>.png as 8-bit RGBA (the image's bytes, alpha 0 where the
    image is exactly black, else 255) through image_io.write_png, and
    points3d.ply from the points and their colours in [0, 1]."""
    os.makedirs(os.path.join(path, "train"), exist_ok=True)
    frames = []
    for i, cam in enumerate(cameras):
        img = np.asarray(cam.image, np.float32)
        rgba = np.empty(img.shape[:2] + (4,), np.uint8)
        rgba[..., :3] = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
        rgba[..., 3] = np.where((img == 0.0).all(-1), 0, 255)
        image_io.write_png(os.path.join(path, "train", f"r_{i}.png"), rgba)
        c2w = np.linalg.inv(world_to_view(cam.R, cam.T).astype(np.float64))
        c2w[:3, 1:3] *= -1  # COLMAP -> OpenGL axes
        frames.append({"file_path": f"train/r_{i}", "time": float(cam.time),
                       "transform_matrix": c2w.tolist()})
    with open(os.path.join(path, "transforms_train.json"), "w") as f:
        json.dump({"camera_angle_x": float(cameras[0].fovx),
                   "frames": frames}, f)
    store_point_cloud(os.path.join(path, "points3d.ply"),
                      np.asarray(points, np.float32),
                      np.clip(np.asarray(colors), 0.0, 1.0) * 255)
