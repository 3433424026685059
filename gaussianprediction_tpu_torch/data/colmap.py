"""COLMAP model parsers (binary and text) and the scene loader.

Torch-port copy of gaussianprediction_tpu/data/colmap.py (numpy only), the
twin of the reference's scene/colmap_loader.py (struct-based binary readers
for cameras, images and points3D, qvec handling) and readColmapSceneInfo:
PINHOLE/SIMPLE_PINHOLE intrinsics -> fovx/fovy, every-8th-view eval split
(llffhold), points3D fetched (converted to PLY once, like the reference).
"""
from __future__ import annotations

import os
import struct
from typing import Dict, NamedTuple

import numpy as np

from gaussianprediction_tpu_torch.data.scene_types import SceneInfo
from gaussianprediction_tpu_torch.utils.camera import Camera, focal2fov


class ColmapCamera(NamedTuple):
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


class ColmapImage(NamedTuple):
    id: int
    qvec: np.ndarray
    tvec: np.ndarray
    camera_id: int
    name: str


CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3), 1: ("PINHOLE", 4), 2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5), 4: ("OPENCV", 8), 5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12), 7: ("FOV", 5), 8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5), 10: ("THIN_PRISM_FISHEYE", 12),
}


def qvec2rotmat(qvec):
    """colmap_loader.py:43-55 twin (wxyz)."""
    w, x, y, z = qvec
    return np.array([
        [1 - 2 * y**2 - 2 * z**2, 2 * x * y - 2 * w * z,
         2 * x * z + 2 * w * y],
        [2 * x * y + 2 * w * z, 1 - 2 * x**2 - 2 * z**2,
         2 * y * z - 2 * w * x],
        [2 * x * z - 2 * w * y, 2 * y * z + 2 * w * x,
         1 - 2 * x**2 - 2 * y**2],
    ])


def _read(f, n, fmt):
    return struct.unpack("<" + fmt, f.read(n))


def read_cameras_binary(path: str) -> Dict[int, ColmapCamera]:
    cams = {}
    with open(path, "rb") as f:
        (num,) = _read(f, 8, "Q")
        for _ in range(num):
            cid, model_id, w, h = _read(f, 24, "iiQQ")
            name, n_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, 8 * n_params, "d" * n_params))
            cams[cid] = ColmapCamera(cid, name, int(w), int(h), params)
    return cams


def read_images_binary(path: str) -> Dict[int, ColmapImage]:
    imgs = {}
    with open(path, "rb") as f:
        (num,) = _read(f, 8, "Q")
        for _ in range(num):
            iid = _read(f, 4, "i")[0]
            qvec = np.array(_read(f, 32, "dddd"))
            tvec = np.array(_read(f, 24, "ddd"))
            cam_id = _read(f, 4, "i")[0]
            name = b""
            c = f.read(1)
            while c != b"\x00":
                name += c
                c = f.read(1)
            (n_pts,) = _read(f, 8, "Q")
            f.read(24 * n_pts)  # skip 2D points
            imgs[iid] = ColmapImage(iid, qvec, tvec, cam_id, name.decode())
    return imgs


def read_points3d_binary(path: str):
    with open(path, "rb") as f:
        (num,) = _read(f, 8, "Q")
        xyz = np.zeros((num, 3))
        rgb = np.zeros((num, 3))
        err = np.zeros((num, 1))
        for i in range(num):
            data = _read(f, 43, "QdddBBBd")
            xyz[i] = data[1:4]
            rgb[i] = data[4:7]
            err[i] = data[7]
            (track_len,) = _read(f, 8, "Q")
            f.read(8 * track_len)
    return xyz, rgb, err


def read_cameras_text(path: str) -> Dict[int, ColmapCamera]:
    cams = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            cams[int(parts[0])] = ColmapCamera(
                int(parts[0]), parts[1], int(parts[2]), int(parts[3]),
                np.array([float(p) for p in parts[4:]]),
            )
    return cams


def read_images_text(path: str) -> Dict[int, ColmapImage]:
    # format: one image line, then one 2D-points line (possibly EMPTY —
    # keep blank lines so the pairing stays intact)
    imgs = {}
    with open(path) as f:
        lines = [l.strip() for l in f if not l.startswith("#")]
    i = 0
    while i < len(lines):
        if not lines[i]:
            i += 1
            continue
        parts = lines[i].split()
        imgs[int(parts[0])] = ColmapImage(
            int(parts[0]), np.array([float(p) for p in parts[1:5]]),
            np.array([float(p) for p in parts[5:8]]), int(parts[8]),
            parts[9],
        )
        i += 2  # skip the 2D-points line
    return imgs


def read_points3d_text(path: str):
    xyz, rgb, err = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            p = line.split()
            xyz.append([float(x) for x in p[1:4]])
            rgb.append([float(x) for x in p[4:7]])
            err.append([float(p[7])])
    return np.array(xyz), np.array(rgb), np.array(err)


def read_colmap_scene(path: str, images_dir: str = "images",
                      eval_split: bool = True, llffhold: int = 8,
                      lazy: bool = True) -> SceneInfo:
    """readColmapSceneInfo twin (dataset_readers.py:137-183)."""
    sparse = os.path.join(path, "sparse", "0")
    try:
        extr = read_images_binary(os.path.join(sparse, "images.bin"))
        intr = read_cameras_binary(os.path.join(sparse, "cameras.bin"))
    except FileNotFoundError:
        extr = read_images_text(os.path.join(sparse, "images.txt"))
        intr = read_cameras_text(os.path.join(sparse, "cameras.txt"))

    cams = []
    for key in extr:
        e = extr[key]
        c = intr[e.camera_id]
        if c.model == "SIMPLE_PINHOLE":
            fovy = focal2fov(c.params[0], c.height)
            fovx = focal2fov(c.params[0], c.width)
        elif c.model == "PINHOLE":
            fovy = focal2fov(c.params[1], c.height)
            fovx = focal2fov(c.params[0], c.width)
        else:
            raise ValueError(
                f"unsupported COLMAP camera model {c.model} (undistort first)"
            )
        img_path = os.path.join(path, images_dir, os.path.basename(e.name))
        image = None
        if not lazy:
            from gaussianprediction_tpu_torch.data.image_io import load_image

            image = load_image(img_path)
        cams.append(Camera(
            uid=c.id, R=np.transpose(qvec2rotmat(e.qvec)), T=np.array(e.tvec),
            fovx=fovx, fovy=fovy, image=image,
            image_name=os.path.splitext(os.path.basename(e.name))[0],
            width=c.width, height=c.height, image_path=img_path,
        ))
    cams.sort(key=lambda cam: cam.image_name)
    if eval_split:
        train = [c for i, c in enumerate(cams) if i % llffhold != 0]
        test = [c for i, c in enumerate(cams) if i % llffhold == 0]
    else:
        train, test = cams, []

    ply_path = os.path.join(sparse, "points3D.ply")
    if not os.path.exists(ply_path):
        try:
            xyz, rgb, _ = read_points3d_binary(
                os.path.join(sparse, "points3D.bin")
            )
        except FileNotFoundError:
            xyz, rgb, _ = read_points3d_text(
                os.path.join(sparse, "points3D.txt")
            )
        from gaussianprediction_tpu_torch.utils.ply import store_point_cloud

        store_point_cloud(ply_path, xyz.astype(np.float32), rgb)
    from gaussianprediction_tpu_torch.utils.ply import fetch_point_cloud

    points, colors, _ = fetch_point_cloud(ply_path)
    return SceneInfo(
        points=points, colors=colors, train_cameras=train,
        test_cameras=test, render_cameras=test, ply_path=ply_path,
    )
