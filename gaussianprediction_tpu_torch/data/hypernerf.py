"""HyperNeRF real-scene dataset loader.

Torch-port copy of gaussianprediction_tpu/data/hypernerf.py (numpy only),
the twin of the reference's scene/hyper_loader.py:35-206 and
readHyperDataInfos (dataset_readers.py:284-308):
- scene/metadata/dataset JSONs; per-image camera JSONs (Nerfies camera
  model: orientation row-matrix, position, focal_length — fov is computed
  from the ORIGINAL focal/size, images are read from the rgb/{1/ratio}x/
  pyramid so fov stays consistent at any ratio);
- every-4th-frame train split with the (idx-2)%4 test offset, or the
  explicit train/val id lists when present;
- time normalization by the max warp_id, with the max_time (<1.0)
  prediction split;
- the initial point cloud comes from points3D_downsample.ply produced by
  the COLMAP prep pipeline (tools/prepare_hypernerf.py).

write_hypernerf writes cameras that hold their images as such a tree
(no CLI calls it; it lets a synthetic scene take the HyperNeRF path).
"""
from __future__ import annotations

import json
import os
from typing import List, Tuple

import numpy as np

from gaussianprediction_tpu_torch.data.scene_types import SceneInfo
from gaussianprediction_tpu_torch.utils.camera import Camera, focal2fov


def _load_camera_json(path: str):
    """Parse one camera/*.json through the full Nerfies model
    (data/nerfies_camera.py — distortion-aware twin of the reference's
    scene/utils.py Camera). The training path consumes the pinhole subset
    (orientation/position/focal); captures with meaningful distortion are
    surfaced once so the approximation is visible, matching the reference
    renderer which is also pinhole past this point."""
    from gaussianprediction_tpu_torch.data.nerfies_camera import (
        NerfiesCamera,
    )

    cam = NerfiesCamera.from_json(path)
    if cam.has_distortion and not _load_camera_json._warned:
        _load_camera_json._warned = True
        k = np.abs(cam.radial_distortion).max()
        p = np.abs(cam.tangential_distortion).max()
        print(
            f"note: {os.path.basename(path)} carries lens distortion "
            f"(|k|max={k:.2e}, |p|max={p:.2e}); rasterization is pinhole "
            "(same as the reference renderer) — use "
            "data.nerfies_camera.NerfiesCamera for exact ray/projection "
            "math in data tooling"
        )
    return (
        cam.orientation.astype(np.float64),
        cam.position.astype(np.float64),
        float(cam.focal_length),
        (cam.image_size.tolist()
         if cam.image_size_x and cam.image_size_y else None),
    )


_load_camera_json._warned = False


def hyper_splits(datadir: str, max_time: float) -> Tuple[list, list, list]:
    """Train/test index + normalized-time computation
    (hyper_loader.py:61-106). Returns (i_train, i_test, all_time)."""
    with open(os.path.join(datadir, "metadata.json")) as f:
        meta = json.load(f)
    with open(os.path.join(datadir, "dataset.json")) as f:
        dataset = json.load(f)
    all_img = dataset["ids"]
    val_id = dataset.get("val_ids", [])
    raw_times = [meta[i]["warp_id"] for i in all_img]
    tmax = max(raw_times)
    all_time = [t / tmax for t in raw_times]

    i_train, i_test = [], []
    if max_time < 1.0:
        for idx, i in enumerate(all_img):
            t = all_time[idx]
            if len(val_id) == 0:
                if idx % 4 == 0 and t < max_time:
                    i_train.append(idx)
                if (idx - 2) % 4 == 0 and t >= max_time:
                    i_test.append(idx)
            else:
                train_id = dataset["train_ids"]
                if i in val_id and t >= max_time:
                    i_test.append(idx)
                if i in train_id and t < max_time:
                    i_train.append(idx)
    else:
        if len(val_id) == 0:
            i_train = [i for i in range(len(all_img)) if i % 4 == 0]
            i_test = [i + 2 for i in i_train][:-1]
        else:
            train_id = dataset["train_ids"]
            i_train = [i for i, x in enumerate(all_img) if x in train_id]
            i_test = [i for i, x in enumerate(all_img) if x in val_id]
    return i_train, i_test, all_time


def read_hyper_scene(datadir: str, max_time: float = 1.0,
                     ratio: float = 0.5, lazy: bool = True) -> SceneInfo:
    with open(os.path.join(datadir, "dataset.json")) as f:
        dataset = json.load(f)
    all_img = dataset["ids"]
    i_train, i_test, all_time = hyper_splits(datadir, max_time)

    scale_dir = f"{int(1 / ratio)}x"

    def build_camera(idx: int, uid: int) -> Camera:
        name = all_img[idx]
        orientation, position, focal, image_size = _load_camera_json(
            os.path.join(datadir, "camera", f"{name}.json")
        )
        # hyper_loader.py:152-153: R = orientation.T, T = -position @ R
        R = orientation.T
        T = -position @ R
        # fov from ORIGINAL focal + original size (scale-invariant)
        if image_size is not None:
            h0, w0 = image_size[1], image_size[0]
        else:
            h0 = w0 = None
        img_path = os.path.join(datadir, "rgb", scale_dir, f"{name}.png")
        from gaussianprediction_tpu_torch.data.image_io import (
            image_size as imsz,
        )

        w, h = imsz(img_path)
        fovx = focal2fov(focal, w0 if w0 else w / ratio)
        fovy = focal2fov(focal, h0 if h0 else h / ratio)
        image = None
        if not lazy:
            from gaussianprediction_tpu_torch.data.image_io import load_image

            image = load_image(img_path)
        return Camera(
            uid=uid, R=R, T=T, fovx=fovx, fovy=fovy, image=image,
            image_name=name, width=w, height=h, time=float(all_time[idx]),
            image_path=img_path,
        )

    train = [build_camera(i, u) for u, i in enumerate(i_train)]
    test = [build_camera(i, u) for u, i in enumerate(i_test)]

    ply_path = os.path.join(datadir, "points3D_downsample.ply")
    from gaussianprediction_tpu_torch.utils.ply import fetch_point_cloud

    points, colors, _ = fetch_point_cloud(ply_path)
    return SceneInfo(
        points=points, colors=colors, train_cameras=train,
        test_cameras=test, render_cameras=test, ply_path=ply_path,
        total_frame=len(all_img),
    )


def write_hypernerf(path: str, cameras: List[Camera], points: np.ndarray,
                    colors: np.ndarray, ratio: float = 0.5) -> None:
    """Write cameras that hold their images, in time order, as a HyperNeRF
    tree that read_hyper_scene reads back at `ratio`: frame i is named
    f"{i:06d}", its warp_id i (so its time is i / (n - 1) when the times
    are evenly spaced); dataset.json (no val_ids: the every-4th-frame
    split), metadata.json, scene.json, camera/<name>.json (the pinhole
    Nerfies model at the full resolution, the image size / ratio),
    rgb/<1/ratio>x/<name>.png (8-bit RGB) and points3D_downsample.ply
    from the points and their colours in [0, 1]."""
    from gaussianprediction_tpu_torch.data import image_io
    from gaussianprediction_tpu_torch.utils.camera import fov2focal
    from gaussianprediction_tpu_torch.utils.ply import store_point_cloud

    names = [f"{i:06d}" for i in range(len(cameras))]
    scale_dir = os.path.join(path, "rgb", f"{int(1 / ratio)}x")
    os.makedirs(scale_dir, exist_ok=True)
    os.makedirs(os.path.join(path, "camera"), exist_ok=True)
    for name, cam in zip(names, cameras):
        img = np.asarray(cam.image, np.float32)
        image_io.write_png(os.path.join(scale_dir, f"{name}.png"),
                           (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8))
        w0, h0 = cam.width / ratio, cam.height / ratio
        R = np.asarray(cam.R, np.float64)
        with open(os.path.join(path, "camera", f"{name}.json"), "w") as f:
            json.dump({
                "orientation": R.T.tolist(),
                "position": (-np.asarray(cam.T, np.float64) @ R.T).tolist(),
                "focal_length": fov2focal(cam.fovx, w0),
                "principal_point": [w0 / 2.0, h0 / 2.0],
                "skew": 0.0, "pixel_aspect_ratio": 1.0,
                "radial_distortion": [0.0, 0.0, 0.0],
                "tangential_distortion": [0.0, 0.0],
                "image_size": [int(round(w0)), int(round(h0))],
            }, f)
    with open(os.path.join(path, "dataset.json"), "w") as f:
        json.dump({"count": len(names), "num_exemplars": len(names),
                   "ids": names}, f)
    with open(os.path.join(path, "metadata.json"), "w") as f:
        json.dump({n: {"warp_id": i, "appearance_id": i, "camera_id": 0}
                   for i, n in enumerate(names)}, f)
    with open(os.path.join(path, "scene.json"), "w") as f:
        json.dump({"scale": 1.0, "center": [0.0, 0.0, 0.0], "near": 0.1,
                   "far": 10.0}, f)
    store_point_cloud(os.path.join(path, "points3D_downsample.ply"),
                      np.asarray(points, np.float32),
                      np.clip(np.asarray(colors), 0.0, 1.0) * 255)
