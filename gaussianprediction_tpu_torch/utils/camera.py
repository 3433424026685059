"""Camera model and projective geometry.

Behavioral reference:
  reference/utils/graphics_utils.py:31-77 (getWorld2View2,
  getProjectionMatrix, fov/focal conversions)
  reference/scene/cameras.py:17-72 (Camera: precomputed transforms)
  reference/utils/camera_utils.py:26-70,184-275 (slerp / pose interp)

Matrix convention: we keep the reference's row-vector convention — the stored
`world_view` and `full_proj` are the TRANSPOSES of the math matrices, so a
point transforms as `p_row @ M` (equivalently `Mᵀ @ p_col`). This keeps every
matrix bit-compatible with the reference checkpoints/debug dumps; ops/ code
documents which side it multiplies on.

Cameras are host-side numpy objects; `to_device_dict` produces the small
dict of tensors consumed by the render and train steps. A copy of the JAX
package's utils/camera.py, apart from that method, the `background` field
and load_image.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np


def fov2focal(fov: float, pixels: float) -> float:
    return pixels / (2.0 * math.tan(fov / 2.0))


def focal2fov(focal: float, pixels: float) -> float:
    return 2.0 * math.atan(pixels / (2.0 * focal))


def world_to_view(R: np.ndarray, t: np.ndarray,
                  translate=np.zeros(3), scale: float = 1.0) -> np.ndarray:
    """World->camera 4x4 (math convention: p_cam = M @ p_world).

    Matches getWorld2View2 (reference/utils/graphics_utils.py:38-49):
    `R` is the camera-to-world rotation (stored transposed by the loaders),
    `t` the world-to-camera translation.
    """
    Rt = np.zeros((4, 4), dtype=np.float64)
    Rt[:3, :3] = R.T
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    C2W = np.linalg.inv(Rt)
    cam_center = (C2W[:3, 3] + translate) * scale
    C2W[:3, 3] = cam_center
    return np.linalg.inv(C2W).astype(np.float32)


def projection_matrix(znear: float, zfar: float, fovx: float, fovy: float) -> np.ndarray:
    """OpenGL-style perspective projection (math convention).

    Matches getProjectionMatrix (reference/utils/graphics_utils.py:51-71):
    z maps to [0, zfar/(zfar-znear)] style used by the 3DGS rasterizer; the
    w row copies +z.
    """
    tan_y = math.tan(fovy / 2.0)
    tan_x = math.tan(fovx / 2.0)
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = 1.0 / tan_x
    P[1, 1] = 1.0 / tan_y
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    P[3, 2] = 1.0
    return P


@dataclasses.dataclass
class Camera:
    """A single training/eval camera with a ground-truth image and timestamp.

    Mirrors scene/cameras.py:17-72. `image` is float32 [H, W, 3] in [0, 1]
    (channels-last, TPU-friendly; the reference keeps [3, H, W]).
    """

    uid: int
    R: np.ndarray            # (3,3) cam-to-world rotation (stored transposed)
    T: np.ndarray            # (3,) world-to-cam translation
    fovx: float
    fovy: float
    image: Optional[np.ndarray]   # (H, W, 3) float32 or None (lazy)
    image_name: str
    width: int
    height: int
    time: float = 0.0
    znear: float = 0.01
    zfar: float = 100.0
    trans: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    scale: float = 1.0
    image_path: Optional[str] = None
    # set by the Blender loader: image_path is RGBA, composited onto this
    # background value when decoded
    background: Optional[float] = None

    def __post_init__(self):
        V = world_to_view(self.R, self.T, self.trans, self.scale)
        P = projection_matrix(self.znear, self.zfar, self.fovx, self.fovy)
        # Row-vector-convention (transposed) matrices, as the reference stores.
        self.world_view = V.T.astype(np.float32)
        self.full_proj = (P @ V).T.astype(np.float32)
        self.camera_center = np.linalg.inv(V)[:3, 3].astype(np.float32)

    @property
    def tanfovx(self) -> float:
        return math.tan(self.fovx * 0.5)

    @property
    def tanfovy(self) -> float:
        return math.tan(self.fovy * 0.5)

    def to_device_dict(self, device=None) -> dict:
        """Camera data as f32 tensors on `device` (None means CUDA); the
        scalars are 0-d tensors so the projection's arithmetic stays f32,
        as under the JAX reference's jit."""
        import torch

        from gaussianprediction_tpu_torch.device import resolve_device

        dev = resolve_device(device)

        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=dev)

        return {
            "world_view": f32(self.world_view),
            "full_proj": f32(self.full_proj),
            "camera_center": f32(self.camera_center),
            "tanfovx": f32(self.tanfovx),
            "tanfovy": f32(self.tanfovy),
            "time": f32(self.time),
        }

    def load_image(self) -> np.ndarray:
        """Return the gt image, decoding it from image_path on first use
        (data/image_io.py: float32 [H, W, 3] in [0, 1]). Where `background`
        is set, the decode composites the RGBA file onto it, so that a
        lazily loaded Blender camera holds the image the eager load gives.
        The JAX package's lazy camera keeps RGB and drops the alpha there
        (its eager load composites): a difference of the reference that
        the port does not copy."""
        if self.image is None:
            from gaussianprediction_tpu_torch.data import image_io

            self.image = (
                image_io.load_image(self.image_path)
                if self.background is None else
                image_io.load_image_composited(self.image_path,
                                               self.background))
        return self.image


def slerp(q0: np.ndarray, q1: np.ndarray, t: float) -> np.ndarray:
    """Quaternion slerp (numpy, wxyz). Matches camera_utils.py:26-70 behavior
    including the sign flip for shortest path."""
    q0 = q0 / np.linalg.norm(q0)
    q1 = q1 / np.linalg.norm(q1)
    dot = float(np.dot(q0, q1))
    if dot < 0.0:
        q1, dot = -q1, -dot
    if dot > 0.9995:
        out = q0 + t * (q1 - q0)
        return out / np.linalg.norm(out)
    theta = math.acos(np.clip(dot, -1.0, 1.0))
    s0 = math.sin((1 - t) * theta) / math.sin(theta)
    s1 = math.sin(t * theta) / math.sin(theta)
    return s0 * q0 + s1 * q1


def rotmat_to_quat(R: np.ndarray) -> np.ndarray:
    """(3,3) -> wxyz quaternion (numpy, eigen-free Shepperd method)."""
    m00, m01, m02 = R[0]
    m10, m11, m12 = R[1]
    m20, m21, m22 = R[2]
    tr = m00 + m11 + m22
    if tr > 0:
        s = math.sqrt(tr + 1.0) * 2
        w, x, y, z = 0.25 * s, (m21 - m12) / s, (m02 - m20) / s, (m10 - m01) / s
    elif m00 > m11 and m00 > m22:
        s = math.sqrt(1.0 + m00 - m11 - m22) * 2
        w, x, y, z = (m21 - m12) / s, 0.25 * s, (m01 + m10) / s, (m02 + m20) / s
    elif m11 > m22:
        s = math.sqrt(1.0 + m11 - m00 - m22) * 2
        w, x, y, z = (m02 - m20) / s, (m01 + m10) / s, 0.25 * s, (m12 + m21) / s
    else:
        s = math.sqrt(1.0 + m22 - m00 - m11) * 2
        w, x, y, z = (m10 - m01) / s, (m02 + m20) / s, (m12 + m21) / s, 0.25 * s
    q = np.array([w, x, y, z], dtype=np.float64)
    return q / np.linalg.norm(q)


def quat_to_rotmat_np(q: np.ndarray) -> np.ndarray:
    """wxyz -> (3,3) rotation (numpy)."""
    w, x, y, z = q / np.linalg.norm(q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def interpolate_cameras(cam0: Camera, cam1: Camera, n: int) -> list:
    """Pose interpolation between two cameras (slerp rotation, lerp center
    and time). Mirrors interpolation_pose (camera_utils.py:269-275) as used
    by eval.py's render_video."""
    q0 = rotmat_to_quat(cam0.R)
    q1 = rotmat_to_quat(cam1.R)
    out = []
    for i in range(n):
        a = i / max(n, 1)
        q = slerp(q0, q1, a)
        R = quat_to_rotmat_np(q)
        T = (1 - a) * cam0.T + a * cam1.T
        time = float((1 - a) * cam0.time + a * cam1.time)
        out.append(
            Camera(
                uid=-1, R=R, T=T, fovx=cam0.fovx, fovy=cam0.fovy, image=None,
                image_name=f"interp_{cam0.image_name}_{i}", width=cam0.width,
                height=cam0.height, time=time,
            )
        )
    return out
