"""Full Nerfies/HyperNeRF camera model (numpy, host-side).

Torch-port copy of gaussianprediction_tpu/data/nerfies_camera.py (numpy
only; the port imports nothing of the JAX package).

Behavioral twin of the reference's `scene/utils.py:97-427` Camera (itself
from Nerfies): a look-at pinhole camera with skew, pixel aspect ratio, and
Brown–Conrady radial (k1,k2,k3) + tangential (p1,p2) distortion, plus the
pixel→ray / pixel→point machinery and the scale/crop/look_at constructors
the HyperNeRF tooling uses. The rasterization path is effectively pinhole
(reference and this framework both build FoV cameras from focal/size —
data/hypernerf.py), so this model's role is data preparation and exactness
bookkeeping: undistorting ray grids, projecting world points into distorted
captures (e.g. vrig scenes), and camera rescaling for the rgb pyramid.

All math re-derived from the model definition:
  distorted = (x·D + 2p1·xy + p2(r² + 2x²),  y·D + 2p2·xy + p1(r² + 2y²)),
  D = 1 + k1 r² + k2 r⁴ + k3 r⁶,  r² = x² + y²
with the inverse computed by a damped Newton iteration on the residual
(standard practice; the reference uses 10 undamped iterations — we match).
"""
from __future__ import annotations

import copy
import json
from typing import Optional, Tuple, Union

import numpy as np


def _distort(x, y, k1, k2, k3, p1, p2):
    """Forward Brown–Conrady distortion of normalized camera coords."""
    r2 = x * x + y * y
    d = 1.0 + r2 * (k1 + r2 * (k2 + k3 * r2))
    xd = x * d + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * d + 2.0 * p2 * x * y + p1 * (r2 + 2.0 * y * y)
    return xd, yd


def undistort(xd, yd, k1=0.0, k2=0.0, k3=0.0, p1=0.0, p2=0.0,
              eps: float = 1e-9, max_iterations: int = 10):
    """Invert the distortion: find (x, y) with distort(x, y) == (xd, yd).

    Newton's method on the 2-vector residual, initialized at the distorted
    point; the 2x2 Jacobian is solved in closed form. Matches the
    reference's `_radial_and_tangential_undistort` iteration count.
    """
    x = np.array(xd, copy=True)
    y = np.array(yd, copy=True)
    for _ in range(max_iterations):
        r2 = x * x + y * y
        d = 1.0 + r2 * (k1 + r2 * (k2 + k3 * r2))
        fx, fy = _distort(x, y, k1, k2, k3, p1, p2)
        fx = fx - xd
        fy = fy - yd
        # dD/d(r2) * d(r2)/d{x,y}
        dd_dr2 = k1 + r2 * (2.0 * k2 + 3.0 * k3 * r2)
        dx = 2.0 * x * dd_dr2
        dy = 2.0 * y * dd_dr2
        fx_x = d + dx * x + 2.0 * p1 * y + 6.0 * p2 * x
        fx_y = dy * x + 2.0 * p1 * x + 2.0 * p2 * y
        fy_x = dx * y + 2.0 * p2 * y + 2.0 * p1 * x
        fy_y = d + dy * y + 2.0 * p2 * x + 6.0 * p1 * y
        det = fx_x * fy_y - fx_y * fy_x
        safe = np.abs(det) > eps
        inv = np.where(safe, 1.0 / np.where(safe, det, 1.0), 0.0)
        x = x - (fx * fy_y - fy * fx_y) * inv
        y = y - (fy * fx_x - fx * fy_x) * inv
    return x, y


class NerfiesCamera:
    """Distorted look-at camera (see module docstring).

    orientation: [3,3] world→camera rotation (rows = camera axes);
    position: [3] camera center in world coords.
    """

    def __init__(self, orientation, position, focal_length, principal_point,
                 image_size, skew: float = 0.0,
                 pixel_aspect_ratio: float = 1.0,
                 radial_distortion=None, tangential_distortion=None,
                 dtype=np.float32):
        if radial_distortion is None:
            radial_distortion = np.zeros(3, dtype)
        if tangential_distortion is None:
            tangential_distortion = np.zeros(2, dtype)
        self.orientation = np.asarray(orientation, dtype)
        self.position = np.asarray(position, dtype)
        self.focal_length = np.asarray(focal_length, dtype)
        self.principal_point = np.asarray(principal_point, dtype)
        self.skew = np.asarray(skew, dtype)
        self.pixel_aspect_ratio = np.asarray(pixel_aspect_ratio, dtype)
        self.radial_distortion = np.asarray(radial_distortion, dtype)
        self.tangential_distortion = np.asarray(tangential_distortion, dtype)
        self.image_size = np.asarray(image_size, np.uint32)
        self.dtype = dtype

    # ---- (de)serialization (camera/*.json files) -----------------------
    @classmethod
    def from_json(cls, path: str) -> "NerfiesCamera":
        with open(path) as f:
            d = json.load(f)
        if "tangential" in d:  # legacy key used by old captures
            d["tangential_distortion"] = d["tangential"]
        size = np.asarray(d.get("image_size", [0, 0]), np.float64)
        return cls(
            orientation=np.asarray(d["orientation"]),
            position=np.asarray(d["position"]),
            focal_length=d["focal_length"],
            # minimal pinhole jsons (synthetic fixtures) omit the optics
            # block; default the principal point to the image center
            principal_point=np.asarray(
                d.get("principal_point", (size / 2.0).tolist())
            ),
            skew=d.get("skew", 0.0),
            pixel_aspect_ratio=d.get("pixel_aspect_ratio", 1.0),
            radial_distortion=np.asarray(
                d.get("radial_distortion", [0.0, 0.0, 0.0])
            ),
            tangential_distortion=np.asarray(
                d.get("tangential_distortion", [0.0, 0.0])
            ),
            image_size=size.astype(np.int64),
        )

    def to_json(self) -> dict:
        return {
            "orientation": self.orientation.tolist(),
            "position": self.position.tolist(),
            "focal_length": float(self.focal_length),
            "principal_point": self.principal_point.tolist(),
            "skew": float(self.skew),
            "pixel_aspect_ratio": float(self.pixel_aspect_ratio),
            "radial_distortion": self.radial_distortion.tolist(),
            "tangential_distortion": self.tangential_distortion.tolist(),
            "image_size": self.image_size.tolist(),
        }

    # ---- simple properties ---------------------------------------------
    @property
    def optical_axis(self):
        return self.orientation[2, :]

    @property
    def translation(self):
        return -self.orientation @ self.position

    @property
    def image_size_x(self) -> int:
        return int(self.image_size[0])

    @property
    def image_size_y(self) -> int:
        return int(self.image_size[1])

    @property
    def has_distortion(self) -> bool:
        return bool(
            np.any(self.radial_distortion != 0.0)
            or np.any(self.tangential_distortion != 0.0)
        )

    # ---- rays -----------------------------------------------------------
    def pixel_to_local_rays(self, pixels: np.ndarray) -> np.ndarray:
        """[..., 2] pixel coords -> [..., 3] unit rays in camera coords."""
        y = (pixels[..., 1] - self.principal_point[1]) / (
            self.focal_length * self.pixel_aspect_ratio
        )
        x = (
            pixels[..., 0] - self.principal_point[0] - y * self.skew
        ) / self.focal_length
        if self.has_distortion:
            x, y = undistort(
                x, y,
                k1=float(self.radial_distortion[0]),
                k2=float(self.radial_distortion[1]),
                k3=float(self.radial_distortion[2]),
                p1=float(self.tangential_distortion[0]),
                p2=float(self.tangential_distortion[1]),
            )
        dirs = np.stack([x, y, np.ones_like(x)], axis=-1)
        return dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)

    def pixels_to_rays(self, pixels: np.ndarray) -> np.ndarray:
        """[..., 2] pixels -> [..., 3] unit world-space ray directions."""
        local = self.pixel_to_local_rays(
            np.asarray(pixels, self.dtype).reshape(-1, 2)
        )
        world = local @ self.orientation  # R.T @ v, batched
        world = world / np.linalg.norm(world, axis=-1, keepdims=True)
        return world.reshape((*np.shape(pixels)[:-1], 3))

    def pixels_to_points(self, pixels: np.ndarray,
                         depth: np.ndarray) -> np.ndarray:
        """Back-project pixels at given optical-axis depth to world points."""
        rays = self.pixels_to_rays(pixels)
        cosa = rays @ self.optical_axis
        return rays * (depth / cosa)[..., None] + self.position

    def get_pixel_centers(self) -> np.ndarray:
        xx, yy = np.meshgrid(
            np.arange(self.image_size_x, dtype=self.dtype),
            np.arange(self.image_size_y, dtype=self.dtype),
        )
        return np.stack([xx, yy], axis=-1) + 0.5

    # ---- projection ------------------------------------------------------
    def project(self, points: np.ndarray) -> np.ndarray:
        """[..., 3] world points -> [..., 2] distorted pixel coords."""
        shape = np.shape(points)[:-1]
        pts = np.asarray(points, self.dtype).reshape(-1, 3)
        local = (pts - self.position) @ self.orientation.T
        x = local[:, 0] / local[:, 2]
        y = local[:, 1] / local[:, 2]
        xd, yd = _distort(
            x, y,
            float(self.radial_distortion[0]),
            float(self.radial_distortion[1]),
            float(self.radial_distortion[2]),
            float(self.tangential_distortion[0]),
            float(self.tangential_distortion[1]),
        )
        px = self.focal_length * xd + self.skew * yd + self.principal_point[0]
        py = (self.focal_length * self.pixel_aspect_ratio * yd
              + self.principal_point[1])
        return np.stack([px, py], axis=-1).reshape((*shape, 2))

    # ---- derived cameras -------------------------------------------------
    def scale(self, factor: float) -> "NerfiesCamera":
        """Rescale the image domain (the rgb/{n}x pyramid levels)."""
        if factor <= 0:
            raise ValueError("scale must be positive")
        cam = self.copy()
        cam.focal_length = np.asarray(self.focal_length * factor, self.dtype)
        cam.principal_point = np.asarray(
            self.principal_point * factor, self.dtype
        )
        cam.image_size = np.asarray(
            [int(round(self.image_size_x * factor)),
             int(round(self.image_size_y * factor))], np.uint32,
        )
        return cam

    def crop_image_domain(self, left=0, right=0, top=0,
                          bottom=0) -> "NerfiesCamera":
        """Shrink (or grow, negative) the image bounds, preserving the
        principal axis."""
        new_size = np.asarray(
            [self.image_size_x - left - right,
             self.image_size_y - top - bottom]
        )
        if np.any(new_size <= 0):
            raise ValueError("crop would empty the image domain")
        cam = self.copy()
        cam.principal_point = np.asarray(
            self.principal_point - np.asarray([left, top]), self.dtype
        )
        cam.image_size = new_size.astype(np.uint32)
        return cam

    def look_at(self, position, look_at, up,
                eps: float = 1e-6) -> "NerfiesCamera":
        """Reposition the camera to look at a world point (same intrinsics)."""
        position = np.asarray(position, np.float64)
        optical = np.asarray(look_at, np.float64) - position
        n = np.linalg.norm(optical)
        if n < eps:
            raise ValueError("camera center == look-at point")
        optical = optical / n
        right = np.cross(optical, np.asarray(up, np.float64))
        n = np.linalg.norm(right)
        if n < eps:
            raise ValueError("up vector parallel to the optical axis")
        right = right / n
        cam = self.copy()
        R = np.stack([right, np.cross(optical, right), optical], axis=0)
        cam.orientation = R.astype(self.dtype)
        cam.position = position.astype(self.dtype)
        return cam

    def copy(self) -> "NerfiesCamera":
        return copy.deepcopy(self)
