"""Host-side image decode and encode, and a decode-ahead prefetcher.

Torch-port copy of gaussianprediction_tpu/data/image_io.py (numpy only):
load_image and load_image_rgba decode through the native PNG decoder
(data/native.py) where it is built and the file is a variant it decodes,
else through PIL; both give byte / 255 as float32, bit for bit.
Added here: load_image_composited (the Blender loader's alpha composite,
shared by its eager path and the lazily decoding Camera) and write_png, a
writer on the standard library alone (zlib and struct), so that saving a
render needs no imaging package. PIL is imported only where a decode
needs it: where the native decoder cannot decode a file and PIL is
absent, the decode raises.
"""
from __future__ import annotations

import concurrent.futures
import os
import struct
import threading
import zlib
from typing import Callable, Sequence

import numpy as np

PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


def load_image(path: str, resize_wh=None) -> np.ndarray:
    """Decode to float32 [H, W, 3] in [0, 1] (resized to resize_wh =
    (width, height) through PIL when given)."""
    if resize_wh is None and path.lower().endswith(".png"):
        from gaussianprediction_tpu_torch.data import native

        out = native.decode_png(path, channels=3)
        if out is not None:
            return out
    from PIL import Image

    img = Image.open(path)
    if resize_wh is not None:
        img = img.resize(resize_wh)
    arr = np.asarray(img, dtype=np.float32) / 255.0
    if arr.ndim == 2:
        arr = np.repeat(arr[..., None], 3, axis=-1)
    return np.ascontiguousarray(arr[..., :3])


def load_image_rgba(path: str, resize_wh=None) -> np.ndarray:
    """Decode to float32 [H, W, 4] (alpha 1 where the file has none)."""
    if resize_wh is None and path.lower().endswith(".png"):
        from gaussianprediction_tpu_torch.data import native

        out = native.decode_png(path, channels=4)
        if out is not None:
            return out
    from PIL import Image

    img = Image.open(path).convert("RGBA")
    if resize_wh is not None:
        img = img.resize(resize_wh)
    return np.asarray(img, dtype=np.float32) / 255.0


def load_image_composited(path: str, background: float) -> np.ndarray:
    """RGBA composited onto a uniform background value: rgb * a + bg *
    (1 - a), float32 [H, W, 3] (the reference's Blender loader)."""
    rgba = load_image_rgba(path)
    rgb = rgba[..., :3] * rgba[..., 3:4] + background * (1.0 - rgba[..., 3:4])
    return rgb.astype(np.float32)


def image_size(path: str):
    """(W, H), read through PIL (which reads the header only)."""
    from PIL import Image

    with Image.open(path) as img:
        return img.size


def write_png(path: str, img: np.ndarray) -> None:
    """Write uint8 [H, W] or [H, W, C] (C = 1, 2, 3 or 4: gray, gray +
    alpha, RGB, RGBA) as an 8-bit non-interlaced PNG, every row with
    filter type 0."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8, not {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    color_type = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    rows = np.zeros((h, 1 + w * c), np.uint8)
    rows[:, 1:] = img.reshape(h, w * c)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(PNG_MAGIC)
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type,
                                           0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(rows.tobytes())))
        f.write(chunk(b"IEND", b""))


class Prefetcher:
    """Decode-ahead iterator: keeps `depth` images in flight on worker
    threads while the device trains on the current one."""

    def __init__(self, load_fn: Callable[[int], np.ndarray],
                 workers: int = 4, depth: int = 8):
        self._load = load_fn
        self._pool = concurrent.futures.ThreadPoolExecutor(workers)
        self._depth = depth
        self._futures: dict = {}
        self._lock = threading.Lock()

    def schedule(self, indices: Sequence[int]):
        with self._lock:
            for i in indices[: self._depth]:
                if i not in self._futures:
                    self._futures[i] = self._pool.submit(self._load, i)

    def get(self, index: int) -> np.ndarray:
        with self._lock:
            fut = self._futures.pop(index, None)
        if fut is None:
            return self._load(index)
        return fut.result()

    def close(self):
        self._pool.shutdown(wait=False, cancel_futures=True)
