"""ctypes binding of the native PNG decoder (data/csrc/fastpng.cpp).

The port's counterpart of gaussianprediction_tpu/data/native.py. The
library is built with g++ at first use, never at import, into
build/gpt_torch/libfastpng-<hash>.so at the root of the checkout (beside
the CUDA kernels' library, kernels/build.py), the hash covering the source
and the flags; it is written to a temporary name and renamed into place.
As in the JAX package, decode_png returns None when the library cannot be
built or loaded, or the file is a PNG variant it does not decode, and the
caller (data/image_io.py) then decodes with PIL; available() says which
decoder runs.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from gaussianprediction_tpu_torch.kernels.build import BUILD_DIR

SOURCE = Path(__file__).resolve().parent / "csrc" / "fastpng.cpp"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None
_tried = False
build_error: Optional[str] = None   # why the library is absent, if it is


def _build() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    out = BUILD_DIR / f"libfastpng-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    proc = subprocess.run(
        ["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE), "-lz"],
        capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({proc.returncode}): {proc.stderr}")
    os.replace(tmp, out)
    return out


def _load() -> Optional[ctypes.CDLL]:
    """The library, built on the first call; None when it cannot be (the
    reason in build_error). A failed build is not tried again."""
    global _lib, _tried, build_error
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(str(_build()))
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            build_error = f"{type(e).__name__}: {e}"
            return None
        lib.fastpng_probe.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        lib.fastpng_probe.restype = ctypes.c_int
        lib.fastpng_decode.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.fastpng_decode.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the native decoder is built and loaded (building it now if
    it was not tried yet)."""
    return _load() is not None


def decode_png(path: str, channels: Optional[int] = None
               ) -> Optional[np.ndarray]:
    """Decode one PNG to float32 [H, W, C] in [0, 1] (C = channels, else
    the file's own); None where the library is absent or the file is not
    a variant it decodes."""
    lib = _load()
    if lib is None:
        return None
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if lib.fastpng_probe(path.encode(), ctypes.byref(w), ctypes.byref(h),
                         ctypes.byref(c)) != 0:
        return None
    out_c = channels if channels is not None else c.value
    buf = np.empty((h.value, w.value, out_c), np.float32)
    rc = lib.fastpng_decode(
        path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        w.value, h.value, out_c)
    return buf if rc == 0 else None
