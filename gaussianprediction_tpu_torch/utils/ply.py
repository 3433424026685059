"""Minimal PLY writer (numpy, no external deps).

A copy of write_ply of gaussianprediction_tpu/utils/ply.py (the port
imports nothing of the JAX package): binary little-endian, one 'vertex'
element of scalar properties, as the model's save_ply writes it. The
reader and the point-cloud helpers of the dataset loaders wait for the
loaders (ROADMAP.md, Queue 1 item 7).
"""
from __future__ import annotations

import os

import numpy as np

_NP_TO_PLY = {np.dtype(t): name for name, t in (
    ("char", "i1"), ("uchar", "u1"), ("short", "i2"), ("ushort", "u2"),
    ("int", "i4"), ("uint", "u4"), ("float", "f4"), ("double", "f8"))}


def write_ply(path: str, arrays: dict, order=None) -> None:
    """Write named per-vertex arrays as binary_little_endian PLY."""
    names = list(order) if order is not None else list(arrays.keys())
    n = len(arrays[names[0]])
    fields = []
    for name in names:
        a = np.asarray(arrays[name])
        assert a.shape == (n,), f"property {name} must be 1-D of length {n}"
        fields.append((name, a))
    dtype = np.dtype([(name, "<" + np.dtype(a.dtype).str[1:])
                      for name, a in fields])
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {n}\n".encode())
        for name, a in fields:
            f.write(f"property {_NP_TO_PLY[np.dtype(a.dtype)]} {name}\n".encode())
        f.write(b"end_header\n")
        rec = np.zeros(n, dtype=dtype)
        for name, a in fields:
            rec[name] = a
        f.write(rec.tobytes())
