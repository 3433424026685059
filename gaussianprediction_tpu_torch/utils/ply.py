"""Minimal PLY reader and writer (numpy, no external deps).

A copy of gaussianprediction_tpu/utils/ply.py (the port imports nothing of
the JAX package). It covers the reference's three uses of the `plyfile`
package: the dataset loaders' point clouds (fetch_point_cloud,
store_point_cloud: x/y/z, nx/ny/nz, red/green/blue) and the model's
save_ply attribute dump (write_ply, all-float32 vertex properties).
Binary little-endian and ascii, one 'vertex' element, scalar properties
only: the subset those files write and read.
"""
from __future__ import annotations

import os

import numpy as np

_PLY_TO_NP = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}
_NP_TO_PLY = {np.dtype(v): k for k, v in _PLY_TO_NP.items()
              if k in ("char", "uchar", "short", "ushort", "int", "uint",
                       "float", "double")}


def read_ply(path: str) -> dict:
    """Read a PLY file's 'vertex' element into {property_name: np.ndarray}."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        count = 0
        props = []
        in_vertex = False
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unexpected EOF in header")
            tokens = line.strip().split()
            if not tokens:
                continue
            if tokens[0] == b"format":
                fmt = tokens[1].decode()
            elif tokens[0] == b"element":
                in_vertex = tokens[1] == b"vertex"
                if in_vertex:
                    count = int(tokens[2])
            elif tokens[0] == b"property" and in_vertex:
                if tokens[1] == b"list":
                    raise ValueError(f"{path}: list properties unsupported")
                props.append((tokens[2].decode(), _PLY_TO_NP[tokens[1].decode()]))
            elif tokens[0] == b"end_header":
                break
        if fmt == "binary_little_endian":
            dtype = np.dtype([(n, "<" + t) for n, t in props])
            data = np.frombuffer(f.read(count * dtype.itemsize), dtype=dtype,
                                 count=count)
        elif fmt == "ascii":
            raw = np.loadtxt(f, max_rows=count, ndmin=2)
            dtype = np.dtype([(n, t) for n, t in props])
            data = np.zeros(count, dtype=dtype)
            for i, (n, _) in enumerate(props):
                data[n] = raw[:, i]
        else:
            raise ValueError(f"{path}: unsupported format {fmt}")
    return {n: np.ascontiguousarray(data[n]) for n, _ in props}


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


def fetch_point_cloud(path: str):
    """points/colors/normals triple like fetchPly (dataset_readers.py:112-118).

    Colors stored as uchar are scaled to [0,1]; float colors pass through.
    """
    v = read_ply(path)
    points = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float32)
    if "red" in v:
        colors = np.stack([v["red"], v["green"], v["blue"]], axis=1)
        if colors.dtype == np.uint8:
            colors = colors.astype(np.float32) / 255.0
        else:
            colors = colors.astype(np.float32)
    else:
        colors = np.ones_like(points) * 0.5
    if "nx" in v:
        normals = np.stack([v["nx"], v["ny"], v["nz"]], axis=1).astype(np.float32)
    else:
        normals = np.zeros_like(points)
    return points, colors, normals


def store_point_cloud(path: str, xyz: np.ndarray, rgb: np.ndarray) -> None:
    """storePly twin (dataset_readers.py:120-135): xyz f4, normals f4 zeros,
    rgb uchar."""
    rgb8 = np.clip(rgb, 0, 255).astype(np.uint8)
    zeros = np.zeros(len(xyz), np.float32)
    write_ply(
        path,
        {
            "x": xyz[:, 0].astype(np.float32),
            "y": xyz[:, 1].astype(np.float32),
            "z": xyz[:, 2].astype(np.float32),
            "nx": zeros, "ny": zeros, "nz": zeros,
            "red": rgb8[:, 0], "green": rgb8[:, 1], "blue": rgb8[:, 2],
        },
        order=["x", "y", "z", "nx", "ny", "nz", "red", "green", "blue"],
    )
