"""Build the CUDA kernels with nvcc and load them with ctypes.

Each csrc/*.cu file is compiled to an object by its own nvcc process, all
started together, and one more nvcc call links the objects into
build/gpt_torch/libgpt_kernels-<hash>.so at the root of the checkout; the
hash covers the sources, the headers and the flags, so an edited source
builds anew and an unchanged one is loaded as it is. The sources include no
PyTorch header (a file that does takes minutes to compile; these take
seconds), and the library is written to a temporary name and renamed into
place, so an interrupted build leaves nothing that a later one waits on.

The build runs on first use, inside the first kernel launch, never at
import. A failed build or load raises; nothing falls back to the plain
PyTorch versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "gpt_torch"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xptxas", "-v", "-Xcompiler",
              "-fPIC")

_P = ctypes.c_void_p
_SIGNATURES = {
    # name: argtypes (every pointer and the stream as c_void_p)
    "gpt_stack_rows": [_P, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                       _P, _P],
    "gpt_interleave_rows": [_P, ctypes.c_longlong, _P, _P],
    "gpt_expand_rows": [_P, _P, ctypes.c_int, _P, ctypes.c_longlong,
                        ctypes.c_int, ctypes.c_float, ctypes.c_float, _P,
                        _P],
    "gpt_blend_fwd": [_P, ctypes.c_longlong, _P, _P, ctypes.c_int,
                      ctypes.c_int, ctypes.c_int, _P, _P],
    "gpt_blend_bwd": [_P, ctypes.c_longlong, _P, _P, ctypes.c_int,
                      ctypes.c_int, _P, _P, _P],
    "gpt_blend_fwd_flat": [_P, ctypes.c_longlong, _P, _P, ctypes.c_int,
                           ctypes.c_int, _P, _P, _P, _P, ctypes.c_int,
                           ctypes.c_int, _P, _P],
    "gpt_blend_bwd_flat": [_P, ctypes.c_longlong, _P, _P, ctypes.c_int,
                           ctypes.c_int, _P, _P, _P, _P, ctypes.c_int, _P,
                           _P, _P],
    "gpt_blend_fwd_mt": [_P, ctypes.c_longlong, _P, _P, ctypes.c_int,
                         ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P],
    "gpt_blend_bwd_mt": [_P, ctypes.c_longlong, _P, _P, ctypes.c_int,
                         ctypes.c_int, ctypes.c_int, _P, _P, _P],
    "gpt_blend_fwd_smt": [_P, ctypes.c_longlong, _P, _P, ctypes.c_int,
                          ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P],
    "gpt_blend_bwd_smt": [_P, ctypes.c_longlong, _P, _P, ctypes.c_int,
                          ctypes.c_int, ctypes.c_int, _P, _P, _P],
    "gpt_cumsum_rows": [_P, ctypes.c_int, ctypes.c_longlong, _P, _P, _P],
    "gpt_scatter_add_sorted": [_P, _P, ctypes.c_longlong, ctypes.c_int,
                               ctypes.c_int, _P, _P, _P],
}

_lock = threading.Lock()
_lib = None
build_info: dict = {}   # path, seconds, log (nvcc/ptxas output), cached


def sources():
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built"
    )


def build() -> Path:
    """Compile the library if it is not built yet; return its path."""
    out = BUILD_DIR / f"libgpt_kernels-{_digest()}.so"
    if out.exists():
        build_info.update(path=str(out), seconds=0.0, log="", cached=True)
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    objdir = BUILD_DIR / f"obj-{_digest()}-{os.getpid()}"
    objdir.mkdir()
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    jobs = []
    try:
        for src in sources():
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o",
                   str(objdir / f"{src.stem}.o"), str(src)]
            jobs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        link = [nvcc, *ARCH, "-shared", "-o", str(tmp),
                *[c[-2] for c, _ in jobs]]
        log, failed = "", []
        for cmd, proc in jobs:
            log += proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)} ({proc.returncode})")
        if not failed:
            proc = subprocess.run(link, capture_output=True, text=True)
            log += proc.stdout + proc.stderr
            if proc.returncode != 0:
                failed.append(f"{' '.join(link)} ({proc.returncode})")
        if failed:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed: {'; '.join(failed)}\n{log}")
    finally:
        for _, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(objdir, ignore_errors=True)
    seconds = time.perf_counter() - t0
    os.replace(tmp, out)
    build_info.update(path=str(out), seconds=seconds, log=log, cached=False)
    return out


def library():
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:            # the lock only until the library is loaded
        with _lock:
            if _lib is None:
                lib = ctypes.CDLL(str(build()))
                for name, argtypes in _SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                _lib = lib
    return _lib


def launch(name: str, *args) -> None:
    """Call one extern "C" launcher; raise if it reports a CUDA error."""
    code = getattr(library(), name)(*args)
    if code != 0:
        raise RuntimeError(f"{name} failed: cudaError {code}")


def row_pointers(rows):
    """A host array of device pointers, one per row tensor."""
    return (ctypes.c_void_p * len(rows))(*[r.data_ptr() for r in rows])
