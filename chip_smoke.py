#!/usr/bin/env python3
"""Drive the PyTorch port's stage-1 eval render and its training steps of
every stage on one NVIDIA H100.

Phases (each prints one flushed line with its wall time; any failure ends
the run with a non-zero exit and no result line):

  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels (one nvcc call) and print ptxas's register and
     shared-memory lines;
  3. make a stage-1 `dnerf` model from --seed with numpy: 200k random
     Gaussians, SH degree 3, a numpy-initialised d=4 w=256 deform MLP and
     32-d motion features; capacity sized by the port's probe_slot_need;
  4. run each kernel (stack, expand, interleave, forward blend) on the
     inputs the first view's render hands it, beside its plain PyTorch
     version: stack, expand and interleave must be equal, the blend within
     2e-5 on rgb and T, 2e-4 on depth, tidx equal where the top weight
     beats the runner-up by more than 1e-6 relative;
  5. render a small scene against the torch oracle
     (ops/rasterize_reference.py) through the kernels;
  6. render_set over 5 orbit views at 800x800 with the launch counts set
     to 0 just before and read just after: finite, non-constant images,
     n_dropped == 0, every kernel launched, one view rendered twice
     bit-identical; ms per view from CUDA events;
  7. a torch.profiler breakdown of one view's device time;
  8. training at the same width (200k live Gaussians in the preset's padded
     capacity): the target is the port's render of a second random model
     (--seed + 1) at the first view. The first training step (stage 0)
     runs with its kernel inputs captured, and the backward blend, the
     cumsum_channels and cumsum_rows scans are held to their plain versions
     on them: blend_bwd rows 0-9 within 1e-5 of each row's largest
     magnitude, the columns beyond it counted and held to 0.1% (done
     latches that flip on an ulp), two launches bit-identical; the scans
     within 64 * 2^-24 * cumsum(|x|);
  9. 12 stage-1 steps from iteration 20000 with the counts set to 0 just
     before: finite loss, grads and params, n_dropped == 0, blend_bwd once a
     step, the loss falling from the first step to the last; ms per step
     from CUDA events (median of the steps after the first); one step run
     twice from the same state bit-identical (else the op that differs is
     named); one densify_and_prune_clone_split + prune event, then one more
     step;
 10. one step with GPT_BWD_REDUCE=pallas (cumsum_channels) and one with
     batched (interleave + cumsum_rows), each against serial on the same
     state: the per-Gaussian gradient within f32 cumsum roundoff;
 11. a torch.profiler breakdown of one training step;
 12. the 1->2 transition of the trained stage-1 model at iteration 30001:
     a smooth non-zero motion feature, a seeded hash-grid weight model (16
     levels, F=4, T=2^19, the 2x64 MLP), k-means keypoints
     (set_super_keypoints) and a fresh Adam: exactly 100 keypoints alive,
     every value finite;
 13. the first stage-2 step with its scatter_add_sorted inputs captured
     (M = 26,214,400 contributions into 6,101,902 slots at this width):
     the kernel within 64 * 2^-24 * Σ|contributions| of each slot of its
     plain version, two launches bit-identical, and compared bit for bit
     with the serial sum on the CPU; index_add_ timed as the library call;
 14. 8 stage-2 steps with the counts set to 0 just before: finite loss,
     grads and params, n_dropped == 0, scatter_add_sorted and blend_bwd once
     a step, ms per step; one step run twice bit-identical; one
     grow_keypoints_from_grads event (100 < keypoints <= 200), one more step;
 15. the 2->3 transition and 8 stage-3 steps from iteration 40001 with the
     same checks, the loss falling from the first step to the last;
 16. a torch.profiler breakdown of one stage-2 step (the kernel, the sorts
     and the gathers by name), then the encoder's gather (and the 2-d
     index_select it replaces, checked equal) and the table gradient's
     stable sort, each timed alone with CUDA events;
 17. a `kernels` JSON line, the nvidia-smi line, and as the last line
     {"ok": true, "device": {...}}.

Usage:
  python3 chip_smoke.py                # on a machine with one CUDA card
  python3 chip_smoke.py --rehearse     # the same phases on the CPU at 2k
                                       # Gaussians and 128x128 (3 steps a
                                       # stage), plain versions, no result
                                       # line
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

F32_PEAK = 67e12       # H100 SXM f32 (non-tensor) FLOP/s, NVIDIA data sheet
HBM_BYTES_S = 3.35e12  # H100 SXM HBM3 bytes/s

REPLACES = {
    "stack": "gaussianprediction_tpu/ops/expand_pallas.py:410",
    "expand": "gaussianprediction_tpu/ops/expand_pallas.py:298",
    "interleave": "gaussianprediction_tpu/ops/expand_pallas.py:355",
    "blend_fwd": "gaussianprediction_tpu/ops/rasterize_pallas.py:337",
    "blend_bwd": "gaussianprediction_tpu/ops/rasterize_pallas.py:448",
    "cumsum_channels": "gaussianprediction_tpu/ops/scan_pallas.py:84",
    "cumsum_rows": "gaussianprediction_tpu/ops/scan_pallas.py:49",
    "scatter_add_sorted": "gaussianprediction_tpu/ops/hashgrid_pallas.py:49",
}
SOURCES = {
    "stack": "gaussianprediction_tpu_torch/kernels/csrc/stack_rows.cu",
    "expand": "gaussianprediction_tpu_torch/kernels/csrc/expand_rows.cu",
    "interleave":
        "gaussianprediction_tpu_torch/kernels/csrc/interleave_rows.cu",
    "blend_fwd": "gaussianprediction_tpu_torch/kernels/csrc/blend_fwd.cu",
    "blend_bwd": "gaussianprediction_tpu_torch/kernels/csrc/blend_bwd.cu",
    "cumsum_channels":
        "gaussianprediction_tpu_torch/kernels/csrc/cumsum_rows.cu",
    "cumsum_rows": "gaussianprediction_tpu_torch/kernels/csrc/cumsum_rows.cu",
    "scatter_add_sorted":
        "gaussianprediction_tpu_torch/kernels/csrc/scatter_add_sorted.cu",
}
# the __global__ functions of each kernel, as torch.profiler names them
# (the scan is three: block sums, their scan, the block scans)
SCAN_FUNCS = ("block_sums_kernel", "scan_sums_kernel", "scan_rows_kernel")
DEVICE_NAMES = {
    "stack": ("stack_rows_kernel",),
    "expand": ("expand_rows_kernel",),
    "interleave": ("interleave_rows_kernel",),
    "blend_fwd": ("blend_fwd_kernel",),
    "blend_bwd": ("blend_bwd_kernel",),
    "cumsum_channels": SCAN_FUNCS,
    "cumsum_rows": SCAN_FUNCS,
    "scatter_add_sorted": ("mark_heads_kernel", "reduce_runs_kernel"),
}
FWD_KERNELS = ("stack", "expand", "interleave", "blend_fwd")
EPS32 = 2.0 ** -24


def log(msg: str) -> None:
    print(msg, flush=True)


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = time.perf_counter() - self.t0
        status = "ok" if exc_type is None else f"FAILED ({exc_type.__name__})"
        log(f"[phase] {self.name}: {status} in {dt:.2f} s")
        return False


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def time_ms(fn, dev, reps: int) -> float:
    """Mean ms per call: CUDA events around `reps` calls after a warm-up
    (a host clock on the CPU)."""
    fn()
    sync(dev)
    if dev.type == "cuda":
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        e1.synchronize()
        return e0.elapsed_time(e1) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def make_params(cfg, n: int, seed: int):
    """A stage-1 model as the JAX package's params dict of numpy arrays."""
    from gaussianprediction_tpu_torch.data.synthetic import random_gaussians
    from gaussianprediction_tpu_torch.models.gaussians import (
        deform_mlp_sizes,
    )
    from gaussianprediction_tpu_torch.ops.mlp import init_mlp
    from gaussianprediction_tpu_torch.utils.sh import rgb_to_sh

    g = random_gaussians(n, seed=seed, scale_range=(-5.2, -3.8))
    rng = np.random.default_rng(seed + 1)
    k_rest = (cfg.model.sh_degree + 1) ** 2 - 1
    params = {
        "xyz": g["xyz"],
        "features_dc": rgb_to_sh(g["colors"])[:, None, :],
        "features_rest": (0.1 * rng.normal(size=(n, k_rest, 3))).astype(
            np.float32),
        "scaling": g["log_scales"],
        "rotation": g["rotation"],
        "opacity": g["opacity_logit"],
        "motion_feature": (1e-3 * (2.0 * rng.random(
            (n, cfg.model.feature_dim)) - 1.0)).astype(np.float32),
        "df_mlp": init_mlp(rng, deform_mlp_sizes(cfg)),
    }
    return params, np.ones(n, bool)


class Capture:
    """Records the arguments the main path hands each kernel wrapper (the
    last call of each), and what it returned."""

    def __init__(self, targets=None):
        from gaussianprediction_tpu_torch.ops import expand
        from gaussianprediction_tpu_torch.ops import rasterize_kernels as rk

        self.targets = targets or [
            (expand, "stack_rows"), (expand, "expand_emit"),
            (expand, "interleave_rows"), (rk, "rasterize_binned")]
        self.args = {}
        self.out = {}

    def __enter__(self):
        self.saved = []
        for mod, name in self.targets:
            orig = getattr(mod, name)
            self.saved.append((mod, name, orig))

            def wrapper(*a, _orig=orig, _name=name, **k):
                self.args[_name] = (a, k)
                self.out[_name] = _orig(*a, **k)
                return self.out[_name]

            setattr(mod, name, wrapper)
        return self

    def __exit__(self, *exc):
        for mod, name, orig in self.saved:
            setattr(mod, name, orig)
        return False


def check_kernels(args_by_name, dev, reps: int):
    """Each kernel beside its plain version on the main path's inputs."""
    from gaussianprediction_tpu_torch.ops import expand as E
    from gaussianprediction_tpu_torch.ops import rasterize_kernels as rk

    res = {}

    # stack
    (chans, *rest), kw = args_by_name["stack_rows"]
    nch = kw.get("nch", rest[0] if rest else 16)
    n = chans[0].shape[0]
    out = E.stack_rows(chans, nch=nch)
    ref = E.stack_rows_plain(chans, nch)
    if not torch.equal(out, ref):
        raise AssertionError("stack_rows kernel != plain")
    zeros = [torch.zeros_like(chans[0]) for _ in range(nch - len(chans))]
    res["stack"] = dict(
        max_abs_err=float((out - ref).abs().max()),
        ms=time_ms(lambda: E.stack_rows(chans, nch=nch), dev, reps),
        plain_ms=time_ms(lambda: E.stack_rows_plain(chans, nch), dev, reps),
        library_ms=time_ms(lambda: torch.stack(list(chans) + zeros), dev,
                           reps),
        bytes=(len(chans) + nch) * n * 4, ops=0,
    )

    # expand (raw and fused emit)
    (permat, offs, total, cap, gx, sentinel), _ = args_by_name["expand_emit"]
    out = E.expand_emit(permat, offs, total, cap, gx, sentinel)
    raw_ref = E.expand_rows_raw_plain(permat, offs, total, cap)
    ref = E.emit_from_raw(raw_ref, total, gx, sentinel)
    if not torch.equal(out, ref):
        raise AssertionError("expand kernel (emit) != plain")
    if not torch.equal(E.expand_rows_raw(permat, offs, total, cap), raw_ref):
        raise AssertionError("expand kernel (raw) != plain")
    # slots past the last Gaussian's start belong to it, as in the kernel
    counts = torch.diff(offs, append=offs.new_tensor([cap])).to(torch.int64)
    lib = lambda: torch.repeat_interleave(permat, counts, dim=1,  # noqa: E731
                                          output_size=cap)
    if not torch.equal(lib(), raw_ref):
        raise AssertionError("repeat_interleave != expand_rows_raw")
    # The emit needs rows 0-14 of each Gaussian that owns a live slot (row
    # 15 is pad) and only rw (row 13) of the others, offs, total; it
    # writes 12 rows of cap slots.
    ng = permat.shape[1]
    n_live = int(((permat[13] > 0.5) & (offs < total)).sum())
    res["expand"] = dict(
        max_abs_err=float((out - ref).abs().max()),
        ms=time_ms(lambda: E.expand_emit(permat, offs, total, cap, gx,
                                         sentinel), dev, reps),
        plain_ms=time_ms(lambda: E.emit_from_raw(
            E.expand_rows_raw_plain(permat, offs, total, cap), total, gx,
            sentinel), dev, reps),
        library_ms=time_ms(lib, dev, reps),
        bytes=(15 * n_live + (ng - n_live) + ng + 1) * 4
        + E.N_EMIT * cap * 4, ops=0,
    )

    # interleave
    (chans,), _ = args_by_name["interleave_rows"]
    n = chans[0].shape[0]
    out = E.interleave_rows(chans)
    ref = E.interleave_rows_plain(chans)
    if not torch.equal(out, ref):
        raise AssertionError("interleave_rows kernel != plain")
    valid = (chans[10] >= 0).to(torch.float32)
    zeros = [torch.zeros_like(valid) for _ in range(4)]
    res["interleave"] = dict(
        max_abs_err=float((out - ref).abs().max()),
        ms=time_ms(lambda: E.interleave_rows(chans), dev, reps),
        plain_ms=time_ms(lambda: E.interleave_rows_plain(chans), dev, reps),
        library_ms=time_ms(lambda: torch.stack(list(chans) + [valid] + zeros),
                           dev, reps),
        bytes=(11 + 16) * n * 4, ops=0,
    )

    # forward blend
    (inst, ts, te, gx, gy, with_tidx), _ = args_by_name["rasterize_binned"]
    out = rk.rasterize_binned(inst, ts, te, gx, gy, with_tidx)
    aux = {}
    t0 = time.perf_counter()
    ref = rk.rasterize_binned_plain(inst, ts, te, gx, gy, with_tidx, aux=aux)
    sync(dev)
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = (out[..., :5] - ref[..., :5]).abs()
    err_rgbt = float(err[..., [0, 1, 2, 4]].max())
    err_z = float(err[..., 3].max())
    wmax, w2 = ref[..., rk.O_WMAX], aux["w2"]
    clear = (wmax - w2) > 1e-6 * wmax
    tidx_bad = int(((out[..., rk.O_GID] != ref[..., rk.O_GID])
                    & clear).sum())
    log(f"blend: max |err| rgb,T {err_rgbt:.3e}  depth {err_z:.3e}  "
        f"tidx mismatches (clear top) {tidx_bad}  pairs {aux['pairs']}  "
        f"flops {aux['flops']}  instances read {aux['instances']}")
    if not (err_rgbt <= 2e-5 and err_z <= 2e-4 and tidx_bad == 0):
        raise AssertionError("blend kernel disagrees with its plain version")
    T = gx * gy
    res["blend_fwd"] = dict(
        max_abs_err=max(err_rgbt, err_z),
        ms=time_ms(lambda: rk.rasterize_binned(inst, ts, te, gx, gy,
                                               with_tidx), dev, reps),
        plain_ms=plain_ms, library_ms=None,
        bytes=aux["instances"] * 12 * 4 + 2 * T * 4 + T * rk.PIX * 8 * 4,
        ops=aux["flops"],
    )
    add_bounds(res)
    return res


def add_bounds(res: dict) -> None:
    """bound_ms: the larger of the bytes over the HBM rate and the f32
    operations over the f32 peak, from this run's inputs."""
    for name, r in res.items():
        t_bytes = r["bytes"] / HBM_BYTES_S * 1e3
        t_ops = r["ops"] / F32_PEAK * 1e3
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "operations" if t_ops > t_bytes else "bytes"
        log(f"kernel {name}: max |err| {r['max_abs_err']:.3e}  "
            f"ms {r['ms']:.4f}  plain_ms {r['plain_ms']:.4f}  "
            f"bound_ms {r['bound_ms']:.4f} ({r['bound_by']})  "
            f"library_ms {r['library_ms']}")


def oracle_check(dev, seed: int) -> None:
    """A small scene through the port's render (kernels on the card)
    against the torch oracle, with the JAX package's test tolerances."""
    from gaussianprediction_tpu_torch.data.synthetic import (
        orbit_camera, random_gaussians,
    )
    from gaussianprediction_tpu_torch.ops import projection as PJ
    from gaussianprediction_tpu_torch.ops.rasterize import render
    from gaussianprediction_tpu_torch.ops.rasterize_reference import (
        rasterize_pixels_reference,
    )

    W = H = 64
    g = random_gaussians(300, seed=seed, scale_range=(-3.4, -2.0))
    cam = orbit_camera(0.5, width=W, height=H).to_device_dict(dev)
    t = {k: torch.from_numpy(v).to(dev) for k, v in g.items()}
    op = torch.sigmoid(t["opacity_logit"][:, 0])
    scal = torch.exp(t["log_scales"])
    rot = t["rotation"] / torch.linalg.norm(t["rotation"], dim=-1,
                                            keepdim=True)
    bg = torch.zeros(3, device=dev)
    out = render(t["xyz"], scal, rot, op, None, cam, W, H, bg,
                 colors_precomp=t["colors"], capacity_multiplier=24)
    proj = PJ.project_from_params(t["xyz"], scal, rot, cam, W, H,
                                  opacity=op)
    rgb, depth, alpha, _ = rasterize_pixels_reference(proj, t["colors"], op,
                                                      bg, W, H)
    e_rgb = float((out["render"] - rgb).abs().max())
    e_z = float((out["depth"] - depth).abs().max())
    e_a = float((out["alpha"] - alpha).abs().max())
    log(f"oracle: n_dropped {int(out['n_dropped'])}  max |err| rgb {e_rgb:.3e}"
        f"  depth {e_z:.3e}  alpha {e_a:.3e}")
    if int(out["n_dropped"]) != 0 or e_rgb > 2e-5 or e_a > 2e-5 or e_z > 2e-4:
        raise AssertionError("render disagrees with the oracle")


def profile(run, dev, label: str, reps: int = 3, top: int = 15,
            named=None) -> dict:
    """Device time by kernel over `reps` calls of run() and the device's
    busy share of that window (torch.profiler; CUPTI). Only device-side
    events are summed: an operator's own row would count its kernels a
    second time. Returns each ported kernel's mean device ms per launch
    (the sum over its __global__ functions; None when not launched).
    named: {label: substrings}; prints the device ms per call of run() of
    the kernels whose names hold any of the substrings."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    run()
    sync(dev)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with tprofile(activities=acts, acc_events=True) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            run()
        sync(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    rows = []
    for e in prof.key_averages():
        if "CUDA" not in str(getattr(e, "device_type", "")):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            rows.append((us / (reps * 1e3), e.count / reps, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"profile {label}: wall {wall_ms:.3f} ms, device busy {busy:.3f} ms "
        f"({100 * busy / wall_ms:.1f}%, idle {100 - 100 * busy / wall_ms:.1f}"
        f"%), {sum(r[1] for r in rows):.0f} kernels")
    for ms, count, key in rows[:top]:
        log(f"  {ms:9.4f} ms  x{count:<5.1f} {key[:100]}")
    for lbl, subs in (named or {}).items():
        hits = [(ms, c, key) for ms, c, key in rows
                if any(x in key for x in subs)]
        log(f"  {lbl}: {sum(h[0] for h in hits):.4f} ms in "
            f"{sum(h[1] for h in hits):.0f} kernels "
            f"{sorted({h[2][:60] for h in hits})}")
    device_ms = {}
    for name, funcs in DEVICE_NAMES.items():
        per = []
        for f in funcs:
            hits = [(ms, c) for ms, c, key in rows if f in key]
            n_launch = sum(c for _, c in hits)
            if n_launch:
                per.append(sum(m for m, _ in hits) / n_launch)
        device_ms[name] = sum(per) if len(per) == len(funcs) else None
    return device_ms


def pad_to_capacity(params, alive, C: int):
    """A params dict of n live rows padded to C rows with dead Gaussians
    (scale -10, opacity -15, identity rotation, zeros elsewhere), as the
    JAX package's capacity padding leaves free slots."""
    n = alive.shape[0]
    out = {}
    for k, v in params.items():
        if k == "df_mlp":
            out[k] = v
            continue
        pad = np.zeros((C - n,) + v.shape[1:], np.float32)
        if k == "scaling":
            pad[:] = -10.0
        elif k == "opacity":
            pad[:] = -15.0
        elif k == "rotation":
            pad[:, 0] = 1.0
        out[k] = np.concatenate([v, pad])
    return out, np.concatenate([alive, np.zeros(C - n, bool)])


def check_train_kernels(cap, dev, reps: int):
    """The backward blend and both scans beside their plain versions on the
    first training step's inputs."""
    from gaussianprediction_tpu_torch.ops import expand as E
    from gaussianprediction_tpu_torch.ops import rasterize_kernels as rk
    from gaussianprediction_tpu_torch.ops import scan

    res = {}
    (inst, ts, te, gx, gy, dpix), _ = cap.args["rasterize_binned_bwd"]
    a = rk.rasterize_binned_bwd(inst, ts, te, gx, gy, dpix)
    b = rk.rasterize_binned_bwd(inst, ts, te, gx, gy, dpix)
    sync(dev)
    if not torch.equal(a, b):
        raise AssertionError("blend_bwd: two launches differ")
    aux = {}
    t0 = time.perf_counter()
    ref = rk.rasterize_binned_bwd_plain(inst, ts, te, gx, gy, dpix, aux=aux)
    sync(dev)
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = (a[:10] - ref[:10]).abs()
    scale = ref[:10].abs().amax(dim=1, keepdim=True)
    bad = (err > 1e-5 * scale).any(dim=0)
    live = (ref[:10] != 0).any(dim=0) | (a[:10] != 0).any(dim=0)
    n_bad, n_live = int(bad.sum()), int(live.sum())
    err_in = float(torch.where(bad[None], 0.0, err).max())
    log(f"blend_bwd: bit-identical across 2 launches; columns with a row "
        f"beyond 1e-5 of the row's max |grad| {n_bad} of {n_live} live; "
        f"max |err| {float(err.max()):.3e} (within tolerance {err_in:.3e});"
        f" pairs {aux['pairs']} flops {aux['flops']} instances read "
        f"{aux['instances']}")
    if a[10:].any() or n_bad > 1e-3 * max(n_live, 1):
        raise AssertionError("blend_bwd disagrees with its plain version")
    T = gx * gy
    res["blend_bwd"] = dict(
        max_abs_err=float(err.max()),
        ms=time_ms(lambda: rk.rasterize_binned_bwd(inst, ts, te, gx, gy,
                                                   dpix), dev, reps),
        plain_ms=plain_ms, library_ms=None,
        # instances read (12 channels), bounds, dpix (5 channels), the 10
        # gradient rows of the instances read
        bytes=aux["instances"] * (12 + 10) * 4 + 2 * T * 4
        + T * rk.PIX * 5 * 4, ops=aux["flops"],
    )

    # the scans, on the first step's cotangent rows sorted by gid
    (gid_row, kept, d_inst), _ = cap.args["build_instances_bwd"]
    gid = gid_row.to(torch.int32)
    order = torch.sort(gid, stable=True).indices
    srt = d_inst[:10].index_select(1, order)
    chans = [srt[c] for c in range(10)]
    P = srt.shape[1]
    mat = E.interleave_rows(chans + [gid.index_select(0, order).to(
        torch.float32)])
    for name, fn, plain, x, rows_read in (
            ("cumsum_channels", lambda: scan.cumsum_channels(chans),
             lambda: scan.cumsum_channels_plain(chans),
             scan.cumsum_channels_plain(chans) * 0 + torch.cat(
                 [srt, srt.new_zeros((6, P))]), 10),
            ("cumsum_rows", lambda: scan.cumsum_rows(mat),
             lambda: scan.cumsum_rows_plain(mat), mat, 16)):
        out, ref = fn(), plain()
        sync(dev)
        tol = 64 * EPS32 * torch.cumsum(x.abs(), dim=1)
        err = (out - ref).abs()
        n_out = int((err > tol).sum())
        rel = float((err / torch.cumsum(x.abs(), dim=1).clamp(
            min=1e-30)).max())
        log(f"{name}: max |err| {float(err.max()):.3e}, max |err| / "
            f"cumsum(|x|) {rel:.3e}, {n_out} elements beyond 64 * 2^-24 * "
            f"cumsum(|x|); deterministic {torch.equal(out, fn())}")
        if n_out:
            raise AssertionError(f"{name} disagrees with torch.cumsum")
        res[name] = dict(
            max_abs_err=float(err.max()), ms=time_ms(fn, dev, reps),
            plain_ms=time_ms(plain, dev, reps),
            library_ms=time_ms(lambda x=x: torch.cumsum(x, dim=1), dev,
                               reps),
            bytes=(rows_read + 16) * P * 4, ops=0,
        )
    add_bounds(res)
    return res


def finite_tree(tree) -> bool:
    from gaussianprediction_tpu_torch.train.optimizer import tree_leaves

    return all(bool(torch.isfinite(x).all()) for x in tree_leaves(tree))


def checked(out, what):
    """A step's (state, opt_state, metrics), after checking n_dropped == 0
    and a finite loss, gradients and params."""
    st, op, m = out
    if int(m["n_dropped"]) != 0:
        raise AssertionError(f"{what}: n_dropped {int(m['n_dropped'])}")
    if not (torch.isfinite(m["loss"]) and finite_tree(m["grads"])
            and finite_tree(st.params)):
        raise AssertionError(f"{what}: non-finite loss, grads or params")
    return out


def diagnose_nondeterminism(run) -> str:
    """Run the step twice with every kernel wrapper's and the stream
    reduction's outputs captured; name the first that differs."""
    from gaussianprediction_tpu_torch.ops import expand as E
    from gaussianprediction_tpu_torch.ops import hashgrid_kernels as HK
    from gaussianprediction_tpu_torch.ops import instance_stream as IS
    from gaussianprediction_tpu_torch.ops import rasterize_kernels as rk

    targets = [(E, "stack_rows"), (E, "expand_emit"),
               (E, "interleave_rows"), (rk, "rasterize_binned"),
               (rk, "rasterize_binned_bwd"), (IS, "build_instances_bwd"),
               (HK, "scatter_add_sorted")]
    outs = []
    for _ in range(2):
        with Capture(targets) as cap:
            metrics = run()[2]
        outs.append((cap.out, metrics["grads"]))
    for _, name in targets:
        if name in outs[0][0] and not torch.equal(outs[0][0][name],
                                                  outs[1][0][name]):
            return name
    for key in outs[0][1]:
        from gaussianprediction_tpu_torch.train.optimizer import tree_leaves

        if not all(torch.equal(x, y) for x, y in zip(
                tree_leaves(outs[0][1][key]), tree_leaves(outs[1][1][key]))):
            return f"the autograd backward into {key}"
    return "none found"


def train_phases(cfg, dev, n: int, size: int, seed: int, views, bg,
                 rehearse: bool, reps: int):
    """Phases 8-11. Returns (res, launches, device_ms, ctx): for the
    kernels line the kernel checks, each kernel's launch count from the
    run of its path and each kernel's device ms per launch in a profiled
    step; ctx, the trained stage-1 state and the view for stages 2/3."""
    import copy

    from gaussianprediction_tpu_torch import kernels
    from gaussianprediction_tpu_torch.convert import state_from_params
    from gaussianprediction_tpu_torch.ops import instance_stream as IS
    from gaussianprediction_tpu_torch.ops import rasterize_kernels as rk
    from gaussianprediction_tpu_torch.ops.instance_stream import (
        probe_slot_need,
    )
    from gaussianprediction_tpu_torch.train import densify as DN
    from gaussianprediction_tpu_torch.train import optimizer as O
    from gaussianprediction_tpu_torch.train.step import (
        deform_for_stage, make_train_step, render_at_time, stage_of,
    )

    cfg = copy.deepcopy(cfg)
    it0, it1 = 500, 20_000
    assert stage_of(cfg, it0) == 0 and stage_of(cfg, it1) == 1
    nsteps = 3 if rehearse else 12
    extent = 1.3                       # the random scene's half width
    sh = cfg.model.sh_degree
    C = n + 512 if rehearse else cfg.model.padded_capacity()
    view = views[0]
    cam = view.to_device_dict(dev)
    t = torch.tensor(view.time, dtype=torch.float32, device=dev)
    bg_t = torch.as_tensor(bg, device=dev)
    gen = lambda: torch.Generator(dev).manual_seed(seed)  # noqa: E731

    with Phase("training set-up"):
        params, alive = pad_to_capacity(*make_params(cfg, n, seed), C)
        state = state_from_params(params, alive, device=dev)
        opt = O.init_adam(state.params)
        gstate = state_from_params(*make_params(cfg, n, seed + 1),
                                   device=dev)
        need = 0
        with torch.no_grad():
            for st, it, stage in ((state, it0, 0), (state, it1, 1),
                                  (gstate, it1, 1)):
                d = deform_for_stage(st.params, cfg, st, t, it, None, stage)
                need = max(need, int(probe_slot_need(
                    d.xyz, d.scaling, d.rotation, d.opacity, cam, size,
                    size, alive=st.alive)))
            cfg.model.capacity_multiplier = max(
                2, -(-int(need * 1.3) // C))
            pkg, _ = render_at_time(gstate.params, cfg, gstate, cam, t, it1,
                                    None, 1, size, size, bg_t, sh)
            gt = pkg["render"].clamp(0.0, 1.0)
        if int(pkg["n_dropped"]) != 0:
            raise AssertionError("target render dropped instances")
        step0 = make_train_step(cfg, 0, size, size, extent, sh, 50, bg_t)
        step1 = make_train_step(cfg, 1, size, size, extent, sh, 50, bg_t)
        log(f"training: {n} live of {C} Gaussians, {size}x{size}, slot need "
            f"{need}, capacity_multiplier {cfg.model.capacity_multiplier}, "
            f"target = render of the --seed {seed + 1} model")

    with Phase("first training step (stage 0): kernels vs plain versions"):
        with Capture([(rk, "rasterize_binned_bwd"),
                      (IS, "build_instances_bwd")]) as cap:
            state, opt, m = checked(step0(state, opt, cam, gt, t, it0,
                                          gen()), "stage-0 step")
        sync(dev)
        log(f"stage-0 step: loss {float(m['loss']):.6f}  psnr "
            f"{float(m['psnr']):.3f}")
        with torch.no_grad():
            res = check_train_kernels(cap, dev, reps)

    with Phase(f"training ({nsteps} stage-1 steps, densify, prune)"):
        kernels.reset_launch_counts()
        losses, ms = [], []
        for k in range(nsteps):
            if dev.type == "cuda":
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                out = step1(state, opt, cam, gt, t, it1 + k, gen())
                e1.record()
                e1.synchronize()
                ms.append(e0.elapsed_time(e1))
            else:
                t0 = time.perf_counter()
                out = step1(state, opt, cam, gt, t, it1 + k, gen())
                ms.append((time.perf_counter() - t0) * 1e3)
            state, opt, m = checked(out, f"stage-1 step {k}")
            losses.append(float(m["loss"]))
        sync(dev)
        launches = {k: v for k, v in kernels.launch_counts.items()}
        log(f"stage-1 steps: loss {[round(x, 6) for x in losses]}")
        log(f"ms per step {[round(x, 3) for x in ms]}; median of steps "
            f"2-{nsteps}: {float(np.median(ms[1:])):.3f} ms; launches "
            f"{launches}")
        if not losses[-1] < losses[0]:
            raise AssertionError("the loss did not fall")
        if not rehearse:
            need_k = ("stack", "expand", "interleave", "blend_fwd",
                      "blend_bwd")
            missing = [k for k in need_k if launches.get(k, 0) <= 0]
            if missing:
                raise AssertionError(f"kernels not launched: {missing}")
            if launches["blend_bwd"] != nsteps:
                raise AssertionError("blend_bwd not launched once a step")

        run = lambda: step1(state, opt, cam, gt, t, it1 + nsteps,  # noqa
                            gen())
        a, b = run(), run()
        same = torch.equal(a[2]["loss"], b[2]["loss"]) and all(
            torch.equal(x, y) for x, y in zip(O.tree_leaves(a[0].params),
                                              O.tree_leaves(b[0].params)))
        log(f"one step run twice from the same state: identical {same}")
        if not same:
            raise AssertionError("a step run twice differs; first op that "
                                 f"differs: {diagnose_nondeterminism(run)}")

        st2, opt2 = DN.densify_and_prune_clone_split(state, opt, cfg, extent,
                                                     gen())
        born = int((st2.alive & ~state.alive).sum())
        split = int((state.alive & ~st2.alive).sum())
        st3 = DN.prune(st2, cfg, extent, 20)
        pruned = int((st2.alive & ~st3.alive).sum())
        log(f"densify: {born - 2 * split} clones, {split} splits "
            f"({2 * split} children), {pruned} pruned; live "
            f"{int(state.alive.sum())} -> {int(st3.alive.sum())} of {C}")
        state, opt, m = checked(step1(st3, opt2, cam, gt, t, it1 + nsteps,
                                      gen()), "step after densify")
        log(f"step after densify: loss {float(m['loss']):.6f}")

    with Phase("backward reductions: pallas and batched vs serial"):
        dfeat, counts = {}, {}
        for mode in ("serial", "pallas", "batched"):
            os.environ["GPT_BWD_REDUCE"] = mode
            kernels.reset_launch_counts()
            try:
                with Capture([(IS, "build_instances_bwd")]) as cap:
                    checked(step1(state, opt, cam, gt, t, it1, gen()),
                            f"{mode} step")
                sync(dev)
            finally:
                del os.environ["GPT_BWD_REDUCE"]
            counts[mode] = dict(kernels.launch_counts)
            dfeat[mode] = cap.out["build_instances_bwd"]
            if mode == "serial":
                (gid_row, _, d_inst), _ = cap.args["build_instances_bwd"]
                order = torch.sort(gid_row.to(torch.int32),
                                   stable=True).indices
                srt = d_inst[:10].index_select(1, order)
                tol = 64 * EPS32 * float(torch.cumsum(srt, dim=1).abs()
                                         .max())
        for mode in ("pallas", "batched"):
            err = float((dfeat[mode] - dfeat["serial"]).abs().max())
            log(f"{mode} vs serial: max |d dfeat| {err:.3e} (tolerance "
                f"{tol:.3e}); launches {counts[mode]}")
            if not err <= tol:
                raise AssertionError(f"{mode} reduction != serial")
        if not rehearse and not (counts["pallas"].get("cumsum_channels", 0)
                                 and counts["batched"].get("cumsum_rows", 0)
                                 and counts["batched"].get("interleave", 0)):
            raise AssertionError("the reductions did not launch the scans")
        launches["cumsum_channels"] = counts["pallas"].get(
            "cumsum_channels", 0)
        launches["cumsum_rows"] = counts["batched"].get("cumsum_rows", 0)

    with Phase("profile (one training step)"):
        device_ms = profile(lambda: step1(state, opt, cam, gt, t, it1,
                                          gen()), dev, "one training step")
        for mode, name in (("pallas", "cumsum_channels"),
                           ("batched", "cumsum_rows")):
            os.environ["GPT_BWD_REDUCE"] = mode
            try:
                dm = profile(lambda: step1(state, opt, cam, gt, t, it1,
                                           gen()), dev,
                             f"one training step, {mode} reduction", top=0)
            finally:
                del os.environ["GPT_BWD_REDUCE"]
            device_ms[name] = dm[name]
        log(f"  blend_bwd device ms per launch {device_ms['blend_bwd']}")
    ctx = dict(cfg=cfg, state=state, opt=opt, cam=cam, gt=gt, t=t,
               bg_t=bg_t, extent=extent, C=C, gen=gen)
    return res, launches, device_ms, ctx


def check_scatter_kernel(cap, dev, reps: int):
    """scatter_add_sorted beside its plain version on the first stage-2
    step's table-gradient stream: within 64 * 2^-24 * Σ|contributions| of
    each slot, two launches bit-identical; also against the serial sum on
    the CPU (the plain version's own order) bit for bit, reported."""
    from gaussianprediction_tpu_torch.ops import hashgrid_kernels as HK

    (keys, vals, n_slots), _ = cap.args["scatter_add_sorted"]
    F, M = vals.shape
    a = HK.scatter_add_sorted(keys, vals, n_slots)
    b = HK.scatter_add_sorted(keys, vals, n_slots)
    sync(dev)
    if not torch.equal(a, b):
        raise AssertionError("scatter_add_sorted: two launches differ")
    t0 = time.perf_counter()
    ref = HK.scatter_add_sorted_plain(keys, vals, n_slots)
    sync(dev)
    plain_once = (time.perf_counter() - t0) * 1e3
    absum = HK.scatter_add_sorted_plain(keys, vals.abs(), n_slots)
    tol = 64 * EPS32 * absum
    err = (a - ref).abs()
    n_out = int((err > tol).sum())
    t0 = time.perf_counter()
    serial = HK.scatter_add_sorted_plain(keys.cpu(), vals.cpu(), n_slots)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    lib = lambda: torch.zeros((F, n_slots), device=dev).index_add_(  # noqa
        1, keys, vals)
    lib_err = float((lib() - a).abs().max())
    empty = int((absum == 0).all(dim=0).sum())
    log(f"scatter_add_sorted: M {M}, F {F}, slots {n_slots} ({empty} "
        f"empty); bit-identical across 2 launches; max |err| vs plain "
        f"{float(err.max()):.3e}, {n_out} slots beyond 64 * 2^-24 * "
        f"sum|v|; equal to the serial CPU sum bit for bit "
        f"{torch.equal(a.cpu(), serial)} (CPU {cpu_ms:.1f} ms); index_add_ "
        f"max |diff| {lib_err:.3e}; plain once {plain_once:.3f} ms")
    if n_out:
        raise AssertionError("scatter_add_sorted disagrees with its plain "
                             "version")
    res = {"scatter_add_sorted": dict(
        max_abs_err=float(err.max()),
        ms=time_ms(lambda: HK.scatter_add_sorted(keys, vals, n_slots), dev,
                   reps),
        plain_ms=time_ms(lambda: HK.scatter_add_sorted_plain(
            keys, vals, n_slots), dev, reps),
        library_ms=time_ms(lib, dev, reps),
        # keys and values read once, the table written once; F adds each
        bytes=M * (4 + 4 * F) + F * n_slots * 4, ops=M * F,
    )}
    add_bounds(res)
    return res


def stage23_phases(ctx, dev, seed: int, rehearse: bool, reps: int):
    """Phases 12-16 on the trained stage-1 state: the 1->2 transition,
    kernel #7 against its plain version, stage-2 steps with a keypoint
    growth event, the 2->3 transition and stage-3 steps, a profile of one
    stage-2 step. Returns (res, launches, device_ms) for the kernels
    line."""
    import copy

    from gaussianprediction_tpu_torch import kernels
    from gaussianprediction_tpu_torch.models.gaussians import weight_model
    from gaussianprediction_tpu_torch.ops import hashgrid as HG
    from gaussianprediction_tpu_torch.ops import hashgrid_kernels as HK
    from gaussianprediction_tpu_torch.ops.instance_stream import (
        probe_slot_need,
    )
    from gaussianprediction_tpu_torch.train import densify as DN
    from gaussianprediction_tpu_torch.train import optimizer as O
    from gaussianprediction_tpu_torch.train.loop import stage_transition
    from gaussianprediction_tpu_torch.train.step import (
        deform_for_stage, make_train_step, stage_of,
    )

    cfg = copy.deepcopy(ctx["cfg"])
    state, opt = ctx["state"], ctx["opt"]
    cam, gt, t, bg_t = ctx["cam"], ctx["gt"], ctx["t"], ctx["bg_t"]
    extent, C, gen = ctx["extent"], ctx["C"], ctx["gen"]
    size = gt.shape[0]
    sh = cfg.model.sh_degree
    s2, s3 = cfg.train.second_stage_iteration, cfg.train.third_stage_iteration
    it2, it3 = s2 + 1, s3 + 1
    assert stage_of(cfg, it2) == 2 and stage_of(cfg, it3) == 3
    nsteps = 3 if rehearse else 8

    def run_steps(step, st, op, it0, what):
        losses, ms = [], []
        for k in range(nsteps):
            if dev.type == "cuda":
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                out = step(st, op, cam, gt, t, it0 + k, gen())
                e1.record()
                e1.synchronize()
                ms.append(e0.elapsed_time(e1))
            else:
                t0 = time.perf_counter()
                out = step(st, op, cam, gt, t, it0 + k, gen())
                ms.append((time.perf_counter() - t0) * 1e3)
            st, op, m = checked(out, f"{what} step {k}")
            losses.append(float(m["loss"]))
        sync(dev)
        log(f"{what} steps: loss {[round(x, 6) for x in losses]}")
        log(f"{what}: ms per step {[round(x, 3) for x in ms]}; median of "
            f"steps 2-{nsteps}: {float(np.median(ms[1:])):.3f} ms")
        return st, op, losses

    def twice(step, st, op, it, what):
        run = lambda: step(st, op, cam, gt, t, it, gen())  # noqa: E731
        a, b = run(), run()
        same = torch.equal(a[2]["loss"], b[2]["loss"]) and all(
            torch.equal(x, y) for x, y in zip(O.tree_leaves(a[0].params),
                                              O.tree_leaves(b[0].params)))
        log(f"{what}: one step run twice from the same state: identical "
            f"{same}")
        if not same:
            raise AssertionError(f"{what}: a step run twice differs; first "
                                 f"op that differs: "
                                 f"{diagnose_nondeterminism(run)}")

    def launched(what):
        got = dict(kernels.launch_counts)
        log(f"{what}: launches {got}")
        if not rehearse:
            for k in ("scatter_add_sorted", "blend_bwd"):
                if got.get(k, 0) != nsteps:
                    raise AssertionError(f"{what}: {k} launched "
                                         f"{got.get(k, 0)} times in "
                                         f"{nsteps} steps")
        return got

    with Phase("stage 1 -> 2: keypoints by k-means"):
        rng = np.random.default_rng(seed + 7)
        params = dict(state.params)
        # a smooth, non-zero motion feature over space, as training leaves
        proj = torch.as_tensor(rng.normal(0, 2.0, (3, cfg.model.feature_dim)),
                               dtype=torch.float32, device=dev)
        feat = 0.1 * torch.sin(params["xyz"] @ proj)
        params["motion_feature"] = torch.where(state.alive[:, None], feat,
                                               torch.zeros_like(feat))
        tables, wmlp = weight_model(cfg, rng)
        to = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
        params["hash_tables"] = {k: to(v) for k, v in tables.items()}
        params["weight_mlp"] = [{k: to(v) for k, v in layer.items()}
                                for layer in wmlp]
        Ck = cfg.model.kpt_capacity()
        params["super_xyz"] = torch.ones((Ck, 3), device=dev)
        params["super_feature"] = torch.ones((Ck, cfg.model.feature_dim),
                                             device=dev)
        state = state.replace(params=params, kpt_alive=torch.zeros(
            (Ck,), dtype=torch.bool, device=dev))
        state, opt = stage_transition(state, opt, cfg, it2,
                                      generator=gen())
        sync(dev)
        nk = int(state.n_kpts())
        log(f"transition at iteration {it2}: {nk} keypoints alive of {Ck}; "
            f"hash tables {sum(v.shape[0] for v in tables.values())} slots "
            f"x {cfg.model.hash_features}")
        if nk != cfg.model.max_points or not finite_tree(state.params):
            raise AssertionError("the stage-2 transition failed")
        need = 0
        with torch.no_grad():
            for it in (it2, it3):
                d = deform_for_stage(state.params, cfg, state, t, it, gen(),
                                     stage_of(cfg, it))
                need = max(need, int(probe_slot_need(
                    d.xyz, d.scaling, d.rotation, d.opacity, cam, size,
                    size, alive=state.alive)))
        cfg.model.capacity_multiplier = max(
            cfg.model.capacity_multiplier, -(-int(need * 1.3) // C))
        log(f"stage-2/3 slot need {need}, capacity_multiplier "
            f"{cfg.model.capacity_multiplier}")
        step2 = make_train_step(cfg, 2, size, size, extent, sh, 50, bg_t)
        step3 = make_train_step(cfg, 3, size, size, extent, sh, 50, bg_t)

    with Phase("first stage-2 step: scatter_add_sorted vs plain version"):
        with Capture([(HK, "scatter_add_sorted")]) as cap:
            state, opt, m = checked(step2(state, opt, cam, gt, t, it2,
                                          gen()), "first stage-2 step")
        sync(dev)
        log(f"first stage-2 step: loss {float(m['loss']):.6f}")
        with torch.no_grad():
            res = check_scatter_kernel(cap, dev, reps)

    with Phase(f"training ({nsteps} stage-2 steps, keypoint growth)"):
        kernels.reset_launch_counts()
        state, opt, _ = run_steps(step2, state, opt, it2 + 1, "stage-2")
        launches = launched("stage-2")
        twice(step2, state, opt, it2 + 1 + nsteps, "stage-2")
        nk0 = int(state.n_kpts())
        state, opt = DN.grow_keypoints_from_grads(
            state, opt, cfg, max(cfg.model.adaptive_points_num, 1))
        nk1 = int(state.n_kpts())
        log(f"keypoint growth: {nk0} -> {nk1} of {Ck}")
        if not nk0 < nk1 <= Ck:
            raise AssertionError("keypoint growth failed")
        state, opt, m = checked(step2(state, opt, cam, gt, t,
                                      it2 + 1 + nsteps, gen()),
                                "step after keypoint growth")
        log(f"step after keypoint growth: loss {float(m['loss']):.6f}")

    with Phase(f"stage 2 -> 3, {nsteps} stage-3 steps"):
        state, opt = stage_transition(state, opt, cfg, it3)
        if int(opt["step"]) != 0:
            raise AssertionError("the stage-3 transition kept Adam's state")
        kernels.reset_launch_counts()
        state, opt, losses = run_steps(step3, state, opt, it3, "stage-3")
        launched("stage-3")
        if not losses[-1] < losses[0]:
            raise AssertionError("the stage-3 loss did not fall")
        twice(step3, state, opt, it3 + nsteps, "stage-3")

    with Phase("profile (one stage-2 step)"):
        dm = profile(lambda: step2(state, opt, cam, gt, t, it2, gen()), dev,
                     "one stage-2 step", named={
                         "scatter_add_sorted": DEVICE_NAMES[
                             "scatter_add_sorted"],
                         # every sort of the step: the table gradient's
                         # [16, 8N] keys, the tile sort, the stream's sort
                         "sorts": ("sort", "Sort"),
                         "gathers and indexing": ("ather", "ndex"),
                     })
        log(f"  scatter_add_sorted device ms per launch "
            f"{dm['scatter_add_sorted']}")
        # the encoder's own pieces, timed alone on this step's inputs
        m = cfg.model
        tables = state.params["hash_tables"]
        specs, _ = HG.hashgrid_specs(tables, m.hash_min_res, m.hash_max_res)
        keys, _ = HG.hashgrid_keys_weights(state.params["xyz"], specs,
                                           m.hash_bound)
        flat = HG._flat_tables(tables)
        kflat = keys.reshape(-1)
        rows = HG._gather_rows(flat, kflat)
        if not torch.equal(rows, flat.index_select(0, kflat)):
            raise AssertionError("the encoder's gather != index_select")
        kl = keys.reshape(keys.shape[0], -1)
        t_rows = time_ms(lambda: HG._gather_rows(flat, kflat), dev, reps)
        t_2d = time_ms(lambda: flat.index_select(0, kflat), dev, 3)
        t_sort = time_ms(lambda: torch.sort(kl, dim=1, stable=True), dev,
                         reps)
        log(f"  encoder gather of {kflat.shape[0]} rows of {flat.shape[1]}"
            f" f32 (one complex128 element a row): {t_rows:.4f} ms; the "
            f"same rows by a 2-d index_select: {t_2d:.4f} ms; the table "
            f"gradient's stable sort of {list(kl.shape)} int32 keys: "
            f"{t_sort:.4f} ms")
    return res, launches, {"scatter_add_sorted": dm["scatter_add_sorted"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rehearse", action="store_true",
                    help="CPU, 2k Gaussians, 128x128, plain versions")
    args = ap.parse_args()

    from gaussianprediction_tpu_torch import kernels
    from gaussianprediction_tpu_torch.config import get_preset
    from gaussianprediction_tpu_torch.convert import state_from_params
    from gaussianprediction_tpu_torch.data.synthetic import orbit_camera
    from gaussianprediction_tpu_torch.eval.render import (
        make_render_fn, render_set,
    )
    from gaussianprediction_tpu_torch.ops.instance_stream import (
        probe_slot_need,
    )
    from gaussianprediction_tpu_torch.train.step import (
        deform_for_stage, stage_of,
    )

    if args.rehearse:
        dev, n, size, reps = torch.device("cpu"), 2_000, 128, 2
        smi = "rehearse on the CPU"
    else:
        if not torch.cuda.is_available():
            log("CUDA is not available: chip_smoke.py needs a CUDA card "
                "(use --rehearse on the CPU)")
            return 2
        dev, n, size, reps = torch.device("cuda"), 200_000, 800, 20
        with Phase("nvidia-smi"):
            smi = smi_line()
            log(smi)
            log(f"python {sys.version.split()[0]}, torch {torch.__version__},"
                f" CUDA {torch.version.cuda}")
    if not args.rehearse:
        from gaussianprediction_tpu_torch.kernels import build

        with Phase("build kernels"):
            build.library()
            info = build.build_info
            log(f"build: {info['seconds']:.2f} s (cached {info['cached']}) "
                f"-> {info['path']}")
            for line in info["log"].splitlines():
                if "registers" in line or "smem" in line or \
                        "Compiling entry" in line or "spill" in line:
                    log("  " + line.strip())

    cfg = get_preset("dnerf")
    iteration = 20_000            # stage 1, past xyz_noise_iteration
    assert stage_of(cfg, iteration) == 1
    with Phase("model"):
        params, alive = make_params(cfg, n, args.seed)
        state = state_from_params(params, alive, device=dev)
        views = [
            orbit_camera(0.5 + 1.2 * i, width=size, height=size,
                         time=i / 4.0, uid=i)
            for i in range(5)
        ]
        need = 0
        with torch.no_grad():
            for v in views:
                t = torch.tensor(v.time, dtype=torch.float32, device=dev)
                d = deform_for_stage(state.params, cfg, state, t, iteration,
                                     None, 1)
                need = max(need, int(probe_slot_need(
                    d.xyz, d.scaling, d.rotation, d.opacity,
                    v.to_device_dict(dev), size, size, alive=state.alive)))
        cfg.model.capacity_multiplier = max(2, -(-int(need * 1.2) // n))
        log(f"model: {n} Gaussians, {size}x{size}, SH {cfg.model.sh_degree}, "
            f"MLP d={cfg.model.d} w={cfg.model.w}, slot need {need}, "
            f"capacity_multiplier {cfg.model.capacity_multiplier}")

    bg = np.zeros(3, np.float32)
    fn = make_render_fn(state, cfg, iteration, size, size, bg,
                        cfg.model.sh_degree)
    with Phase("kernels vs plain versions (first view)"):
        t0 = torch.tensor(views[0].time, dtype=torch.float32, device=dev)
        with Capture() as cap:
            fn(views[0].to_device_dict(dev), t0)
        sync(dev)
        with torch.no_grad():
            res = check_kernels(cap.args, dev, reps)

    with Phase("small scene vs oracle"):
        with torch.no_grad():
            oracle_check(dev, args.seed)

    with Phase("render_set (5 views)"):
        stats = {}
        kernels.reset_launch_counts()
        renders, _, fps = render_set(state, cfg, iteration, views, bg,
                                     stats=stats)
        sync(dev)
        launches = dict(kernels.launch_counts)
        log(f"render_set: ms per view {stats['ms']}  fps {fps:.2f}  "
            f"n_dropped {stats['n_dropped']}  launches {launches}")
        for i, img in enumerate(renders):
            if img.shape != (size, size, 3) or not np.isfinite(img).all():
                raise AssertionError(f"view {i}: bad image")
            if float(img.max() - img.min()) <= 0.0:
                raise AssertionError(f"view {i}: constant image")
        if any(d != 0 for d in stats["n_dropped"]):
            raise AssertionError("n_dropped != 0")
        if not args.rehearse:
            missing = [k for k in FWD_KERNELS if launches.get(k, 0) <= 0]
            if missing:
                raise AssertionError(f"kernels not launched: {missing}")
        cam0 = views[0].to_device_dict(dev)
        a = fn(cam0, t0)
        b = fn(cam0, t0)
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            raise AssertionError("one view rendered twice differs")

    with Phase("profile (one view, 3 renders)"):
        device_ms = profile(lambda: fn(cam0, t0), dev, "one view")
        for name in FWD_KERNELS:
            log(f"  kernel {name}: device ms per launch {device_ms[name]}")
        device_ms = {k: device_ms[k] for k in FWD_KERNELS}

    tres, tlaunches, tdevice_ms, ctx = train_phases(
        cfg, dev, n, size, args.seed, views, bg, args.rehearse, reps)
    res.update(tres)
    launches.update({k: tlaunches.get(k, 0) for k in tres})
    device_ms.update({k: tdevice_ms[k] for k in tres})
    sres, slaunches, sdevice_ms = stage23_phases(ctx, dev, args.seed,
                                                 args.rehearse, reps)
    res.update(sres)
    launches.update({k: slaunches.get(k, 0) for k in sres})
    device_ms.update(sdevice_ms)

    line = {"kernels": [
        {
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches.get(name, 0),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "device_ms": device_ms[name],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        }
        for name, r in res.items()
    ]}
    log(json.dumps(line))
    log(smi)
    if args.rehearse:
        log("rehearsal done (no result line off the card)")
        return 0
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
