#!/usr/bin/env python3
"""Drive the PyTorch port's stage-1 eval render, its training steps of
every stage (the classic binning path, the ellipse cull, gradient
accumulation and several iterations a call too), its Trainer loop,
motion extrapolation and its four CLIs on a D-NeRF and a HyperNeRF scene
on disk, on one NVIDIA H100.

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
     version: each must be equal bit for bit (the blend in all 8 output
     channels; its line gives the share of (warp, instance) pairs the
     forward walk's cull keeps, from the plain model); the library calls of
     stack and interleave (torch.stack) timed with events and, in one
     torch.profiler window with the kernel (the two called in turn), on
     the device;
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
     on them: blend_bwd equal to its plain version on the card bit for
     bit (the plain version summing the pixels in the kernel's order,
     sums="kernel"), two launches bit-identical; the scans within
     64 * 2^-24 * cumsum(|x|);
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
 12. blend variants (GPT_BLEND_FLAT=1; GPT_BLEND_MT=1 at TPB 4 and 3;
     GPT_BLEND_SMT at 4 and 3): on the first view's stream and the dpix of
     a stage-1 step from the trained state, each variant's forward kernel
     equal bit for bit to the classic blend_fwd kernel and to its plain
     version, and on that step's forward input (the cull share logged)
     each of the four forward kernels equal bit for bit to the plain
     version, its backward kernel equal bit for bit to the classic
     blend_bwd kernel and to its plain version, two launches of each
     bit-identical; then render_set of the 5 views and one stage-1 step
     under FLAT, MT (TPB 4) and SMT (4), with the counts set to 0 just
     before each: images, loss and params equal to the classic path's bit
     for bit, each variant kernel
     launched (5 and 1 times) and the classic ones not; ms per view and per
     step (6 steps from one state) beside the classic path's; a profile of
     one view and one step under each;
 12b. the classic path (classic_phases): on phase 6's model and first
     view, render(fast_binning=False) equal to the fast path's render bit
     for bit with n_dropped == 0, blend_fwd equal to its plain version bit
     for bit on its CHUNK-aligned stream (segments with padding gaps);
     a render under GPT_ELLIPSE_CULL=1 equal to the uncut one bit for bit
     (the culled share printed), one from cov3d_precomp (the same scales
     and rotations) bit for bit, one with tight_rects=False finite with
     n_dropped == 0; a stage-1 step through the binning path (blend_bwd
     equal to its plain version bit for bit, sums="kernel"; twice
     bit-identical; the loss equal to the fast path's bit for bit, the
     per-Gaussian reduction within 64 * 2^-24 * max |cumsum| of the fast
     path's: the same columns behind a negative prefix of another length,
     which the card's row-wise scan associates otherwise), every
     blend variant's kernels on its stream equal to classic, a stage-1
     step under the cull equal to the uncut step bit for bit; a batched
     step of 3 (make_train_step_batched) within 1e-6 of three single
     renders' gradients summed and one Adam update, twice bit-identical;
     ms of each path beside the fast path's; the launches of the binning
     render, the binning step and the batched step added to the kernels
     line's rows;
 13. the 1->2 transition of the trained stage-1 model at iteration 30001:
     a smooth non-zero motion feature, a seeded hash-grid weight model (16
     levels, F=4, T=2^19, the 2x64 MLP), k-means keypoints
     (set_super_keypoints) and a fresh Adam: exactly 100 keypoints alive,
     every value finite;
 14. the first stage-2 step with its scatter_add_sorted inputs captured
     (M = 26,214,400 contributions into 6,101,902 slots at this width):
     the kernel equal bit for bit to its plain version on the CPU (the
     kernel's fixed order), within 64 * 2^-24 * Σ|contributions| of
     index_add_ in each slot, two launches bit-identical, empty slots 0;
     the kernel and index_add_ timed with events and in a profiler window;
 15. 8 stage-2 steps with the counts set to 0 just before: finite loss,
     grads and params, n_dropped == 0, scatter_add_sorted and blend_bwd once
     a step, ms per step; one step run twice bit-identical; one
     grow_keypoints_from_grads event (100 < keypoints <= 200), one more step;
 16. the 2->3 transition and 8 stage-3 steps from iteration 40001 with the
     same checks, the loss falling from the first step to the last;
 17. a torch.profiler breakdown of one stage-2 step (the kernel, the sorts
     and the gathers by name), then the encoder's gather (and the 2-d
     index_select it replaces, checked equal) and the table gradient's
     stable sort, each timed alone with CUDA events;
 17b. the weight encoders (fourier and brick beside the hash grid) from
     phase 13's stage-1 state: each with a seeded weight model through the
     1->2 transition and 4 stage-2 steps (finite loss, grads and params,
     n_dropped == 0, one step run twice bit-identical, ms per step side by
     side; #7 launched once a brick step, never a fourier one); the brick
     encoder's first step's scatter_add_sorted inputs (cell-granular keys:
     M = 26,214,400 contributions into 760,000-odd bricks x 64 cells)
     held as in phase 14 (that row of the kernels line is
     scatter_add_sorted_brick); distill_weight_init, 20 steps with the
     hash grid and the brick grid: the loss falling, a second run
     bit-identical; transition_diagnostics on phase 13's transition
     state (the first view as its test view): every value finite, all
     printed; the quality tool (tools/quality_proxy.py) at the protocol's
     width (256x256, 55 + 5 views, 2000 points), stage1 and hashgrid arms
     over 600 iterations: the test PSNR rising from the first report to
     the last; the launches of the timed steps and of the tool added to
     the kernels line's rows;
 18. the Trainer (train/loop.py) at the dnerf preset's full width under
     GPT_BLEND_SMT=4: a synthetic dynamic scene at 800x800 (100,000
     ground-truth Gaussians, 20 train and 3 test views) and run() over a
     schedule compressed to 700 iterations (trainer_schedule), with the
     counts set to 0 just before: every stage and host event fires (the
     transitions, densify, prune, the opacity reset, the capacity
     re-probe, keypoints growing past 100); no instance stream of the run
     fills its capacity, and the instances that rects capped at 1024
     tiles drop (the JAX package's render cap, met by the one or two
     Gaussians that grow over 41% of a view) stay within 1e-3 of their
     stream, both printed; history.json, the TensorBoard events, the PLY
     and the checkpoint written; the test PSNR at 400 at least 1 dB above
     the initial state's, the stage-3 loss falling; ms per iteration per
     stage (CUDA events around train_one) and a profile of one stage-2
     iteration; the scatter_add_sorted stream of the next stage-2
     iteration (where the dead rows make long runs in every level) held
     and timed as in phase 14;
 19. a second Trainer loads the checkpoint at 600 and runs to 700 under the
     classic blend: its final parameters equal the first run's bit for bit
     (within 1e-5 of each leaf's largest magnitude when its load re-probe
     chose another capacity multiplier);
 20. motion extrapolation ("GCN") from the first Trainer's final stage-3
     state and its scene, under the classic blend: keypoint trajectories
     at the 23 timestamps (split at 0.8: 18 train, 5 test) on the card
     and on the CPU (same noise draw) within 1e-5 of the largest |value|;
     train_gcn at the D-NeRF recipe's width (input 10, output 1, linear
     128, 6 stages, 101 epochs, batch 32, noise 0.1 over 100 epochs,
     norm_rotation): the loss falling, a second run bit-identical; one
     step on the card, on the CPU and on the CPU in f64 from one model
     (loss within 1e-5 relative; each gradient leaf within max(1e-3, 4x
     the CPU's f32 error against f64) of its largest magnitude, the
     graph-convolution biases ahead of a batch norm left out: their exact
     gradient is 0) and a profile of one step; the rollout over the test
     timestamps on the card and the CPU (within max(1e-4, 4x the CPU's
     f32 error against f64)) and
     its mean keypoint error; render_kpts of the predicted frames at the
     cameras of the test timestamps (n_dropped == 0, finite, blend_fwd
     equal to its plain version bit for bit on the last frame's stream,
     the cull share); evaluate_pairs of those frames (PSNR, SSIM,
     MS-SSIM, D-SSIM, LPIPS from the seeded golden weights written under
     build/), LPIPS on the golden pair within 2e-3 of the committed
     goldens and on a rendered pair within 1e-4 of the CPU's;
     render_video (the first three of those cameras, 2 frames a pair)
     and render_train_sequence (three training times, one frozen view):
     finite, n_dropped == 0; ms per timestamp, step, frame; the launches
     of the three render entry points (counts set to 0 just before each)
     added to rows stack, expand, interleave and blend_fwd;
 21. the user's path from a scene on disk ("CLI"): phase 18's scene (all
     23 views, times i/22) written as a D-NeRF tree (transforms_train.json,
     8-bit RGBA PNGs from the standard library's zlib with alpha 0 where
     the render is exactly black, points3d.ply), loaded lazily and eagerly:
     every image equal to the written bytes / 255 composited onto the
     background bit for bit, the split at max_time 0.8 18 train / 5 test,
     the PNG decoder named (native or PIL) and its host ms per view; then
     in this process cli.train (the dnerf preset, max_time 0.8, a schedule
     compressed to 600 iterations through train.py's own flags: cli_argv)
     with every stage run, n_dropped 0 on every instance stream, the test
     PSNR rising from the first report to the last, kernels #1-#7
     launched, ms per iteration per stage and the share of iterations
     that found their image not decoded yet; cli.eval --render_video
     --render_train (results.json with a finite PSNR, ms per view, the
     forward kernel equal to its plain version bit for bit on the last
     render's stream); cli.train_gcn --metrics --predict_more (the GCN
     checkpoint, the predicted frames' metrics, ms per predicted frame);
     cli.show as a `python -m` subprocess; load_ply_params of the PLY
     cli.train wrote equal bit for bit to the saved state's live rows;
     evaluate_dirs on cli.eval's renders and ground truths (the card's
     machine has no imageio); the three CLIs' launches added
     to rows stack, expand, interleave, blend_fwd, blend_bwd and
     scatter_add_sorted;
 21b. the HyperNeRF presets (hypernerf_phases): phase 18's scene rendered
     at 960x540 (a HyperNeRF interp capture's rgb/2x) and written as a
     HyperNeRF tree (data/hypernerf.py:write_hypernerf), loaded back with
     every image equal to the written bytes / 255 and the every-4th-frame
     split; cli.train --preset chickchicken --batch 2 (time decay;
     Trainer.train_batch) and cli.eval, then an in-process `lemon`
     Trainer with step opacity gated on from u: each through stages 0-3
     of a schedule compressed onto 600 iterations, n_dropped == 0 on
     every stream, the test PSNR rising, a stage-3 step (the batched one
     for chickchicken) run twice bit-identical, ms per iteration per
     stage; the launches added to the kernels line's rows;
 22. the multi-GPU path on one card ("sharded", sharded_phases): phase
     6's model and first view rendered as 4 bands of 13 tile rows and 50
     of one row, stitched to the whole render bit for bit where no capped
     rect reaches (n_dropped 0, each band's slots equal to
     probe_slot_need(tile_band=...), #1 equal to its plain version on a
     band's stream); an L1 loss backpropagated band by band against the
     whole frame's (#6 equal to its plain version on a band); the sharded
     step at world size 1 (nccl, mesh 1 x 1) at stages 1 and 2 equal to
     make_train_step bit for bit, twice bit-identical, ms beside it; where
     gloo takes CUDA tensors, 4 ranks of this script on the card: one
     sharded step (1 x 4, 2 x 2) against the single and batched steps, and
     Trainer(n_devices=4, n_data=1 and 2) over 4 warm-up and 4 stage-1
     iterations of phase 18's scene against the single-device Trainer, the
     ranks' states bit-identical (sharded_phases gives the bounds); the
     launches added to the kernels line's rows;
 23. several iterations a call ("multi", multi_phases):
     make_train_step_multi (K = 4) from the training cell's stage-1 state
     across densify_until_iter and its stage-2 state at the transition,
     classic and under GPT_BLEND_SMT=4, equal to 4 single steps bit for
     bit, and again under torch.cuda.set_sync_debug_mode("error") (the
     detector first shown to catch a host-to-device copy); ms an
     iteration of the multi call and of the single calls with their
     device-busy shares; Trainer(steps_per_call=4) against
     steps_per_call=1 on phase 18's scene over 88 iterations (densify
     events, the 1 -> 2 transition): state digests equal, and the chunked
     run's profiler window (cfg.train.profile_*) written as a Chrome
     trace that holds the hand-written kernels, its device-busy share
     printed; the launches added to the kernels line's rows;
 24. a `kernels` JSON line, the nvidia-smi line, and as the last line
     {"ok": true, "device": {...}}.

Usage:
  python3 chip_smoke.py                # on a machine with one CUDA card
  python3 chip_smoke.py --rehearse     # the same phases on the CPU at 2k
                                       # Gaussians and 128x128 (3 steps a
                                       # stage; the Trainer at 64x64 over
                                       # 140 iterations, the GCN phase
                                       # on its state, the CLIs at the
                                       # `test` preset over 60), plain
                                       # versions, no result line
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
    "scatter_add_sorted_brick":
        "gaussianprediction_tpu/ops/hashgrid_pallas.py:49",
    "blend_fwd_flat": "gaussianprediction_tpu/ops/rasterize_pallas.py:1458",
    "blend_bwd_flat": "gaussianprediction_tpu/ops/rasterize_pallas.py:1533",
    "blend_fwd_mt": "gaussianprediction_tpu/ops/rasterize_pallas.py:1038",
    "blend_bwd_mt": "gaussianprediction_tpu/ops/rasterize_pallas.py:1155",
    "blend_fwd_smt": "gaussianprediction_tpu/ops/rasterize_pallas.py:895",
    "blend_bwd_smt": "gaussianprediction_tpu/ops/rasterize_pallas.py:681",
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
    "scatter_add_sorted_brick":
        "gaussianprediction_tpu_torch/kernels/csrc/scatter_add_sorted.cu",
    "blend_fwd_flat":
        "gaussianprediction_tpu_torch/kernels/csrc/blend_fwd_flat.cu",
    "blend_bwd_flat":
        "gaussianprediction_tpu_torch/kernels/csrc/blend_bwd_flat.cu",
    "blend_fwd_mt":
        "gaussianprediction_tpu_torch/kernels/csrc/blend_fwd_mt.cu",
    "blend_bwd_mt":
        "gaussianprediction_tpu_torch/kernels/csrc/blend_bwd_mt.cu",
    "blend_fwd_smt":
        "gaussianprediction_tpu_torch/kernels/csrc/blend_fwd_smt.cu",
    "blend_bwd_smt":
        "gaussianprediction_tpu_torch/kernels/csrc/blend_bwd_smt.cu",
}
# the __global__ functions of each kernel, as torch.profiler names them
# (the scan is three: block sums, their scan, the block scans; the table
# gradient two: the tiles, the runs that cross tiles)
SCAN_FUNCS = ("block_sums_kernel", "scan_sums_kernel", "scan_rows_kernel")
DEVICE_NAMES = {
    "stack": ("stack_rows_kernel",),
    "expand": ("expand_rows_kernel",),
    "interleave": ("interleave_rows_kernel",),
    "blend_fwd": ("blend_fwd_kernel",),
    "blend_bwd": ("blend_bwd_kernel",),
    "cumsum_channels": SCAN_FUNCS,
    "cumsum_rows": SCAN_FUNCS,
    "scatter_add_sorted": ("scatter_tiles_kernel", "scatter_carries_kernel"),
    "scatter_add_sorted_brick": ("scatter_tiles_kernel",
                                 "scatter_carries_kernel"),
    "blend_fwd_flat": ("blend_fwd_flat_kernel",),
    "blend_bwd_flat": ("blend_bwd_flat_kernel",),
    "blend_fwd_mt": ("blend_fwd_mt_kernel",),
    "blend_bwd_mt": ("blend_bwd_mt_kernel",),
    "blend_fwd_smt": ("blend_fwd_smt_kernel",),
    "blend_bwd_smt": ("blend_bwd_smt_kernel",),
}
# the blend variants' environments (GPT_BLEND_*): the kernels line carries
# FLAT, MT at TPB 4 and SMT at 4; TPB 3 and SMT 3 are checked on the same
# inputs
VARIANT_ENV = {
    "flat": {"GPT_BLEND_FLAT": "1"},
    "mt": {"GPT_BLEND_MT": "1", "GPT_BLEND_TPB": "4"},
    "mt3": {"GPT_BLEND_MT": "1", "GPT_BLEND_TPB": "3"},
    "smt": {"GPT_BLEND_SMT": "4"},
    "smt3": {"GPT_BLEND_SMT": "3"},
}
SMT_ENV = VARIANT_ENV["smt"]   # the Trainer phase's blend
FWD_KERNELS = ("stack", "expand", "interleave", "blend_fwd")
EPS32 = 2.0 ** -24
# the committed LPIPS goldens of tests/test_eval.py::TestLPIPSGolden
LPIPS_GOLDEN = (0.02952139638364315, 0.019956454634666443)
# the GCN phase's card-vs-CPU tolerances, in units of the largest |value|
# of each gradient leaf and of the rollout, or 4x the CPU's own f32 error
# against f64 where that is larger: the batch norms divide by
# sqrt(var + 1e-5) over a handful of windows, and keypoints that barely
# move give features of almost no variance there, so f32 roundoff grows
# (the CPU rehearsal's deepest xyz blocks: 8e-2 of a leaf's magnitude)
GCN_GRAD_TOL = 1e-3
GCN_ROLLOUT_TOL = 1e-4
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build")


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


def device_ms_of(fn, dev, reps: int):
    """Mean device ms per call of fn(): every device-side event of a
    torch.profiler window over `reps` calls after a warm-up, summed (the
    kernels, fills and memsets one call launches). None off the card."""
    if dev.type != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile as tprofile

    fn()
    sync(dev)
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        sync(dev)
    us = 0.0
    for e in prof.key_averages():
        if "CUDA" in str(getattr(e, "device_type", "")):
            t = getattr(e, "self_device_time_total", None)
            us += t if t is not None else getattr(e, "self_cuda_time_total",
                                                  0.0)
    return us / (reps * 1e3)


def device_ms_beside(kern, lib, funcs, dev, reps: int):
    """(kernel, library) mean device ms per call in ONE torch.profiler
    window: kern() and lib() called in turn `reps` times after a warm-up.
    The kernel's time is that of its __global__ functions `funcs`, the
    library call's that of every other device event of the window (the
    two compared with the same caches and clocks). (None, None) off the
    card."""
    if dev.type != "cuda":
        return None, None
    from torch.profiler import ProfilerActivity, profile as tprofile

    kern()
    lib()
    sync(dev)
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            kern()
            lib()
        sync(dev)
    k_us = l_us = 0.0
    for e in prof.key_averages():
        if "CUDA" not in str(getattr(e, "device_type", "")):
            continue
        t = getattr(e, "self_device_time_total", None)
        t = t if t is not None else getattr(e, "self_cuda_time_total", 0.0)
        if any(f in e.key for f in funcs):
            k_us += t
        else:
            l_us += t
    return k_us / (reps * 1e3), l_us / (reps * 1e3)


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
    last call of each), and what it returned; `note(name, args, out)`, when
    given, is called after every call (to read counts at rare events)."""

    def __init__(self, targets=None, note=None):
        from gaussianprediction_tpu_torch.ops import expand
        from gaussianprediction_tpu_torch.ops import rasterize_kernels as rk

        self.targets = targets or [
            (expand, "stack_rows"), (expand, "expand_emit"),
            (expand, "interleave_rows"), (rk, "rasterize_binned")]
        self.note = note
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
                if self.note is not None:
                    self.note(_name, a, self.out[_name])
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
    lib = lambda: torch.stack(list(chans) + zeros)  # noqa: E731
    kern = lambda: E.stack_rows(chans, nch=nch)  # noqa: E731
    kdev, ldev = device_ms_beside(kern, lib, DEVICE_NAMES["stack"], dev,
                                  reps)
    res["stack"] = dict(
        max_abs_err=float((out - ref).abs().max()),
        ms=time_ms(kern, dev, reps),
        plain_ms=time_ms(lambda: E.stack_rows_plain(chans, nch), dev, reps),
        library_ms=time_ms(lib, dev, reps),
        kernel_device_ms=kdev, library_device_ms=ldev,
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
    lib = lambda: torch.stack(list(chans) + [valid] + zeros)  # noqa: E731
    kern = lambda: E.interleave_rows(chans)  # noqa: E731
    kdev, ldev = device_ms_beside(kern, lib, DEVICE_NAMES["interleave"], dev,
                                  reps)
    res["interleave"] = dict(
        max_abs_err=float((out - ref).abs().max()),
        ms=time_ms(kern, dev, reps),
        plain_ms=time_ms(lambda: E.interleave_rows_plain(chans), dev, reps),
        library_ms=time_ms(lib, dev, reps),
        kernel_device_ms=kdev, library_device_ms=ldev,
        bytes=(11 + 16) * n * 4, ops=0,
    )

    # forward blend
    (inst, ts, te, gx, gy, with_tidx), _ = args_by_name["rasterize_binned"]
    out = rk.rasterize_binned(inst, ts, te, gx, gy, with_tidx)
    t0 = time.perf_counter()
    ref = rk.rasterize_binned_plain(inst, ts, te, gx, gy, with_tidx)
    sync(dev)
    plain_ms = (time.perf_counter() - t0) * 1e3
    # the work counts and the cull share from a second, untimed run: the
    # cull model is not the plain version's cost
    aux = {}
    rk.rasterize_binned_plain(inst, ts, te, gx, gy, with_tidx, aux=aux)
    same = bits_equal(out, ref)
    err_max = float((out - ref).abs().max())
    log(f"blend: equal to its plain version bit for bit {same} (max |err| "
        f"{err_max:.3e})  pairs {aux['pairs']}  flops {aux['flops']}  "
        f"instances read {aux['instances']}  {cull_share(aux)}")
    if not same:
        raise AssertionError("blend kernel disagrees with its plain version")
    T = gx * gy
    res["blend_fwd"] = dict(
        max_abs_err=err_max,
        ms=time_ms(lambda: rk.rasterize_binned(inst, ts, te, gx, gy,
                                               with_tidx), dev, reps),
        plain_ms=plain_ms, library_ms=None,
        bytes=aux["instances"] * 12 * 4 + 2 * T * 4 + T * rk.PIX * 8 * 4,
        ops=aux["flops"],
    )
    add_bounds(res)
    return res


def variant_fwd_plain(v, fwd_args, aux: dict | None = None):
    """The plain forward blend of variant v on fwd_args."""
    from gaussianprediction_tpu_torch.ops import blend_variants as BV
    inst, ts, te, gx, gy, with_tidx = fwd_args
    if v.kind == "flat":
        return BV.rasterize_binned_flat_plain(inst, ts, te, gx, gy,
                                              with_tidx, aux=aux)
    plain = BV.rasterize_binned_smt_plain if v.kind == "smt" else \
        BV.rasterize_binned_mt_plain
    return plain(inst, ts, te, gx, gy, v.tpb, with_tidx, aux=aux)


def cull_share(aux: dict) -> str:
    """The forward walk's cull on a plain run's aux: (warp, instance)
    pairs kept of those up to each warp's last live pixel."""
    return (f"warp pairs kept {aux['warp_pairs_kept']} of "
            f"{aux['warp_pairs']} (cull share "
            f"{aux['warp_pairs_kept'] / max(aux['warp_pairs'], 1):.4f})")


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
            f"library_ms {r['library_ms']}  profiler-window device ms: "
            f"kernel {r.get('kernel_device_ms')}, library "
            f"{r.get('library_device_ms')}")


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
            named=None, warmup: bool = True) -> dict:
    """Device time by kernel over `reps` calls of run() and the device's
    busy share of that window (torch.profiler; CUPTI). Only device-side
    events are summed: an operator's own row would count its kernels a
    second time. Returns each ported kernel's mean device ms per launch
    (the sum over its __global__ functions; None when not launched).
    named: {label: substrings}; prints the device ms per call of run() of
    the kernels whose names hold any of the substrings. warmup=False
    skips the call before the profiled ones (for a run() that must be
    called only once)."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    if warmup:
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


def wrapper_sums(dev) -> str:
    """The order of the pixel sums of what the backward wrappers return on
    `dev`: the kernels' on the card, the plain versions' default (torch's
    reduction) on the CPU of a rehearsal. The plain version it is held to
    bit for bit sums in that order."""
    return "kernel" if dev.type == "cuda" else "torch"


def bits_equal(a, b) -> bool:
    """Every bit equal (signed zeros too): f32 tensors or arrays."""
    if isinstance(a, np.ndarray):
        return a.shape == b.shape and np.array_equal(a.view(np.int32),
                                                     b.view(np.int32))
    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


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
    ref = rk.rasterize_binned_bwd_plain(inst, ts, te, gx, gy, dpix, aux=aux,
                                        sums=wrapper_sums(dev))
    sync(dev)
    plain_ms = (time.perf_counter() - t0) * 1e3
    same = bits_equal(a, ref)
    err_max = float((a - ref).abs().max())
    log(f"blend_bwd: bit-identical across 2 launches; equal to its plain "
        f"version bit for bit {same} (max |err| {err_max:.3e}); pairs "
        f"{aux['pairs']} flops {aux['flops']} instances read "
        f"{aux['instances']}")
    if a[10:].any() or not same:
        raise AssertionError("blend_bwd disagrees with its plain version")
    T = gx * gy
    res["blend_bwd"] = dict(
        max_abs_err=err_max,
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


class variant_env:
    """The environment variables of one blend variant, set for the block."""

    def __init__(self, env: dict):
        self.env = env

    def __enter__(self):
        self.old = {k: os.environ.get(k) for k in self.env}
        os.environ.update(self.env)
        return self

    def __exit__(self, *exc):
        for k, v in self.old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        return False


def step_ms(step, args, dev, n: int):
    """ms of n steps from the same state (CUDA events on the card, a host
    clock on the CPU); returns the list."""
    ms = []
    for _ in range(n):
        if dev.type == "cuda":
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            checked(step(*args), "timed step")
            e1.record()
            e1.synchronize()
            ms.append(e0.elapsed_time(e1))
        else:
            t0 = time.perf_counter()
            checked(step(*args), "timed step")
            ms.append((time.perf_counter() - t0) * 1e3)
    return ms


def variant_phases(cfg, dev, rstate, iteration, views, bg, renders,
                   fwd_args, ctx, rehearse: bool, reps: int):
    """Phase 'blend variants': the flat work-list (GPT_BLEND_FLAT),
    multi-tile (GPT_BLEND_MT, TPB 4 and 3) and sequential-tile
    (GPT_BLEND_SMT, 4 and 3) blends at the main path's width. Their kernels
    against the classic kernels (bit for bit) and their plain versions on
    the first view's stream and a stage-1 step's dpix; render_set of the
    views and a stage-1 step under FLAT, MT (TPB 4) and SMT (4) against the
    classic path, bit for bit; each path's ms beside the classic path's.
    Returns (res, launches, device_ms) for the kernels line."""
    from gaussianprediction_tpu_torch import kernels
    from gaussianprediction_tpu_torch.eval.render import (
        make_render_fn, render_set,
    )
    from gaussianprediction_tpu_torch.ops import blend_variants as BV
    from gaussianprediction_tpu_torch.ops import rasterize_kernels as rk
    from gaussianprediction_tpu_torch.train import optimizer as O
    from gaussianprediction_tpu_torch.train.step import make_train_step

    tcfg, state, opt = ctx["cfg"], ctx["state"], ctx["opt"]
    cam, gt, t, bg_t, gen = ctx["cam"], ctx["gt"], ctx["t"], ctx["bg_t"], \
        ctx["gen"]
    size = gt.shape[0]
    it1 = 20_000
    step1 = make_train_step(tcfg, 1, size, size, ctx["extent"],
                            tcfg.model.sh_degree, 50, bg_t)
    step_args = lambda: (state, opt, cam, gt, t, it1, gen())  # noqa: E731
    nsteps = 3 if rehearse else 6

    with Phase("blend variants: a classic stage-1 step, its dpix captured"):
        with Capture([(rk, "rasterize_binned_bwd")]) as cap:
            ref_step = checked(step1(*step_args()), "classic step")
        sync(dev)
        (inst, ts, te, gx, gy, dpix), _ = cap.args["rasterize_binned_bwd"]
        inst = inst.detach()
        finst, fts, fte, fgx, fgy, with_tidx = fwd_args
        out_c = rk.rasterize_binned(finst, fts, fte, fgx, fgy, with_tidx,
                                    rk.CLASSIC)
        d_c = rk.rasterize_binned_bwd(inst, ts, te, gx, gy, dpix,
                                      variant=rk.CLASSIC)
        # the step's forward input (the instances are the backward's)
        auxs = {}
        ref_s = rk.rasterize_binned_plain(inst, ts, te, gx, gy, True,
                                          aux=auxs)
        same = bits_equal(rk.rasterize_binned(inst, ts, te, gx, gy, True,
                                              rk.CLASSIC), ref_s)
        sync(dev)
        log(f"stage-1 step's forward input: classic kernel equal to the "
            f"plain version bit for bit {same}; {cull_share(auxs)}")
        if not same:
            raise AssertionError("blend_fwd disagrees on the step's input")

    res = {}
    for key, env in VARIANT_ENV.items():
        with Phase(f"blend variants: {key} kernels vs classic and plain "
                   "versions"), torch.no_grad():
            with variant_env(env):
                v = rk.blend_variant()
            kind = v.kind
            a, a2 = (rk.rasterize_binned(finst, fts, fte, fgx, fgy,
                                         with_tidx, v) for _ in range(2))
            da, da2 = (rk.rasterize_binned_bwd(inst, ts, te, gx, gy, dpix,
                                               variant=v) for _ in range(2))
            sync(dev)
            auxb = {}
            t0 = time.perf_counter()
            ref = variant_fwd_plain(v, fwd_args)
            sync(dev)
            t1 = time.perf_counter()
            if kind == "flat":
                dref = BV.rasterize_binned_bwd_flat_plain(
                    inst, ts, te, gx, gy, dpix, aux=auxb,
                    sums=wrapper_sums(dev))
            elif kind == "smt":
                dref = BV.rasterize_binned_bwd_smt_plain(
                    inst, ts, te, gx, gy, v.tpb, dpix, aux=auxb,
                    sums=wrapper_sums(dev))
            else:
                dref = BV.rasterize_binned_bwd_mt_plain(
                    inst, ts, te, gx, gy, v.tpb, dpix, aux=auxb,
                    sums=wrapper_sums(dev))
            sync(dev)
            t2 = time.perf_counter()
            err_max = float((da - dref).abs().max())
            aux = {}        # the work counts, untimed (as in check_kernels)
            variant_fwd_plain(v, fwd_args, aux)
            ok = dict(fwd_classic=bits_equal(a, out_c),
                      fwd_twice=bits_equal(a2, a),
                      fwd_plain=bits_equal(a, ref),
                      fwd_step_plain=bits_equal(rk.rasterize_binned(
                          inst, ts, te, gx, gy, True, v), ref_s),
                      bwd_classic=bits_equal(da, d_c),
                      bwd_twice=bits_equal(da2, da),
                      bwd_plain=bits_equal(da, dref))
            log(f"{key} ({v}): bit for bit {ok}; bwd vs plain max |err| "
                f"{err_max:.3e}; pairs {aux['pairs']} / {auxb['pairs']}")
            if not all(ok.values()) or da[10:].any():
                raise AssertionError(f"{key} blend disagrees")
            if key in ("mt3", "smt3"):
                continue
            T, Tb = fgx * fgy, gx * gy
            lst = lstb = 0          # the work list read by the kernels
            if kind == "flat":
                lst = 4 * (int(BV.worklist(finst, fts, fte)[3]) + T)
                lstb = 4 * (int(BV.worklist(inst, ts, te)[3]) + Tb)
            res[f"blend_fwd_{kind}"] = dict(
                max_abs_err=float((a - ref).abs().max()),
                ms=time_ms(lambda: rk.rasterize_binned(
                    finst, fts, fte, fgx, fgy, with_tidx, v), dev, reps),
                plain_ms=(t1 - t0) * 1e3, library_ms=None,
                bytes=aux["instances"] * 12 * 4 + 2 * T * 4
                + T * rk.PIX * 8 * 4 + lst, ops=aux["flops"])
            res[f"blend_bwd_{kind}"] = dict(
                max_abs_err=err_max,
                ms=time_ms(lambda: rk.rasterize_binned_bwd(
                    inst, ts, te, gx, gy, dpix, variant=v), dev, reps),
                plain_ms=(t2 - t1) * 1e3, library_ms=None,
                bytes=auxb["instances"] * (12 + 10) * 4 + 2 * Tb * 4
                + Tb * rk.PIX * 5 * 4 + lstb, ops=auxb["flops"])
    add_bounds(res)

    launches, device_ms = {}, {}
    rfn = make_render_fn(rstate, cfg, iteration, views[0].width,
                         views[0].height, bg, cfg.model.sh_degree)
    cam0 = views[0].to_device_dict(dev)
    t0v = torch.tensor(views[0].time, dtype=torch.float32, device=dev)
    for key, env in (("classic", {}), ("flat", VARIANT_ENV["flat"]),
                     ("mt", VARIANT_ENV["mt"]), ("smt", VARIANT_ENV["smt"])):
        with Phase(f"blend variants: render_set and stage-1 steps, {key}"):
            with variant_env(env):
                kernels.reset_launch_counts()
                stats = {}
                vr, _, _ = render_set(rstate, cfg, iteration, views, bg,
                                      stats=stats)
                sync(dev)
                got = dict(kernels.launch_counts)
                kernels.reset_launch_counts()
                vstep = checked(step1(*step_args()), f"{key} step")
                sync(dev)
                gots = dict(kernels.launch_counts)
                ms = step_ms(step1, step_args(), dev, nsteps)
                same_img = all(bits_equal(x, y) for x, y in zip(vr, renders))
                same_step = bits_equal(vstep[2]["loss"], ref_step[2]["loss"]) \
                    and all(bits_equal(x, y) for x, y in zip(
                        O.tree_leaves(vstep[0].params),
                        O.tree_leaves(ref_step[0].params)))
                log(f"{key}: render_set ms per view {stats['ms']} (launches "
                    f"{got}); images equal to the classic render_set bit for "
                    f"bit {same_img}; stage-1 step loss "
                    f"{float(vstep[2]['loss']):.6f}, loss and params equal "
                    f"to the classic step bit for bit {same_step} (launches "
                    f"{gots}); ms per step from the same state "
                    f"{[round(x, 3) for x in ms]}, median of steps 2-{nsteps}"
                    f" {float(np.median(ms[1:])):.3f}")
                if not (same_img and same_step):
                    raise AssertionError(f"{key}: the path differs from the "
                                         "classic path")
                if key == "classic":
                    continue
                fk, bk = f"blend_fwd_{key}", f"blend_bwd_{key}"
                launches[fk], launches[bk] = got.get(fk, 0), gots.get(bk, 0)
                if not rehearse and not (
                        got.get(fk, 0) == len(views) and gots.get(bk) == 1
                        and not got.get("blend_fwd")
                        and not gots.get("blend_bwd")):
                    raise AssertionError(f"{key}: the path did not run its "
                                         "kernels")
                dm = profile(lambda: rfn(cam0, t0v), dev, f"one view, {key}",
                             top=4)
                device_ms[fk] = dm[fk]
                dm = profile(lambda: step1(*step_args()), dev,
                             f"one stage-1 step, {key}", top=4)
                device_ms[bk] = dm[bk]
                log(f"  {fk} device ms per launch {device_ms[fk]}; {bk} "
                    f"{device_ms[bk]}")
    return res, launches, device_ms


def check_scatter_kernel(cap, dev, reps: int, what: str):
    """scatter_add_sorted on a captured table-gradient stream: two launches
    bit-identical, bit for bit its plain version on the CPU (the kernel's
    order: runs cut into tiles, pieces in stream order, pieces in tile
    order), within 64 * 2^-24 * Σ|contributions| of index_add_ on the card
    in every slot, slots that receive nothing exactly 0; event ms and the
    device ms of a profiler window of the kernel and of index_add_."""
    from gaussianprediction_tpu_torch.ops import hashgrid_kernels as HK

    (keys, vals, n_slots), _ = cap.args["scatter_add_sorted"]
    F, M = vals.shape
    a = HK.scatter_add_sorted(keys, vals, n_slots)
    b = HK.scatter_add_sorted(keys, vals, n_slots)
    sync(dev)
    if not torch.equal(a, b):
        raise AssertionError(f"scatter_add_sorted ({what}): two launches "
                             f"differ")
    t0 = time.perf_counter()
    ref = HK.scatter_add_sorted_plain(keys.cpu(), vals.cpu(), n_slots)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    same = torch.equal(a.cpu(), ref)
    err = float((a.cpu() - ref).abs().max())
    lib = lambda: torch.zeros((F, n_slots), device=dev).index_add_(  # noqa
        1, keys, vals)
    absum = torch.zeros((F, n_slots), device=dev).index_add_(1, keys,
                                                             vals.abs())
    diff = (a - lib()).abs()
    n_out = int((diff > 64 * EPS32 * absum).sum())
    lib_err = float(diff.max())
    hit = torch.zeros(n_slots, dtype=torch.bool, device=dev)
    hit[keys.to(torch.int64)] = True
    stray = int(a[:, ~hit].ne(0).sum())
    runs = torch.unique_consecutive(keys, return_counts=True)[1]
    log(f"scatter_add_sorted ({what}): M {M}, F {F}, slots {n_slots} "
        f"({int((~hit).sum())} empty), {runs.shape[0]} runs, the longest "
        f"{int(runs.max())}; bit-identical across 2 launches; equal to the "
        f"CPU plain version bit for bit {same} (max |err| {err:.3e}, CPU "
        f"{cpu_ms:.1f} ms); {n_out} slots beyond 64 * 2^-24 * sum|v| of "
        f"index_add_ (max |diff| {lib_err:.3e}); {stray} empty slots not 0")
    if not same or n_out or stray:
        raise AssertionError(f"scatter_add_sorted ({what}) disagrees with "
                             f"its plain version")
    kern = lambda: HK.scatter_add_sorted(keys, vals, n_slots)  # noqa: E731
    r = dict(
        max_abs_err=err,
        ms=time_ms(kern, dev, reps),
        kernel_device_ms=device_ms_of(kern, dev, reps),
        plain_ms=time_ms(lambda: HK.scatter_add_sorted_plain(
            keys, vals, n_slots), dev, reps),
        library_ms=time_ms(lib, dev, reps),
        library_device_ms=device_ms_of(lib, dev, reps),
        # keys and values read once, the table written once; F adds each
        bytes=M * (4 + 4 * F) + F * n_slots * 4, ops=M * F,
    )
    res = {"scatter_add_sorted": r}
    add_bounds(res)
    log(f"scatter_add_sorted ({what}): device ms of a profiler window "
        f"{r['kernel_device_ms']} (index_add_ {r['library_device_ms']})")
    return res


def stage23_phases(ctx, dev, seed: int, rehearse: bool, reps: int):
    """Phases 13-17 on the trained stage-1 state: the 1->2 transition,
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
        pre = state
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
        # the encoders phase starts from the same stage-1 state
        ctx.update(s2_cfg=cfg, s2_pre=pre, s2_trans=state, s2_opt=opt)

    with Phase("first stage-2 step: scatter_add_sorted vs plain version"):
        with Capture([(HK, "scatter_add_sorted")]) as cap:
            state, opt, m = checked(step2(state, opt, cam, gt, t, it2,
                                          gen()), "first stage-2 step")
        sync(dev)
        log(f"first stage-2 step: loss {float(m['loss']):.6f}")
        with torch.no_grad():
            res = check_scatter_kernel(cap, dev, reps,
                                       "the first stage-2 step")

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


def encoder_phases(ctx, dev, seed: int, rehearse: bool, reps: int):
    """Phase 17b: the fourier and brick weight encoders at the dnerf width
    from phase 13's stage-1 state, beside the hash grid's: for each a
    seeded weight model, the 1->2 transition and 4 stage-2 steps (finite,
    n_dropped 0, a step run twice bit-identical, ms per step); #7 on the
    brick stream held to its plain version as in phase 14;
    distill_weight_init (20 steps) with each table encoder, the loss
    falling and a second run bit-identical; transition_diagnostics on phase
    13's transition state; the quality tool at the protocol's width
    (stage1 and hashgrid arms over 600 iterations) with the test PSNR
    rising. Returns (res, launches, device_ms): the brick stream's row of
    the kernels line, and the launches of the timed steps and the quality
    tool (counts set to 0 just before each, read just after) by row."""
    import copy
    import shutil
    from types import SimpleNamespace

    from gaussianprediction_tpu_torch import kernels
    from gaussianprediction_tpu_torch.models.gaussians import weight_model
    from gaussianprediction_tpu_torch.ops import hashgrid as HG
    from gaussianprediction_tpu_torch.ops import hashgrid_kernels as HK
    from gaussianprediction_tpu_torch.tools import quality_proxy as TQ
    from gaussianprediction_tpu_torch.train import optimizer as O
    from gaussianprediction_tpu_torch.train.diag import (
        transition_diagnostics,
    )
    from gaussianprediction_tpu_torch.train.loop import (
        distill_weight_init, stage_transition,
    )
    from gaussianprediction_tpu_torch.train.step import make_train_step

    base_cfg, pre, opt = ctx["s2_cfg"], ctx["s2_pre"], ctx["s2_opt"]
    cam, gt, t, bg_t, gen = ctx["cam"], ctx["gt"], ctx["t"], ctx["bg_t"], \
        ctx["gen"]
    size = gt.shape[0]
    it2 = base_cfg.train.second_stage_iteration + 1
    nsteps = 2 if rehearse else 4
    to = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    res, step_ms, trans = {}, {}, {}
    launches = {}   # this phase's launches, #7's brick stream on its row

    def add_launches(got, enc):
        for k, v in got.items():
            row = "scatter_add_sorted_brick" if (
                enc == "brick" and k == "scatter_add_sorted") else k
            launches[row] = launches.get(row, 0) + v

    with Phase("encoders: fourier and brick beside the hash grid, stage 2"):
        for enc in ("hashgrid", "fourier", "brick"):
            cfg = copy.deepcopy(base_cfg)
            cfg.model.weight_encoder = enc
            if rehearse:    # 2^12 bricks a hashed level, not 2^16, here
                cfg.model.hash_log2_Tb = 12
            tables, wmlp = weight_model(cfg, np.random.default_rng(seed + 7))
            params = {k: v for k, v in pre.params.items()
                      if k != "hash_tables"}
            params["weight_mlp"] = [{k: to(v) for k, v in layer.items()}
                                    for layer in wmlp]
            if tables is not None:
                params["hash_tables"] = {k: to(v) for k, v in tables.items()}
            st = pre.replace(params=params)
            st, op = stage_transition(st, O.init_adam(st.params), cfg, it2,
                                      generator=gen())
            if int(st.n_kpts()) != cfg.model.max_points:
                raise AssertionError(f"{enc}: the transition failed")
            trans[enc] = (cfg, st)
            step = make_train_step(cfg, 2, size, size, ctx["extent"],
                                   cfg.model.sh_degree, 50, bg_t)
            with Capture([(HK, "scatter_add_sorted")]) as cap:
                st, op, m = checked(step(st, op, cam, gt, t, it2, gen()),
                                    f"{enc}: first stage-2 step")
            sync(dev)
            if enc == "brick":
                (keys, vals, n_slots), _ = cap.args["scatter_add_sorted"]
                tb = sum(v.shape[0] for v in tables.values())
                log(f"brick: {tb} bricks of 64 cells x F "
                    f"{cfg.model.hash_features}: M {keys.shape[0]} "
                    f"contributions into {n_slots} cell slots "
                    f"({vals.numel()} values, {vals.shape[0] * n_slots} "
                    f"outputs; int32 limit {2 ** 31 - 1})")
                with torch.no_grad():
                    r = check_scatter_kernel(cap, dev, reps, "brick stream")
                res["scatter_add_sorted_brick"] = \
                    r["scatter_add_sorted"]
            elif "scatter_add_sorted" in cap.args and enc == "fourier":
                raise AssertionError("fourier: the table gradient ran")
            kernels.reset_launch_counts()
            ms = []
            for k in range(nsteps):
                if dev.type == "cuda":
                    e0 = torch.cuda.Event(enable_timing=True)
                    e1 = torch.cuda.Event(enable_timing=True)
                    e0.record()
                    out = step(st, op, cam, gt, t, it2 + 1 + k, gen())
                    e1.record()
                    e1.synchronize()
                    ms.append(e0.elapsed_time(e1))
                else:
                    t0 = time.perf_counter()
                    out = step(st, op, cam, gt, t, it2 + 1 + k, gen())
                    ms.append((time.perf_counter() - t0) * 1e3)
                st, op, m = checked(out, f"{enc}: stage-2 step {k}")
            sync(dev)
            got = dict(kernels.launch_counts)
            want = nsteps if enc != "fourier" else 0
            if not rehearse and got.get("scatter_add_sorted", 0) != want:
                raise AssertionError(f"{enc}: scatter_add_sorted launched "
                                     f"{got.get('scatter_add_sorted', 0)} "
                                     f"times in {nsteps} steps")
            add_launches(got, enc)
            run = lambda: step(st, op, cam, gt, t, it2 + 9, gen())  # noqa
            a, b = run(), run()
            same = torch.equal(a[2]["loss"], b[2]["loss"]) and all(
                torch.equal(x, y) for x, y in zip(
                    O.tree_leaves(a[0].params), O.tree_leaves(b[0].params)))
            step_ms[enc] = float(np.median(ms[1:]))
            log(f"{enc}: stage-2 loss {float(m['loss']):.6f}, ms per step "
                f"{[round(x, 3) for x in ms]}; one step run twice "
                f"identical {same}; launches {got}")
            if not same:
                raise AssertionError(f"{enc}: a step run twice differs; "
                                     f"first op that differs: "
                                     f"{diagnose_nondeterminism(run)}")
        log(f"stage-2 ms per step (median of steps 2-{nsteps}): hashgrid "
            f"{step_ms['hashgrid']:.3f}, fourier {step_ms['fourier']:.3f}, "
            f"brick {step_ms['brick']:.3f}")

    with Phase("distill_weight_init (20 steps, hashgrid and brick)"):
        n_d = 3 if rehearse else 20
        for enc in ("hashgrid", "brick"):
            cfg, st = trans[enc]
            t0 = time.perf_counter()
            a, la = distill_weight_init(st, cfg, n_d)
            sync(dev)
            d_ms = (time.perf_counter() - t0) * 1e3 / n_d
            b, lb = distill_weight_init(st, cfg, n_d)
            same = torch.equal(la, lb) and all(
                torch.equal(x, y) for x, y in zip(O.tree_leaves(a.params),
                                                  O.tree_leaves(b.params)))
            log(f"distill ({enc}): loss {float(la[0]):.4e} -> "
                f"{float(la[-1]):.4e}, {d_ms:.2f} ms a step; a second run "
                f"bit-identical {same}")
            if not (float(la[-1]) < float(la[0]) and same
                    and finite_tree(a.params)):
                raise AssertionError(f"distill ({enc}) failed")

    with Phase("transition_diagnostics (phase 13's transition state)"):
        cfg = ctx["s2_cfg"]
        view = SimpleNamespace(time=float(t))
        shim = SimpleNamespace(
            cfg=cfg, state=ctx["s2_trans"], bg=np.zeros(3, np.float32),
            width=size, height=size,
            scene=SimpleNamespace(test_cameras=[view]),
            _view=lambda c: (cam, t, gt))
        diag = transition_diagnostics(shim)
        log(f"transition diagnostics: {json.dumps(diag)}")
        vals = [v for k, v in diag.items() if k not in ("views", "per_time")]
        vals += [x for v in diag["views"] for x in v.values()]
        vals += [x for e in diag["per_time"] for x in e.values()]
        if not np.isfinite(vals).all():
            raise AssertionError("transition diagnostics: not finite")

    with Phase("quality tool at the protocol's width (stage1, hashgrid)"):
        out = os.path.join(BUILD_DIR, "gpt_quality_smoke")
        shutil.rmtree(out, ignore_errors=True)
        argv = ["--out", out, "--arms", "stage1", "hashgrid"]
        argv += ["--cpu-tiny"] if rehearse else ["--steps", "600"]
        old = os.environ.get("GPT_FORCE_CPU")
        if rehearse:
            os.environ["GPT_FORCE_CPU"] = "1"
        kernels.reset_launch_counts()
        try:
            q = TQ.main(argv)
            sync(dev)
            add_launches(dict(kernels.launch_counts), "hashgrid")
        finally:
            if old is None:
                os.environ.pop("GPT_FORCE_CPU", None)
            else:
                os.environ["GPT_FORCE_CPU"] = old
        for arm in ("stage1", "hashgrid"):
            with open(os.path.join(out, arm, "history.json")) as f:
                ev = [h["eval"]["test_psnr"] for h in json.load(f)
                      if "eval" in h]
            e = q["arms"][arm]
            log(f"quality tool {arm}: test PSNR at the reports "
                f"{[round(x, 3) for x in ev]} -> {e['test_psnr']:.3f}, wall "
                f"{e['wall_s']} s, ms per iteration {e['ms_per_iter']}")
            # the rehearsal's 30 iterations are too few to show it: there
            # it is printed only
            if not (len(ev) >= 2 and ev[-1] > ev[0]
                    and np.isfinite(e["test_psnr"])) and not rehearse:
                raise AssertionError(f"quality tool {arm}: the test PSNR "
                                     f"did not rise")
        shutil.rmtree(out, ignore_errors=True)
    log(f"encoders phase (the steps timed and the quality tool): launches "
        f"{launches}")
    dms = {"scatter_add_sorted_brick":
           res["scatter_add_sorted_brick"]["kernel_device_ms"]}
    return res, launches, dms


def trainer_schedule(cfg, u: int, model_path: str):
    """The dnerf recipe's events compressed onto 7u iterations through the
    config fields train.py's flags set: stage 1 from u; densify every u
    after u through 4u (the last capacity re-probe sees the footprints
    regrown after the reset); an opacity reset at 3u; stage 2 from 4u + 1, stage
    3 from 5.5u + 1; keypoint growth every u/2 strictly between 4.2u and
    5.2u; reports at 4u and 7u, a checkpoint at 6u, the PLY at 7u. The
    learning-rate decay (position_lr_max_steps, 40,000 of the recipe's
    60,000 iterations) is scaled with it, as tools/quality_proxy.py scales
    it: at the recipe's 40,000 the deform MLP enters stage 3 with its rate
    decayed 500-fold, and a fresh Adam at the undecayed rate throws the
    Gaussians out of view within 100 iterations."""
    t, o = cfg.train, cfg.opt
    o.iterations = 7 * u
    o.position_lr_max_steps = 7 * u * 40_000 // 60_000
    t.jointly_iteration = u
    o.densify_from_iter = o.densification_interval = u
    o.densify_until_iter = 4 * u + 1    # the events at 2u, 3u and 4u
    o.opacity_reset_interval = 3 * u
    t.second_stage_iteration, t.third_stage_iteration = 4 * u, 11 * u // 2
    t.adaptive_from_iter, t.adaptive_end_iter = u // 5, 6 * u // 5
    t.adaptive_interval = u // 2
    t.test_iterations, t.checkpoint_iterations = (4 * u, 7 * u), (6 * u,)
    t.save_iterations = (7 * u,)
    cfg.model_path = model_path


def trainer_phases(dev, seed: int, rehearse: bool, reps: int):
    """Phase 'Trainer': the port's training loop at the dnerf preset's full
    width on a synthetic dynamic scene, under GPT_BLEND_SMT=4, through
    every stage and host event of a compressed schedule (trainer_schedule);
    then a second Trainer resumed from the checkpoint under the classic
    blend, held to the first run's final parameters. Returns the first
    Trainer (its final stage-3 state) and the scene."""
    import copy
    import shutil
    import tempfile

    from gaussianprediction_tpu_torch.config import get_preset
    from gaussianprediction_tpu_torch.data.scene import (
        Scene, synthetic_scene_info,
    )
    from gaussianprediction_tpu_torch.train import loop as L
    from gaussianprediction_tpu_torch.train import optimizer as O

    u = 20 if rehearse else 100
    size, n_pts = (64, 300) if rehearse else (800, 100_000)
    cfg = get_preset("dnerf")
    if rehearse:
        cfg.model.max_gaussian_size = cfg.model.capacity = 4_096
    tmp = tempfile.mkdtemp(prefix="gpt_trainer_")
    trainer_schedule(cfg, u, tmp)
    cfg0 = copy.deepcopy(cfg)
    try:
        with Phase("Trainer: synthetic dynamic scene"):
            info = synthetic_scene_info(n_points=n_pts, n_cams=20, n_test=3,
                                        width=size, height=size,
                                        dynamic=True, seed=seed, device=dev)
            sync(dev)
            log(f"scene: {n_pts} ground-truth Gaussians, "
                f"{len(info.train_cameras)} train and "
                f"{len(info.test_cameras)} test views at {size}x{size}")
        with Phase(f"Trainer: {7 * u} iterations under GPT_BLEND_SMT=4"), \
                variant_env(SMT_ENV):
            res = run_trainer(cfg, info, dev, seed, u, rehearse)
        with Phase("Trainer: scatter_add_sorted on a stage-2 iteration's "
                   "stream"), torch.no_grad():
            check_scatter_kernel(res.pop("scatter"), dev, reps,
                                 "a stage-2 Trainer iteration")
        with Phase("Trainer: resumed from the checkpoint under the classic "
                   "blend"):
            tr = res["trainer"]
            cfg2 = copy.deepcopy(cfg0)
            cfg2.model_path = ""
            cfg2.train.test_iterations = ()
            scene2 = Scene(info, seed=seed)
            for _ in range(6 * u):      # the cameras the first run drew
                scene2.next_train_camera()
            tr2 = L.Trainer(cfg2, scene2, seed=seed, device=dev, quiet=True)
            tr2.load_checkpoint(os.path.join(tmp, f"chkpnt{6 * u}.npz"))
            mult2 = float(cfg2.model.capacity_multiplier)
            tr2.run()
            sync(dev)
            a = O.tree_leaves(tr.state.params)
            b = O.tree_leaves(tr2.state.params)
            same = all(bits_equal(x, y) for x, y in zip(a, b)) and \
                torch.equal(tr.state.alive, tr2.state.alive) and \
                torch.equal(tr.state.kpt_alive, tr2.state.kpt_alive)
            worst = max(float((x - y).abs().max()) /
                        max(float(x.abs().max()), 1e-30)
                        for x, y in zip(a, b))
            log(f"resume: capacity multiplier held at {6 * u} "
                f"{res['mult_at_ckpt']}, chosen by the load re-probe "
                f"{mult2}; final params of the resumed classic run equal "
                f"to the SMT run's bit for bit {same}; largest difference "
                f"{worst:.3e} of a leaf's max |value|")
            if mult2 == res["mult_at_ckpt"]:
                if not same:
                    raise AssertionError("the resumed run differs")
            elif not worst <= 1e-5:
                raise AssertionError("the resumed run differs beyond 1e-5")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return res["trainer"], info


def run_trainer(cfg, info, dev, seed: int, u: int, rehearse: bool):
    """The first Trainer run of trainer_phases, with every check of its
    events, outputs and quality."""
    from gaussianprediction_tpu_torch import kernels
    from gaussianprediction_tpu_torch.data.scene import Scene
    from gaussianprediction_tpu_torch.ops import hashgrid_kernels as HK
    from gaussianprediction_tpu_torch.ops import instance_stream as IS
    from gaussianprediction_tpu_torch.train import densify as DN
    from gaussianprediction_tpu_torch.train import loop as L
    from gaussianprediction_tpu_torch.utils.tb_writer import read_events

    tr = L.Trainer(cfg, Scene(info, seed=seed), seed=seed, device=dev,
                   log_every=u // 4)
    ev = {"densify": [], "prune": [], "reset": 0, "grow": [],
          "transition": [], "probe": []}
    streams = []     # (n_dropped, n_total, capacity) of every stream built

    def note(name, a, out):
        if name == "build_instances_fwd":   # every stream
            st = out if isinstance(out, IS.InstanceStream) else out[0]
            streams.append((st.n_dropped, st.n_total, a[6]))
        elif name == "densify_and_prune_clone_split":
            ev["densify"].append((int(a[0].n_alive()),
                                  int(out[0].n_alive())))
        elif name == "prune":
            ev["prune"].append((int(a[0].n_alive()), int(out.n_alive())))
        elif name == "reset_opacity":
            ev["reset"] += 1
        elif name == "grow_keypoints_from_grads":
            ev["grow"].append((int(a[0].n_kpts()), int(out[0].n_kpts())))
        elif name == "stage_transition":
            ev["transition"].append((a[3], int(out[0].n_kpts())))

    orig_probe = tr._auto_capacity

    def probe(reason, **k):
        orig_probe(reason=reason, **k)
        ev["probe"].append((reason, float(cfg.model.capacity_multiplier)))

    tr._auto_capacity = probe
    r0 = tr.training_report(0)
    rec = []                  # (iteration, stage, start, end, loss, drops)
    mult_at = {}
    orig_one = tr.train_one
    prof_it = 4 * u + 3 * u // 10   # a stage-2 iteration
    cap_it = prof_it + 1            # one whose table-gradient stream is kept
    scatter = {}

    def timed_one(it):
        if dev.type == "cuda":
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
        else:
            e0 = time.perf_counter()
        if it == prof_it:
            box = {}
            profile(lambda: box.update(m=orig_one(it)), dev,
                    f"one stage-2 Trainer iteration ({it})", reps=1,
                    top=12, warmup=False)
            m = box["m"]
        elif it == cap_it:
            with Capture([(HK, "scatter_add_sorted")]) as c:
                m = orig_one(it)
            scatter["cap"] = c
        else:
            m = orig_one(it)
        if dev.type == "cuda":
            e1.record()
        else:
            e1 = time.perf_counter()
        rec.append((it, L.stage_of(cfg, it), e0, e1, m["loss"],
                    m["n_dropped"]))
        mult_at[it] = float(cfg.model.capacity_multiplier)
        return m

    tr.train_one = timed_one
    kernels.reset_launch_counts()
    with Capture([(DN, "densify_and_prune_clone_split"), (DN, "prune"),
                  (DN, "reset_opacity"), (DN, "grow_keypoints_from_grads"),
                  (L, "stage_transition"), (IS, "build_instances_fwd")],
                 note):
        hist = tr.run()
    sync(dev)
    launches = dict(kernels.launch_counts)

    # the run's own numbers
    def ms_of(r):
        return r[2].elapsed_time(r[3]) if dev.type == "cuda" \
            else (r[3] - r[2]) * 1e3

    per_stage = {}
    for r in rec:
        if r[0] != prof_it:
            per_stage.setdefault(r[1], []).append(ms_of(r))
    losses = {r[0]: float(r[4]) for r in rec}
    drops = [int(r[5]) for r in rec]
    reports = [h["eval"] for h in hist if "eval" in h]
    logged = [h for h in hist if "loss" in h]
    log(f"Trainer: launches {launches}")
    log("Trainer: ms per iteration (CUDA events around train_one), "
        + "; ".join(f"stage {k}: median {float(np.median(v)):.3f} over "
                    f"{len(v)}" for k, v in sorted(per_stage.items())))
    log(f"Trainer: events: transitions {ev['transition']}, densify "
        f"(alive before, after) {ev['densify']}, prune {ev['prune']}, "
        f"opacity resets {ev['reset']}, keypoint growth {ev['grow']}, "
        f"capacity probes {ev['probe']}; stage-3 Adam restarted "
        f"{tr._did_stage3}")
    # n_dropped counts slots past the capacity and the instances of rects
    # capped at 1024 tiles (a Gaussian covering over 41% of an 800² view);
    # kept = n_total - n_dropped stays below the capacity iff none is of
    # the first kind
    over = sum(int(n_tot - nd >= cap) for nd, n_tot, cap in streams)
    capped = [(int(nd), int(n_tot)) for nd, n_tot, _ in streams if int(nd)]
    worst = max((nd / n_tot for nd, n_tot in capped), default=0.0)
    log(f"Trainer: test PSNR before the run {r0['test_psnr']:.3f}, at the "
        f"reports {[(r['iter'], round(r['test_psnr'], 3)) for r in reports]}"
        f"; {len(streams)} instance streams: {over} filled the capacity, "
        f"{len(capped)} (training iterations {sum(1 for d in drops if d)}, "
        f"logged steps {sum(1 for h in logged if h['n_dropped'])}) capped a "
        f"rect at 1024 tiles, dropping at most {max(drops)} instances, "
        f"{worst:.2e} of the stream")
    s3 = [losses[i] for i in sorted(losses) if L.stage_of(cfg, i) == 3]
    first20, last20 = float(np.mean(s3[:20])), float(np.mean(s3[-20:]))
    log(f"Trainer: stage-3 loss, mean of the first 20 iterations {first20:.6f}"
        f", of the last 20 {last20:.6f}")

    # the checks
    s2, s3i = cfg.train.second_stage_iteration, cfg.train.third_stage_iteration
    fails = []
    if tr.iteration != 7 * u or \
            sorted(s for s, _ in tr._multi_steps) != [0, 1, 2, 3]:
        fails.append("not every stage ran")
    if [it for it, _ in ev["transition"] if it == s2 + 1] != [s2 + 1] or \
            dict(ev["transition"]).get(s2 + 1) != cfg.model.max_points:
        fails.append("the 1->2 transition")
    if not tr._did_stage3 or s3i + 1 not in losses:
        fails.append("the 2->3 transition")
    if not any(b > a for a, b in ev["densify"]):
        fails.append("densify")
    if not any(b < a for a, b in ev["prune"]):
        fails.append("prune")
    if ev["reset"] < 1:
        fails.append("opacity reset")
    if not any(r == "densify" for r, _ in ev["probe"]):
        fails.append("capacity re-probe")
    if not int(tr.state.n_kpts()) > cfg.model.max_points:
        fails.append("keypoint growth")
    if over or len(streams) < len(rec):
        fails.append("an instance stream filled its capacity")
    if worst > 1e-3:
        fails.append("rect capping dropped over 1e-3 of a stream")
    path = cfg.model_path
    (tb_file,) = os.listdir(os.path.join(path, "tb"))
    tags = {v["tag"] for e in read_events(os.path.join(path, "tb", tb_file))
            for v in e.get("values", [])}
    for f in ("history.json", f"chkpnt{6 * u}.npz",
              f"point_cloud/iteration_{7 * u}/point_cloud.ply"):
        if not os.path.exists(os.path.join(path, f)):
            fails.append(f"missing {f}")
    if not {"train/psnr", "test/loss_viewpoint_psnr",
            "scene/opacity_histogram"} <= tags:
        fails.append(f"tensorboard tags {sorted(tags)}")
    # training must be seen to work (on the card: the rehearsal's schedule
    # is too short to show it, so there it is printed only)
    quality = []
    at4 = [r for r in reports if r["iter"] == 4 * u]
    if not at4 or not at4[0]["test_psnr"] >= r0["test_psnr"] + 1.0:
        quality.append("test PSNR at the stage-2 start not 1 dB above the "
                       "initial state's")
    if not last20 < first20:
        quality.append("the stage-3 loss did not fall")
    log(f"Trainer: quality checks failed: {quality}")
    if not rehearse:
        fails += quality
        for k in ("stack", "expand", "interleave", "blend_fwd_smt",
                  "blend_bwd_smt", "scatter_add_sorted"):
            if not launches.get(k):
                fails.append(f"{k} not launched")
        if launches.get("blend_fwd") or launches.get("blend_bwd"):
            fails.append("the classic blend launched under SMT")
    if fails:
        raise AssertionError(f"Trainer run: {fails}")
    return dict(trainer=tr, launches=launches,
                mult_at_ckpt=mult_at[6 * u], scatter=scatter["cap"])


GCN_TIMES_SPLIT = 0.8        # train/test split of the timestamps (max_time)


def lpips_golden_weights(path: str):
    """The seeded full-size VGG16/Alex LPIPS weights of the JAX package's
    golden test (tests/test_eval.py::TestLPIPSGolden, default_rng(20260820),
    about 69 MB) written to `path`; returns its fixed input pair."""
    from gaussianprediction_tpu_torch.eval.lpips import (
        ALEX_CFG, VGG_CFG, VGG_TAPS,
    )

    rng = np.random.default_rng(20260820)
    params = {}
    cin = 3
    vgg_out = [c for c in VGG_CFG if c != "M"]
    for i, cout in enumerate(vgg_out):
        params[f"vgg/conv{i}/w"] = rng.normal(
            scale=0.05, size=(3, 3, cin, cout)).astype(np.float32)
        params[f"vgg/conv{i}/b"] = rng.normal(
            scale=0.05, size=(cout,)).astype(np.float32)
        cin = cout
    for k, c in enumerate([vgg_out[i] for i in VGG_TAPS]):
        params[f"vgg/lin{k}"] = np.abs(rng.normal(
            scale=0.1, size=(c,)).astype(np.float32))
    cin = 3
    for k_i, (cout, k, s, p) in enumerate(ALEX_CFG):
        params[f"alex/conv{k_i}/w"] = rng.normal(
            scale=0.05, size=(k, k, cin, cout)).astype(np.float32)
        params[f"alex/conv{k_i}/b"] = rng.normal(
            scale=0.05, size=(cout,)).astype(np.float32)
        cin = cout
    for k_i, (cout, *_r) in enumerate(ALEX_CFG):
        params[f"alex/lin{k_i}"] = np.abs(rng.normal(
            scale=0.1, size=(cout,)).astype(np.float32))
    np.savez(path, **params)
    a = (np.indices((64, 80)).sum(0)[..., None] % 17 / 16.0
         * np.array([1.0, 0.7, 0.4])).astype(np.float32)
    b = np.clip(a + 0.15 * np.sin(np.arange(64 * 80 * 3).reshape(64, 80, 3)
                                  * 0.37), 0, 1).astype(np.float32)
    return a, b


def once_ms(fn, dev):
    """(fn(), ms of that one call): CUDA events on the card, a host clock
    on the CPU."""
    if dev.type == "cuda":
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = fn()
        e1.record()
        e1.synchronize()
        return out, e0.elapsed_time(e1)
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def rel_err(a, b) -> float:
    """max |a - b| over max |b|."""
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / max(float(np.abs(np.asarray(b)).max()), 1e-30))


def gcn_phases(tr, info, dev, seed: int, rehearse: bool):
    """Phase 'GCN': motion extrapolation from the Trainer's final stage-3
    state and scene under the classic blend: keypoint trajectories, the
    GCN trained at the D-NeRF recipe's width, the rollout over the test
    timestamps, the keypoint-driven render of the predicted frames, their
    metrics (LPIPS from the seeded golden weights), render_video and
    render_train_sequence; each card result held to the CPU. Returns the
    kernel launch counts of the three render entry points."""
    import copy
    import shutil
    import tempfile

    from gaussianprediction_tpu_torch import kernels
    from gaussianprediction_tpu_torch.convert import gcn_to_arrays
    from gaussianprediction_tpu_torch.eval import lpips as EL
    from gaussianprediction_tpu_torch.eval import metrics as EM
    from gaussianprediction_tpu_torch.eval.render import (
        render_kpts, render_train_sequence, render_video,
    )
    from gaussianprediction_tpu_torch.motion import dataset as MD
    from gaussianprediction_tpu_torch.motion import gcn_train as GT
    from gaussianprediction_tpu_torch.ops import rasterize_kernels as rk

    cfg, state, it, bg = tr.cfg, tr.state, tr.iteration, tr.bg
    cpu = torch.device("cpu")
    scpu = state.to(cpu)
    launches = {}

    def count(fn):
        kernels.reset_launch_counts()
        out = fn()
        sync(dev)
        for k, v in kernels.launch_counts.items():
            launches[k] = launches.get(k, 0) + v
        return out

    with Phase("GCN: keypoint trajectories"), torch.no_grad():
        train_t, test_t = MD.times_from_scene(info, GCN_TIMES_SPLIT)
        traj, ms = once_ms(lambda: MD.extract_trajectories(
            state, cfg, train_t, test_t, it), dev)
        ref = MD.extract_trajectories(scpu, cfg, train_t, test_t, it)
        err = max(rel_err(a, b) for a, b in zip(traj[:4], ref[:4]))
        log(f"GCN: iteration {it}, {int(state.n_alive())} Gaussians and "
            f"{traj.n_kpts} keypoints alive; {len(train_t)} train and "
            f"{len(test_t)} test timestamps (split at {GCN_TIMES_SPLIT}); "
            f"trajectories {ms:.3f} ms ({ms / len(train_t + test_t):.3f} "
            f"ms a timestamp), card vs CPU {err:.3e} of the largest "
            f"|value|")
        if not err <= 1e-5:
            raise AssertionError("trajectories: card and CPU differ")

    gcfg = GT.GCNConfig(input_size=10, output_size=1, linear_size=128,
                        num_stage=6, epochs=101, batch_size=32,
                        noise_init=0.1, noise_step=100,
                        norm_rotation=cfg.model.norm_rotation)
    K = traj.n_kpts
    with Phase("GCN: training"):
        windows = MD.build_windows(traj, gcfg.input_size, gcfg.output_size,
                                   "train")
        n_win = len(windows.xyz_inputs)
        bs = min(gcfg.batch_size, n_win)
        steps = gcfg.epochs * (n_win // bs)
        (model, hist), ms = once_ms(lambda: GT.train_gcn(
            windows, K, gcfg, seed=seed, verbose=False, device=dev), dev)
        model2, hist2 = GT.train_gcn(windows, K, gcfg, seed=seed,
                                     verbose=False, device=dev)
        a, b = gcn_to_arrays(model), gcn_to_arrays(model2)
        same = hist == hist2 and all(bits_equal(a[k], b[k]) for k in a)
        log(f"GCN: {n_win} windows of {K} keypoints, batch {bs}, "
            f"{gcfg.epochs} epochs, {steps} steps: {ms:.3f} ms "
            f"({ms / steps:.3f} ms a step); loss {hist[0]:.6f} -> "
            f"{hist[-1]:.6f}; a second run bit-identical (params, batch-norm"
            f" statistics, losses) {same}")
        if not hist[-1] < hist[0]:
            raise AssertionError("GCN loss did not fall")
        if not same:
            raise AssertionError("two GCN training runs differ")
        # one step on the card and on the CPU (and in f64) from one model
        batch = [x[:bs] for x in (windows.xyz_inputs, windows.rot_inputs,
                                  windows.xyz_gt, windows.rot_gt)]
        out = {}
        for name, d, dt in (("card", dev, torch.float32),
                            ("cpu", cpu, torch.float32),
                            ("cpu64", cpu, torch.float64)):
            m = GT.init_gcn(gcfg, K, seed, d).to(dt)
            loss, grads = GT.train_step(
                m, GT.init_adam(m), gcfg.lr,
                *[torch.from_numpy(x).to(d, dt) for x in batch], gcfg)
            out[name] = (float(loss), [g.cpu().double() for g in grads])
        names = [k for k, _ in m.named_parameters()]
        # per leaf, in units of its largest f64 magnitude; the biases of
        # the graph convolutions that feed a batch norm are left out:
        # their exact gradient is 0, the f32 ones roundoff
        worst_card = worst_cpu = 0.0
        fails = []
        for k, gd, gc, g64 in zip(names, *(out[x][1] for x in
                                           ("card", "cpu", "cpu64"))):
            if k.split(".")[-2].startswith("gc") and k.endswith("bias"):
                continue
            scale = float(g64.abs().max())
            e_card = float((gd - gc).abs().max()) / scale
            e_cpu = float((gc - g64).abs().max()) / scale
            worst_card, worst_cpu = max(worst_card, e_card), \
                max(worst_cpu, e_cpu)
            if not e_card <= max(GCN_GRAD_TOL, 4.0 * e_cpu):
                fails.append((k, e_card, e_cpu))
        l_rel = abs(out["card"][0] - out["cpu"][0]) / abs(out["cpu"][0])
        log(f"GCN step card vs CPU: loss {out['card'][0]:.7f} vs "
            f"{out['cpu'][0]:.7f} ({l_rel:.2e} relative; f64 "
            f"{out['cpu64'][0]:.7f}); gradients within {worst_card:.2e} of"
            f" a leaf's largest magnitude (the CPU's f32 gradients within "
            f"{worst_cpu:.2e} of its f64 ones); leaves beyond max("
            f"{GCN_GRAD_TOL}, 4 x the CPU's f32 error): {fails}")
        if not l_rel <= 1e-5 or fails:
            raise AssertionError("GCN step: card and CPU differ")
        m = GT.init_gcn(gcfg, K, seed, dev)
        opt = GT.init_adam(m)
        bdev = [torch.from_numpy(x).to(dev) for x in batch]
        profile(lambda: GT.train_step(m, opt, gcfg.lr, *bdev, gcfg), dev,
                "one GCN training step", top=8)

    with Phase("GCN: rollout"):
        xw = traj.kpts_xyz_train[-gcfg.input_size:]
        rw = traj.kpts_r_train[-gcfg.input_size:]
        frames_n = len(test_t)
        (kp, kr), ms = once_ms(lambda: GT.rollout(model, gcfg, xw, rw,
                                                  frames_n), dev)
        m_cpu = copy.deepcopy(model).to(cpu)
        kp_c, kr_c = GT.rollout(m_cpu, gcfg, xw, rw, frames_n)
        kp_d, kr_d = GT.rollout(m_cpu.double(), gcfg, xw, rw, frames_n)
        err = max(rel_err(kp, kp_c), rel_err(kr, kr_c))
        err64 = max(rel_err(kp_c, kp_d), rel_err(kr_c, kr_d))
        pos = float(np.linalg.norm(kp - traj.kpts_xyz_test, axis=-1).mean())
        log(f"GCN rollout: {frames_n} frames in {ms:.3f} ms "
            f"({ms / frames_n:.3f} ms a frame); card vs CPU {err:.3e} of "
            f"the largest |value| (the CPU's f32 vs its f64 {err64:.3e}); "
            f"mean keypoint position error against "
            f"the extracted test trajectories {pos:.5f}")
        if not err <= max(GCN_ROLLOUT_TOL, 4.0 * err64):
            raise AssertionError("GCN rollout: card and CPU differ")

    # the cameras at the test timestamps (the scene's own test views sit
    # inside the training times)
    future = [c for c in sorted(info.train_cameras + info.test_cameras,
                                key=lambda c: c.time)
              if c.time >= GCN_TIMES_SPLIT]
    size = future[0].width

    def frames_ok(frames, stats, what):
        bad = [i for i, f in enumerate(frames)
               if f.shape != (size, size, 3) or not np.isfinite(f).all()]
        if bad or any(stats["n_dropped"]):
            raise AssertionError(f"{what}: bad frames {bad}, n_dropped "
                                 f"{stats['n_dropped']}")

    with Phase("GCN: render_kpts of the predicted frames"):
        stats = {}
        with Capture([(rk, "rasterize_binned")]) as cap:
            frames = count(lambda: render_kpts(state, cfg, it, future, bg,
                                               kp, kr, stats=stats))
        frames_ok(frames, stats, "render_kpts")
        with torch.no_grad():
            (inst, ts, te, gx, gy, with_tidx), _ = \
                cap.args["rasterize_binned"]
            out = rk.rasterize_binned(inst, ts, te, gx, gy, with_tidx)
            aux = {}
            ref = rk.rasterize_binned_plain(inst, ts, te, gx, gy, with_tidx,
                                            aux=aux)
            same = bits_equal(out, ref)
        log(f"render_kpts: {len(frames)} frames at {size}x{size}, ms a "
            f"frame {[round(m, 3) for m in stats['ms']]}, n_dropped "
            f"{stats['n_dropped']}; the last frame's stream: blend_fwd "
            f"equal to its plain version bit for bit {same}; "
            f"{cull_share(aux)}")
        if not same:
            raise AssertionError("blend_fwd disagrees on a predicted frame")

    with Phase("GCN: metrics of the predicted frames (LPIPS on the "
               "seeded weights)"):
        gts = [c.load_image() for c in future]
        os.makedirs(BUILD_DIR, exist_ok=True)
        wdir = tempfile.mkdtemp(prefix="lpips_", dir=BUILD_DIR)
        saved = os.environ.get("GPT_LPIPS_WEIGHTS")
        try:
            path = os.path.join(wdir, "lpips_golden.npz")
            ga, gb = lpips_golden_weights(path)
            os.environ["GPT_LPIPS_WEIGHTS"] = path
            res, ms = once_ms(lambda: EM.evaluate_pairs(frames, gts,
                                                        device=dev), dev)
            mean = res["mean"]
            lv, la = EL.try_load_lpips(dev)(ga, gb)
            rv, ra = EL.try_load_lpips(dev)(frames[0], gts[0])
            cv, ca = EL.try_load_lpips(cpu)(frames[0], gts[0])
        finally:
            if saved is None:
                os.environ.pop("GPT_LPIPS_WEIGHTS", None)
            else:
                os.environ["GPT_LPIPS_WEIGHTS"] = saved
            shutil.rmtree(wdir, ignore_errors=True)
        log("GCN metrics of the predicted frames: " + ", ".join(
            f"{k} {mean[k]}" for k in ("PSNR", "SSIM", "MS-SSIM", "D-SSIM",
                                       "LPIPS-vgg", "LPIPS-alex"))
            + f" ({ms:.3f} ms for {len(frames)} pairs)")
        log(f"LPIPS on the golden pair: vgg {lv} (golden "
            f"{LPIPS_GOLDEN[0]}), alex {la} (golden {LPIPS_GOLDEN[1]}); "
            f"a rendered pair on the card vs the CPU: vgg {rv} vs {cv}, "
            f"alex {ra} vs {ca}")
        fails = []
        for got, want, tol in ((lv, LPIPS_GOLDEN[0], 2e-3),
                               (la, LPIPS_GOLDEN[1], 2e-3),
                               (rv, cv, 1e-4), (ra, ca, 1e-4)):
            if not abs(got - want) <= tol * abs(want):
                fails.append((got, want, tol))
        if not all(np.isfinite(mean[k]) for k in ("PSNR", "SSIM", "D-SSIM",
                                                  "LPIPS-vgg")):
            fails.append("a metric is not finite")
        if not rehearse and mean["MS-SSIM"] is None:
            fails.append("no MS-SSIM at 800x800")
        if fails:
            raise AssertionError(f"GCN metrics: {fails}")

    with Phase("GCN: render_video and render_train_sequence"):
        vstats, sstats = {}, {}
        vframes = count(lambda: render_video(state, cfg, it, future[:3], bg,
                                             interpolation=2, stats=vstats))
        frames_ok(vframes, vstats, "render_video")
        train_views = sorted(info.train_cameras, key=lambda c: c.time)
        picks = [train_views[i] for i in (0, len(train_views) // 2, -1)]
        sframes = count(lambda: render_train_sequence(
            state, cfg, it, picks, info.test_cameras[0], bg, stats=sstats))
        frames_ok(sframes, sstats, "render_train_sequence")
        log(f"render_video: {len(vframes)} frames, ms a frame "
            f"{[round(m, 3) for m in vstats['ms']]}; render_train_sequence:"
            f" {len(sframes)} frames, ms a frame "
            f"{[round(m, 3) for m in sstats['ms']]}; launches of the three "
            f"render entry points {launches}")
        if not rehearse:
            missing = [k for k in FWD_KERNELS if not launches.get(k)]
            if missing:
                raise AssertionError(f"GCN phase: not launched {missing}")
    return launches


CLI_KERNELS = ("stack", "expand", "interleave", "blend_fwd", "blend_bwd",
               "scatter_add_sorted")      # kernels #1-#7, as the CLIs run


def cli_argv(scene: str, model: str, rehearse: bool):
    """cli.train's argv: the dnerf preset (on the CPU rehearsal the `test`
    preset: the dnerf capacity of 204,800 rows is too wide for the CPU),
    max_time 0.8 and a schedule compressed through train.py's own flags
    onto 6u iterations: stage 1 from u/2, stage 2 from 3u + 1, stage 3 from
    4.5u + 1; densify at 2u and 3u (the preset's interval of 100 on the
    card); keypoint growth every u/2 from 3.2u; reports at u/10, 3u and
    6u; checkpoints at 3u and 6u, the PLY at 6u. The fields train.py has
    no flag for (densification_interval, opacity_reset_interval) keep the
    preset's values."""
    u = 10 if rehearse else 100
    return ["-s", scene, "-m", model,
            "--preset", "test" if rehearse else "dnerf",
            "--max_time", str(GCN_TIMES_SPLIT), "--iterations", str(6 * u),
            "--jointly_iteration", str(u // 2),
            "--second_stage_iteration", str(3 * u),
            "--third_stage_iteration", str(9 * u // 2),
            "--densify_from_iter", str(u), "--densify_until_iter",
            str(3 * u + 1), "--position_lr_max_steps", str(4 * u),
            "--adaptive_from_iter", str(u // 5), "--adaptive_interval",
            str(u // 2), "--test_iterations", str(u // 10), str(3 * u),
            str(6 * u), "--checkpoint_iterations", str(3 * u), str(6 * u),
            "--save_iterations", str(6 * u)]


def cli_phases(info, dev, seed: int, rehearse: bool):
    """Phase 'CLI': the user's path from a scene on disk. Phase 18's
    synthetic scene (all 23 views, times i/22) is written as a D-NeRF tree
    (transforms_train.json, 8-bit RGBA PNGs written by the standard
    library's zlib, alpha 0 where the render is exactly black, and
    points3d.ply); loaded lazily and eagerly, every image must equal the
    written bytes / 255 composited onto the background, bit for bit, and
    the split at 0.8 must be 18 / 5. Then cli.train, cli.eval
    (--render_video --render_train), cli.train_gcn (--metrics
    --predict_more) run in this process, so the launch counts are shared,
    and cli.show as a `python -m` subprocess. Returns the kernel launches
    of train, eval and train_gcn."""
    import shutil
    import tempfile

    from gaussianprediction_tpu_torch import kernels
    from gaussianprediction_tpu_torch.cli import eval as CE
    from gaussianprediction_tpu_torch.cli import train as CT
    from gaussianprediction_tpu_torch.cli import train_gcn as CG
    from gaussianprediction_tpu_torch.config import get_preset
    from gaussianprediction_tpu_torch.data import native
    from gaussianprediction_tpu_torch.data.blender import (
        write_nerf_synthetic,
    )
    from gaussianprediction_tpu_torch.data.scene import load_scene_info
    from gaussianprediction_tpu_torch.eval import render as ER
    from gaussianprediction_tpu_torch.ops import instance_stream as IS
    from gaussianprediction_tpu_torch.ops import rasterize_kernels as rk
    from gaussianprediction_tpu_torch.train import loop as L

    os.makedirs(BUILD_DIR, exist_ok=True)
    root = tempfile.mkdtemp(prefix="gpt_cli_", dir=BUILD_DIR)
    scene, model = os.path.join(root, "scene"), os.path.join(root, "model")
    cams = sorted(info.train_cameras + info.test_cameras, key=lambda c: c.time)
    size = cams[0].width
    launches = {}
    streams = []                 # (what, n_dropped, n_total) of each stream

    def note(what):
        def fn(name, a, out):
            st = out if isinstance(out, IS.InstanceStream) else out[0]
            streams.append((what, st.n_dropped, st.n_total))
        return fn

    def counted(fn, what):
        kernels.reset_launch_counts()
        with Capture([(IS, "build_instances_fwd")], note(what)):
            out = fn()
        sync(dev)
        got = dict(kernels.launch_counts)
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        drops = [int(d) for w, d, _ in streams if w == what]
        log(f"CLI {what}: launches {got}; {len(drops)} instance streams, "
            f"n_dropped {sum(drops)} (largest {max(drops, default=0)})")
        if any(drops):
            raise AssertionError(f"CLI {what}: an instance stream dropped")
        if not rehearse:
            need = CLI_KERNELS if what == "train" else FWD_KERNELS
            missing = [k for k in need if not got.get(k)]
            if missing:
                raise AssertionError(f"CLI {what}: not launched {missing}")
        return out

    saved_env = os.environ.pop("GPT_FORCE_CPU", None)
    if rehearse:
        os.environ["GPT_FORCE_CPU"] = "1"
    try:
        with Phase("CLI: write the scene as a D-NeRF tree"):
            write_nerf_synthetic(scene, cams, info.points, info.colors)
            n_bytes = sum(os.path.getsize(os.path.join(scene, "train", f))
                          for f in os.listdir(os.path.join(scene, "train")))
            log(f"CLI scene: {len(cams)} views at {size}x{size}, "
                f"{n_bytes / 1e6:.1f} MB of PNGs, {len(info.points)} points "
                f"in points3d.ply")

        with Phase("CLI: the loader against the written bytes"):
            cfg = get_preset("dnerf")
            cfg.source_path, cfg.model.max_time = scene, GCN_TIMES_SPLIT
            lazy = load_scene_info(cfg, lazy=True)
            t0 = time.perf_counter()
            eager = load_scene_info(cfg, lazy=False)
            eager_ms = (time.perf_counter() - t0) * 1e3
            decode_ms = []
            for c in lazy.train_cameras + lazy.test_cameras:
                t0 = time.perf_counter()
                c.load_image()
                decode_ms.append((time.perf_counter() - t0) * 1e3)
            bg = 1.0 if cfg.model.white_background else 0.0
            bad = []
            loaded = [lazy.train_cameras + lazy.test_cameras,
                      eager.train_cameras + eager.test_cameras]
            for i, src in enumerate(cams):
                u8 = (np.clip(src.image, 0.0, 1.0) * 255).astype(np.uint8)
                a = np.where((src.image == 0.0).all(-1, keepdims=True),
                             np.float32(0.0), np.float32(1.0))
                want = u8.astype(np.float32) / 255.0 * a + bg * (1.0 - a)
                for how, cs in zip(("lazy", "eager"), loaded):
                    if cs[i].time != src.time or not bits_equal(
                            torch.from_numpy(cs[i].load_image()),
                            torch.from_numpy(want)):
                        bad.append((how, i))
            split = (len(lazy.train_cameras), len(lazy.test_cameras))
            transparent = float(np.mean([(c.image == 0.0).all(-1).mean()
                                         for c in cams]))
            log(f"CLI loader: decoder {'native' if native.available() else 'PIL'}"
                f" (native build error: {native.build_error}); split at "
                f"{GCN_TIMES_SPLIT}: {split[0]} train / {split[1]} test; "
                f"images equal to the written bytes / 255 composited, bit "
                f"for bit: {not bad} (lazy and eager, {len(cams)} views, "
                f"{100 * transparent:.1f}% of the pixels transparent); host "
                f"ms per decoded {size}x{size} view: median "
                f"{float(np.median(decode_ms)):.3f} (lazy), "
                f"{eager_ms / len(cams):.3f} (the eager load, a view)")
            if bad or split != (18, 5):
                raise AssertionError(f"CLI loader: {bad}, split {split}")
            del lazy, eager, loaded

        with Phase("CLI: cli.train"):
            argv = cli_argv(scene, model, rehearse)
            log("CLI train argv: " + " ".join(argv[4:]))
            rec = []                       # (stage, start, end)
            orig_one = L.Trainer.train_one

            def timed_one(self, it):
                if dev.type == "cuda":
                    e0 = torch.cuda.Event(enable_timing=True)
                    e1 = torch.cuda.Event(enable_timing=True)
                    e0.record()
                    m = orig_one(self, it)
                    e1.record()
                else:
                    e0 = time.perf_counter()
                    m = orig_one(self, it)
                    e1 = time.perf_counter()
                rec.append((L.stage_of(self.cfg, it), e0, e1))
                return m

            L.Trainer.train_one = timed_one
            try:
                t0 = time.perf_counter()
                tr = counted(lambda: CT.main(argv), "train")
                wall = time.perf_counter() - t0
            finally:
                L.Trainer.train_one = orig_one
            per_stage = {}
            for st, e0, e1 in rec:
                per_stage.setdefault(st, []).append(
                    e0.elapsed_time(e1) if dev.type == "cuda"
                    else (e1 - e0) * 1e3)
            reports = [h["eval"] for h in tr._history if "eval" in h]
            psnrs = [(r["iter"], round(r["test_psnr"], 3)) for r in reports]
            ds = tr.scene.decode_stats
            log(f"CLI train: {tr.iteration} iterations in {wall:.1f} s; ms "
                f"per iteration (CUDA events around train_one), "
                + "; ".join(f"stage {k}: median {float(np.median(v)):.3f} "
                            f"over {len(v)}"
                            for k, v in sorted(per_stage.items()))
                + f"; test PSNR at the reports {psnrs}; "
                f"{int(tr.state.n_alive())} Gaussians, "
                f"{int(tr.state.n_kpts())} keypoints; image decode: "
                f"{ds['waited']} of {ds['draws']} iterations "
                f"({100 * ds['waited'] / max(ds['draws'], 1):.1f}%) found "
                f"their camera's image not decoded yet, "
                f"{ds['wait_ms']:.1f} ms waited on the decode workers")
            fails = []
            if sorted(per_stage) != [0, 1, 2, 3]:
                fails.append(f"stages {sorted(per_stage)}")
            if not reports or not psnrs[-1][1] > psnrs[0][1]:
                fails.append("the test PSNR did not rise")
            for f in ("cfg.json", f"chkpnt{tr.iteration}.npz", "history.json",
                      f"point_cloud/iteration_{tr.iteration}/point_cloud.ply"):
                if not os.path.exists(os.path.join(model, f)):
                    fails.append(f"missing {f}")
            log(f"CLI train: checks failed {fails}")
            if fails and not rehearse:
                raise AssertionError(f"CLI train: {fails}")

        with Phase("CLI: load_ply_params of the written PLY"):
            from gaussianprediction_tpu_torch.models.gaussians import (
                load_ply_params,
            )

            ply = os.path.join(model, f"point_cloud/iteration_{tr.iteration}"
                                      "/point_cloud.ply")
            lp, lalive = load_ply_params(ply, tr.cfg, device=dev)
            nl = int(lalive.sum())
            live = tr.state.alive
            same = nl == int(live.sum()) and all(
                bits_equal(lp[k][:nl], tr.state.params[k][live])
                for k in lp)
            dead = bool((lp["opacity"][nl:] == -15.0).all())
            log(f"CLI load_ply_params: {nl} live rows of "
                f"{lalive.shape[0]}; params equal to the saved state's live "
                f"rows bit for bit {same}; dead rows at opacity -15 {dead}")
            if not (same and dead):
                raise AssertionError("load_ply_params differs from the "
                                     "saved state")
            del tr, lp

        with Phase("CLI: cli.eval --render_video --render_train"):
            with Capture([(rk, "rasterize_binned")]) as cap:
                res = counted(lambda: CE.main(
                    ["-m", model, "--render_video", "--render_train"]),
                    "eval")
            with torch.no_grad():
                (inst, ts, te, gx, gy, with_tidx), _ = \
                    cap.args["rasterize_binned"]
                out = rk.rasterize_binned(inst, ts, te, gx, gy, with_tidx)
                ref = rk.rasterize_binned_plain(inst, ts, te, gx, gy,
                                                with_tidx)
                same = bits_equal(out, ref)
            with open(os.path.join(res["out_dir"], "results.json")) as f:
                metrics = json.load(f)
            n_files = {d: len(os.listdir(os.path.join(res["out_dir"], d)))
                       for d in sorted(os.listdir(res["out_dir"]))
                       if os.path.isdir(os.path.join(res["out_dir"], d))}
            log(f"CLI eval: {1e3 / res['fps']:.3f} ms per test view "
                f"({res['fps']:.2f} FPS); results.json " + ", ".join(
                    f"{k} {metrics[k]}" for k in ("PSNR", "SSIM", "MS-SSIM",
                                                  "D-SSIM", "LPIPS-vgg"))
                + f"; files {n_files}; the last render's stream: blend_fwd "
                f"equal to its plain version bit for bit {same}")
            if not np.isfinite(metrics["PSNR"]) or not same:
                raise AssertionError("CLI eval: PSNR or blend_fwd")

        with Phase("CLI: evaluate_dirs on the eval renders"):
            from gaussianprediction_tpu_torch.eval.metrics import (
                evaluate_dirs,
            )

            edir = os.path.join(root, "evaluate_dirs")
            os.makedirs(edir)
            t0 = time.perf_counter()
            er = evaluate_dirs(os.path.join(res["out_dir"], "renders"),
                               os.path.join(res["out_dir"], "gt"), edir,
                               device=dev)
            n_maps = len(os.listdir(os.path.join(edir, "deltas")))
            log(f"CLI evaluate_dirs: PSNR {er['mean']['PSNR']} from the "
                f"written PNGs (cli.eval's, from the renders in memory: "
                f"{metrics['PSNR']}), {n_maps} error maps "
                f"({sorted(os.listdir(os.path.join(edir, 'deltas')))[0]}), "
                f"{time.perf_counter() - t0:.2f} s")
            if not np.isfinite(er["mean"]["PSNR"]) or not n_maps:
                raise AssertionError("evaluate_dirs")

        with Phase("CLI: cli.train_gcn --metrics --predict_more"):
            frame_ms = []
            orig_kpts = ER.render_kpts

            def timed_kpts(*a, **k):
                stats = {}
                frames = orig_kpts(*a, stats=stats, **k)
                frame_ms.extend(stats["ms"])
                return frames

            ER.render_kpts = timed_kpts
            try:
                g = counted(lambda: CG.main(
                    ["-m", model, "--num_stage", "6", "--metrics",
                     "--predict_more", "--frames", "30"]), "train_gcn")
            finally:
                ER.render_kpts = orig_kpts
            gdir = os.path.join(model, "gcn")
            with open(os.path.join(gdir, "metrics_predicted",
                                   "results.json")) as f:
                pm = json.load(f)
            hist = g["history"]
            log(f"CLI train_gcn: loss {hist[0]:.6f} -> {hist[-1]:.6f}, "
                f"{len(g['predicted'])} predicted frames and "
                f"{len(frame_ms) - len(g['predicted'])} scored; ms per "
                f"predicted frame: median {float(np.median(frame_ms)):.3f}; "
                f"the predicted frames' metrics " + ", ".join(
                    f"{k} {pm[k]}" for k in ("PSNR", "SSIM", "MS-SSIM",
                                             "D-SSIM")))
            if not os.path.exists(os.path.join(gdir, "gcn_ckpt.npz")) or \
                    not np.isfinite(pm["PSNR"]):
                raise AssertionError("CLI train_gcn: outputs")

        with Phase("CLI: python -m gaussianprediction_tpu_torch.cli.show"):
            r = subprocess.run(
                [sys.executable, "-m", "gaussianprediction_tpu_torch.cli.show",
                 "-r", model + "eval",
                 os.path.join(gdir, "metrics_predicted")],
                cwd=os.path.dirname(os.path.abspath(__file__)),
                capture_output=True, text=True, timeout=300)
            for line in r.stdout.splitlines():
                log("  " + line)
            if r.returncode != 0 or "average" not in r.stdout:
                raise AssertionError(f"cli.show: {r.returncode} "
                                     f"{r.stderr[-2000:]}")
    finally:
        os.environ.pop("GPT_FORCE_CPU", None)
        if saved_env is not None:
            os.environ["GPT_FORCE_CPU"] = saved_env
        shutil.rmtree(root, ignore_errors=True)
    log(f"CLI: launches of train, eval and train_gcn {launches}")
    return launches


class classic_binning:
    """Route the port's render through the binning path
    (render(fast_binning=False)) for the block: the steps call
    rasterize.render."""

    def __enter__(self):
        import functools

        from gaussianprediction_tpu_torch.ops import rasterize as RZ

        self.orig = RZ.render
        RZ.render = functools.partial(self.orig, fast_binning=False)
        return self

    def __exit__(self, *exc):
        from gaussianprediction_tpu_torch.ops import rasterize as RZ

        RZ.render = self.orig
        return False


def tree_diff(a, b):
    """(bit for bit, the largest difference as a share of each leaf's
    largest magnitude) of two tensor trees."""
    from gaussianprediction_tpu_torch.train.optimizer import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    bits = all(bits_equal(x, y) for x, y in zip(la, lb))
    worst = max(float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30)
                for x, y in zip(la, lb))
    return bits, worst


def counted_launches(fn, dev):
    """(fn(), the kernel launches of that call): the counts set to 0 just
    before and read just after."""
    from gaussianprediction_tpu_torch import kernels

    kernels.reset_launch_counts()
    out = fn()
    sync(dev)
    return out, dict(kernels.launch_counts)


def classic_phases(cfg, dev, rstate, iteration, views, renders, ctx,
                   rehearse: bool, reps: int):
    """Phase 'classic path' (the slice that ports gradient accumulation,
    the classic binning, cov3d_precomp, tight_rects=False and the ellipse
    cull): on phase 6's model and first view, render(fast_binning=False)
    against the fast path (bit for bit, n_dropped 0, blend_fwd equal to its
    plain version on the CHUNK-aligned stream); a stage-1 step through the
    binning path (blend_bwd equal to its plain version, the step twice
    bit-identical, its gradients against the fast path's); every blend
    variant on the binning stream against classic; a render and a step
    under GPT_ELLIPSE_CULL=1 against the same with the cull off (bit for
    bit, the culled share); cov3d_precomp from the same scales and
    rotations (bit for bit); tight_rects=False (finite, n_dropped 0); a
    batched step of 3 against three single renders' gradients summed and
    one Adam update, and twice bit-identical. Returns the launches of the
    binning render, binning step and batched step (kernels line rows)."""
    import copy

    from gaussianprediction_tpu_torch.models.gaussians import get_shs
    from gaussianprediction_tpu_torch.ops import instance_stream as IS
    from gaussianprediction_tpu_torch.ops import projection as PJ
    from gaussianprediction_tpu_torch.ops import rasterize as RZ
    from gaussianprediction_tpu_torch.ops import rasterize_kernels as rk
    from gaussianprediction_tpu_torch.train import optimizer as O
    from gaussianprediction_tpu_torch.train import step as S

    launches = {}

    def add(got):
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v

    size = views[0].width
    T = ((size + 15) // 16) ** 2
    n = int(rstate.alive.sum())
    cam0 = views[0].to_device_dict(dev)
    t0 = torch.tensor(views[0].time, dtype=torch.float32, device=dev)
    bg_t = torch.zeros(3, device=dev)
    with torch.no_grad():
        d = S.deform_for_stage(rstate.params, cfg, rstate, t0, iteration,
                               None, 1)
    rargs = (d.xyz, d.scaling, d.rotation, d.opacity, get_shs(rstate.params),
             cam0, size, size, bg_t)
    rkw = dict(sh_degree=cfg.model.sh_degree, alive=rstate.alive)
    mult = cfg.model.capacity_multiplier
    # the binning path's capacity: the instances and every touched tile's
    # CHUNK-aligned padding (< 128 slots a tile)
    mult_b = mult + -(-T * 128 // n) + 1

    def render(**kw):
        with torch.no_grad():
            return RZ.render(*rargs, **rkw, **{"capacity_multiplier": mult,
                                               **kw})

    with Phase("classic path: render(fast_binning=False), first view"):
        fast = render()
        with Capture([(rk, "rasterize_binned")]) as cap:
            slow, got = counted_launches(lambda: render(
                fast_binning=False, capacity_multiplier=mult_b), dev)
        add(got)
        (inst, ts, te, gx, gy, wt), _ = cap.args["rasterize_binned"]
        same = {k: bits_equal(slow[k], fast[k])
                for k in ("render", "depth", "alpha")}
        same["tidx"] = torch.equal(slow["tidx"], fast["tidx"])
        out = rk.rasterize_binned(inst, ts, te, gx, gy, wt)
        aux = {}
        ref = rk.rasterize_binned_plain(inst, ts, te, gx, gy, wt, aux=aux)
        k_same = bits_equal(out, ref)
        seg = (te - ts).to(torch.int64)
        gaps = int((te[:-1] < ts[1:]).sum())
        ms_fast = time_ms(render, dev, reps)
        ms_slow = time_ms(lambda: render(fast_binning=False,
                                         capacity_multiplier=mult_b), dev,
                          reps)
        dms = device_ms_of(lambda: rk.rasterize_binned(inst, ts, te, gx, gy,
                                                       wt), dev, reps)
        log(f"classic path render: n_dropped {int(slow['n_dropped'])}, "
            f"{int(seg.sum())} instances in a stream of {inst.shape[1]} "
            f"slots (multiplier {mult_b}; the fast path's {mult}), {gaps} of "
            f"{T - 1} tile boundaries with a padding gap; outputs equal to "
            f"the fast path's bit for bit {same}; blend_fwd on the binning "
            f"stream equal to its plain version bit for bit {k_same} "
            f"({cull_share(aux)}), device ms {dms}; ms per render: binning "
            f"{ms_slow:.3f}, fast {ms_fast:.3f}; launches {got}")
        if int(slow["n_dropped"]) or not all(same.values()) or not k_same:
            raise AssertionError("the binning render")
        if not rehearse and not got.get("blend_fwd"):
            raise AssertionError("the binning render launched no blend_fwd")

    with Phase("classic path: GPT_ELLIPSE_CULL=1, cov3d_precomp, "
               "tight_rects=False (first view)"):
        totals = {}

        def seg_total(name, a, out):
            st = out if isinstance(out, IS.InstanceStream) else out[0]
            totals.setdefault(os.environ.get("GPT_ELLIPSE_CULL", "0"),
                              []).append(int((st.tile_end
                                              - st.tile_start).sum()))

        with Capture([(IS, "build_instances_fwd")], seg_total):
            with variant_env({"GPT_ELLIPSE_CULL": "1"}):
                culled = render()
                ms_cull = time_ms(render, dev, reps)
            plain = render()
        cull_same = all(bits_equal(culled[k], fast[k])
                        for k in ("render", "depth", "alpha")) and \
            torch.equal(culled["tidx"], fast["tidx"]) and \
            bits_equal(plain["render"], fast["render"])
        share = 1.0 - totals["1"][0] / totals["0"][0]
        rot_n = d.rotation / torch.linalg.norm(d.rotation, dim=-1,
                                               keepdim=True)
        cov = PJ.covariance_from_scaling_rotation(d.scaling, rot_n)
        via_cov = render(cov3d_precomp=cov)
        cov_same = all(bits_equal(via_cov[k], fast[k])
                       for k in ("render", "depth", "alpha"))
        proj = PJ.project_from_params(d.xyz, d.scaling, rot_n, cam0, size,
                                      size, alive=rstate.alive)
        _, _, rw, rh = IS._capped_rect(proj.tiles_min, proj.tiles_max,
                                       proj.mean2d, 1024)
        zero = torch.zeros_like(rw)
        need_l = int(torch.clamp(torch.where(proj.visible, rw * rh, zero),
                                 min=1).sum())
        mult_l = -(-int(need_l * 1.1) // n) + 1
        loose = render(tight_rects=False, capacity_multiplier=mult_l)
        ms_loose = time_ms(lambda: render(tight_rects=False,
                                          capacity_multiplier=mult_l), dev,
                           reps)
        loose_ok = int(loose["n_dropped"]) == 0 and bool(
            torch.isfinite(loose["render"]).all())
        log(f"ellipse cull: {totals['1'][0]} of {totals['0'][0]} instances "
            f"kept, culled share {share:.4f}; render equal to the uncut "
            f"render bit for bit {cull_same}; ms per render with the cull "
            f"{ms_cull:.3f} (without {ms_fast:.3f})")
        log(f"cov3d_precomp (covariance_from_scaling_rotation of the same "
            f"scales and rotations): render equal bit for bit {cov_same}")
        log(f"tight_rects=False: {int(loose['n_instances'])} slots against "
            f"{int(fast['n_instances'])} tight (multiplier {mult_l}), "
            f"n_dropped {int(loose['n_dropped'])}, finite "
            f"{bool(torch.isfinite(loose['render']).all())}, max |render "
            f"- tight render| {float((loose['render'] - fast['render']).abs().max()):.3e}"
            f"; ms per render {ms_loose:.3f}")
        if not (cull_same and 0.0 < share < 1.0 and cov_same and loose_ok):
            raise AssertionError("the cull, cov3d_precomp or loose rects")

    tcfg, state, opt = ctx["cfg"], ctx["state"], ctx["opt"]
    cam, gt, t, gen = ctx["cam"], ctx["gt"], ctx["t"], ctx["gen"]
    it1 = 20_000
    sh = tcfg.model.sh_degree
    step1 = S.make_train_step(tcfg, 1, size, size, ctx["extent"], sh, 50,
                              ctx["bg_t"])
    bcfg = copy.deepcopy(tcfg)
    bcfg.model.capacity_multiplier = tcfg.model.capacity_multiplier + \
        -(-T * 128 // ctx["C"]) + 1
    bstep = S.make_train_step(bcfg, 1, size, size, ctx["extent"], sh, 50,
                              ctx["bg_t"])
    args = lambda: (state, opt, cam, gt, t, it1, gen())  # noqa: E731

    with Phase("classic path: a stage-1 step through the binning path"):
        with Capture([(IS, "build_instances_bwd")]) as fcap:
            ref = checked(step1(*args()), "fast step")
        with classic_binning(), Capture([(rk, "rasterize_binned_bwd"),
                                         (rk, "rasterize_binned"),
                                         (IS, "build_instances_bwd")]) as cap:
            a, got = counted_launches(lambda: checked(bstep(*args()),
                                                      "binning step"), dev)
            b = bstep(*args())
            ms_b = step_ms(bstep, args(), dev, 3)
        add(got)
        ms_f = step_ms(step1, args(), dev, 3)
        twice = bits_equal(a[2]["loss"], b[2]["loss"]) and all(
            bits_equal(x, y) for x, y in zip(O.tree_leaves(a[0].params),
                                             O.tree_leaves(b[0].params)))
        (binst, bts, bte, bgx, bgy, dpix), _ = cap.args["rasterize_binned_bwd"]
        binst = binst.detach()
        db = rk.rasterize_binned_bwd(binst, bts, bte, bgx, bgy, dpix)
        dref = rk.rasterize_binned_bwd_plain(binst, bts, bte, bgx, bgy, dpix,
                                             sums=wrapper_sums(dev))
        k_same = bits_equal(db, dref)
        dms = device_ms_of(lambda: rk.rasterize_binned_bwd(
            binst, bts, bte, bgx, bgy, dpix), dev, reps)
        loss_same = bits_equal(a[2]["loss"], ref[2]["loss"])
        g_bits, g_worst = tree_diff(a[2]["grads"], ref[2]["grads"])
        # the per-Gaussian reductions of the two streams: the same columns
        # behind a negative prefix of another length, so the card's
        # row-wise scan associates them otherwise (phase 10's bound)
        (gid_f, _, d_f), _ = fcap.args["build_instances_bwd"]
        srt = d_f[:10].index_select(1, torch.sort(
            gid_f.to(torch.int32), stable=True).indices)
        tol = 64 * EPS32 * float(torch.cumsum(srt, dim=1).abs().max())
        derr = float((cap.out["build_instances_bwd"]
                      - fcap.out["build_instances_bwd"]).abs().max())
        log(f"binning step: loss {float(a[2]['loss']):.6f} (the fast path's "
            f"{float(ref[2]['loss']):.6f}, equal bit for bit {loss_same}); "
            f"per-Gaussian feature gradients against the fast path's: max "
            f"|diff| {derr:.3e} (64 * 2^-24 * max |cumsum| {tol:.3e}); leaf "
            f"gradients equal bit for bit {g_bits} (largest difference "
            f"{g_worst:.3e} of a leaf's max); run twice identical "
            f"{twice}; blend_bwd on the binning stream equal to its plain "
            f"version bit for bit {k_same}, device ms {dms}; ms per step: "
            f"binning {[round(x, 3) for x in ms_b]}, fast "
            f"{[round(x, 3) for x in ms_f]}; launches {got}")
        if not (twice and k_same and loss_same) or not derr <= tol:
            raise AssertionError("the binning step")
        if not rehearse and not got.get("blend_bwd"):
            raise AssertionError("the binning step launched no blend_bwd")

    with Phase("classic path: blend variants on the binning stream"):
        (finst, fts, fte, fgx, fgy, fwt), _ = cap.args["rasterize_binned"]
        finst = finst.detach()
        out_c = rk.rasterize_binned(finst, fts, fte, fgx, fgy, fwt,
                                    rk.CLASSIC)
        ok = {}
        for key, env in VARIANT_ENV.items():
            with variant_env(env):
                v = rk.blend_variant()
            ok[key] = (
                bits_equal(rk.rasterize_binned(finst, fts, fte, fgx, fgy,
                                               fwt, v), out_c),
                bits_equal(rk.rasterize_binned_bwd(binst, bts, bte, bgx,
                                                   bgy, dpix, variant=v),
                           db))
        sync(dev)
        log(f"variants on the binning stream, (forward, backward) equal to "
            f"classic bit for bit: {ok}")
        if not all(all(x) for x in ok.values()):
            raise AssertionError("a variant differs on the binning stream")

    with Phase("classic path: a stage-1 step under GPT_ELLIPSE_CULL=1"):
        with variant_env({"GPT_ELLIPSE_CULL": "1"}):
            c = checked(step1(*args()), "culled step")
            ms_c = step_ms(step1, args(), dev, 3)
        same = bits_equal(c[2]["loss"], ref[2]["loss"]) and all(
            bits_equal(x, y) for x, y in zip(
                O.tree_leaves([c[0].params, c[1]["m"], c[1]["v"]]),
                O.tree_leaves([ref[0].params, ref[1]["m"], ref[1]["v"]])))
        log(f"culled step: loss, params and moments equal to the uncut "
            f"step's bit for bit {same}; ms per step "
            f"{[round(x, 3) for x in ms_c]} (uncut {[round(x, 3) for x in ms_f]})")
        if not same:
            raise AssertionError("the culled step differs")

    with Phase("classic path: a batched step of 3 (gradient accumulation)"):
        bviews = views[:3]
        cams = [cam] + [v.to_device_dict(dev) for v in bviews[1:]]
        gts = [gt] + [torch.as_tensor(r, device=dev) for r in renders[1:3]]
        times = [t] + [torch.tensor(v.time, dtype=torch.float32, device=dev)
                       for v in bviews[1:]]
        # room for the other two views' slots
        acfg = copy.deepcopy(tcfg)
        acfg.model.capacity_multiplier = tcfg.model.capacity_multiplier * 1.25
        batched = S.make_train_step_batched(acfg, 1, size, size,
                                            ctx["extent"], sh, 50,
                                            ctx["bg_t"], 3)
        bargs = lambda: (state, opt, cams, gts, times, it1, gen())  # noqa
        x, got = counted_launches(lambda: checked(batched(*bargs()),
                                                  "batched step"), dev)
        add(got)
        y = batched(*bargs())
        twice = bits_equal(x[2]["loss"], y[2]["loss"]) and all(
            bits_equal(p, q) for p, q in zip(O.tree_leaves(x[0].params),
                                             O.tree_leaves(y[0].params)))
        # three single renders' gradients, summed, and one Adam update
        loss_and_grads, _ = S._step_parts(acfg, 1, size, size,
                                          ctx["extent"], sh, ctx["bg_t"])
        g = gen()
        total = None
        for j in range(3):
            tj = S.time_with_noise(acfg, times[j], g, 50, S.time_noise_anneal(
                acfg, it1 + j, 1).to(dev))
            gj = loss_and_grads(state, cams[j], gts[j], tj, it1 + j, g, None,
                                None)[1]
            total = gj if total is None else O.tree_map(torch.add, total, gj)
        with torch.no_grad():
            manual, _ = O.adam_step(state.params, total, opt, acfg, 1,
                                    S.row_lrs(acfg, 1, S.step_scalars(
                                        acfg, 1, ctx["extent"],
                                        [it1 + 2])[0].to(dev)))
        bits, worst = tree_diff(x[0].params, manual)
        ms_batch = step_ms(batched, bargs(), dev, 3)
        log(f"batched step: loss {float(x[2]['loss']):.6f} (3 renders); "
            f"params equal to three single renders' gradients summed and "
            f"one Adam update: bit for bit {bits}, largest difference "
            f"{worst:.3e} of a leaf's max; run twice identical {twice}; ms "
            f"per batched step {[round(v, 3) for v in ms_batch]} (a single "
            f"step {[round(v, 3) for v in ms_f]}); launches {got}")
        if not twice or worst > 1e-6:
            raise AssertionError("the batched step")
        if not rehearse and got.get("blend_bwd") != 3:
            raise AssertionError("the batched step did not run 3 backwards")
    return launches


HYPER_SIZE = (960, 540)      # a HyperNeRF interp capture's rgb/2x frames


def hyper_argv(scene: str, model: str, rehearse: bool, batch: int):
    """cli.train's argv for the HyperNeRF tree: the chickchicken preset (on
    the CPU rehearsal the `test` preset with --use_time_decay), --ratio 0.5
    (rgb/2x), the every-4th-frame split (max_time 1), and cli_argv's
    schedule compressed onto 6u iterations; --batch as given."""
    argv = cli_argv(scene, model, rehearse)
    i = argv.index("--max_time")
    del argv[i:i + 2]
    argv[argv.index("--preset") + 1] = "test" if rehearse else "chickchicken"
    argv += ["--ratio", "0.5", "--batch", str(batch)]
    if rehearse:
        argv.append("--use_time_decay")
    return argv


def hyper_schedule(cfg, u: int, model_path: str):
    """The fields hyper_argv's flags set, onto 6u iterations, for an
    in-process Trainer, and the gate of step opacity
    (cfg.model.step_opacity_iteration, which no flag sets) moved to u, so
    that the gated opacity trains from stage 1 on."""
    t, o = cfg.train, cfg.opt
    o.iterations = 6 * u
    o.position_lr_max_steps = 4 * u
    o.densify_from_iter, o.densify_until_iter = u, 3 * u + 1
    t.jointly_iteration = u // 2
    t.second_stage_iteration, t.third_stage_iteration = 3 * u, 9 * u // 2
    t.adaptive_from_iter, t.adaptive_interval = u // 5, u // 2
    t.test_iterations = (u // 10, 3 * u, 6 * u)
    t.save_iterations = t.checkpoint_iterations = ()
    cfg.model.step_opacity_iteration = u
    cfg.model_path = model_path


def stage_ms(rec, dev):
    """{stage: [ms an iteration]} from (stage, start, end, iterations)."""
    out = {}
    for st, e0, e1, k in rec:
        ms = e0.elapsed_time(e1) if dev.type == "cuda" else (e1 - e0) * 1e3
        out.setdefault(st, []).extend([ms / k] * k)
    return out


class timed_iterations:
    """Records (stage, start, end, iterations) of every Trainer.train_one
    and train_batch call in the block (CUDA events on the card)."""

    def __init__(self, dev, rec):
        self.dev, self.rec = dev, rec

    def __enter__(self):
        from gaussianprediction_tpu_torch.train import loop as L

        self.saved = (L.Trainer.train_one, L.Trainer.train_batch)
        dev, rec = self.dev, self.rec

        def mark():
            if dev.type == "cuda":
                e = torch.cuda.Event(enable_timing=True)
                e.record()
                return e
            return time.perf_counter()

        def one(tr, it, _f=self.saved[0]):
            e0 = mark()
            m = _f(tr, it)
            rec.append((L.stage_of(tr.cfg, it), e0, mark(), 1))
            return m

        def batch(tr, a, b, _f=self.saved[1]):
            e0 = mark()
            m = _f(tr, a, b)
            rec.append((L.stage_of(tr.cfg, a), e0, mark(), b - a + 1))
            return m

        L.Trainer.train_one, L.Trainer.train_batch = one, batch
        return self

    def __exit__(self, *exc):
        from gaussianprediction_tpu_torch.train import loop as L

        L.Trainer.train_one, L.Trainer.train_batch = self.saved
        return False


def repeat_identical(tr, dev, batch: int) -> bool:
    """One stage-3 step of the Trainer's final state (batch > 1: its
    batched step over the first `batch` training views) run twice from the
    same state with the same draws: loss, params and moments bit for bit."""
    from gaussianprediction_tpu_torch.train import optimizer as O

    views = [tr._view(c) for c in tr.scene.train_cameras[:batch]]
    it = tr.iteration
    outs = []
    for _ in range(2):
        g = torch.Generator(dev).manual_seed(7)
        noises = [torch.randn(tr.state.params["super_xyz"].shape,
                              generator=g, device=dev) for _ in views]
        tns = [torch.randn((), generator=g, device=dev) for _ in views] \
            if tr.cfg.train.use_time_decay else None
        if batch > 1:
            outs.append(tr._batched_step_fn(3, batch)(
                tr.state, tr.opt_state, [v[0] for v in views],
                [v[2] for v in views], [v[1] for v in views], it,
                active_deg=tr.active_sh_degree, noises=noises,
                time_noises=tns))
        else:
            cam_d, t, gt = views[0]
            outs.append(tr._multi_step_fn(3, 1)(
                tr.state, tr.opt_state, [cam_d], [gt], [t], it,
                active_deg=tr.active_sh_degree, noises=noises[:1],
                time_noises=None if tns is None else tns[:1]))
    sync(dev)
    (s1, o1, m1), (s2, o2, m2) = outs
    checked(outs[0], "a repeated stage-3 step")
    return bits_equal(m1["loss"], m2["loss"]) and all(
        bits_equal(x, y) for x, y in zip(
            O.tree_leaves([s1.params, o1["m"], o1["v"]]),
            O.tree_leaves([s2.params, o2["m"], o2["v"]])))


def hypernerf_phases(dev, seed: int, rehearse: bool):
    """Phase 'HyperNeRF': phase 18's synthetic dynamic scene rendered at a
    HyperNeRF interp capture's rgb/2x size (960x540; the rehearsal 64x36)
    and written as a HyperNeRF tree (data/hypernerf.py:write_hypernerf);
    loaded back, every image equal to the written bytes / 255 bit for bit
    and the every-4th-frame split (6 train / 5 test of 23); then
    cli.train --preset chickchicken --batch 2 (use_time_decay; batches of
    2 wherever no host event falls inside) and cli.eval, and an in-process
    `lemon` Trainer (step opacity gated on from iteration u), each through
    stages 0-3 on hyper_argv's schedule: n_dropped 0 on every stream, the
    test PSNR rising from the first report to the last, a stage-3 step
    (the batched one for chickchicken) run twice bit-identical, ms per
    iteration per stage. Returns the launches of the two runs and
    cli.eval."""
    import copy
    import shutil
    import tempfile

    from gaussianprediction_tpu_torch.cli import eval as CE
    from gaussianprediction_tpu_torch.cli import train as CT
    from gaussianprediction_tpu_torch.config import get_preset
    from gaussianprediction_tpu_torch.data.hypernerf import write_hypernerf
    from gaussianprediction_tpu_torch.data.scene import (
        Scene, load_scene_info, synthetic_scene_info,
    )
    from gaussianprediction_tpu_torch.models import deform as D
    from gaussianprediction_tpu_torch.ops import instance_stream as IS
    from gaussianprediction_tpu_torch.train import loop as L

    u = 10 if rehearse else 100
    (w, h), n_pts = ((64, 36), 300) if rehearse else (HYPER_SIZE, 100_000)
    os.makedirs(BUILD_DIR, exist_ok=True)
    root = tempfile.mkdtemp(prefix="gpt_hyper_", dir=BUILD_DIR)
    scene, model = os.path.join(root, "scene"), os.path.join(root, "model")
    launches = {}
    saved_env = os.environ.pop("GPT_FORCE_CPU", None)
    if rehearse:
        os.environ["GPT_FORCE_CPU"] = "1"

    def run(fn, what):
        """fn() with its launches added up and every stream's n_dropped
        checked."""
        drops = []

        def note(name, a, out):
            st = out if isinstance(out, IS.InstanceStream) else out[0]
            drops.append(st.n_dropped)

        with Capture([(IS, "build_instances_fwd")], note):
            out, got = counted_launches(fn, dev)
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        drops = [int(x) for x in drops]
        log(f"HyperNeRF {what}: launches {got}; {len(drops)} instance "
            f"streams, n_dropped {sum(drops)}")
        if any(drops):
            raise AssertionError(f"HyperNeRF {what}: a stream dropped")
        if not rehearse:
            need = CLI_KERNELS if what != "eval" else FWD_KERNELS
            missing = [k for k in need if not got.get(k)]
            if missing:
                raise AssertionError(f"HyperNeRF {what}: not launched "
                                     f"{missing}")
        return out

    def report(tr, rec, what):
        per = stage_ms(rec, dev)
        psnrs = [(h["eval"]["iter"], round(h["eval"]["test_psnr"], 3))
                 for h in tr._history if "eval" in h]
        same = repeat_identical(tr, dev, max(1, tr.cfg.train.batch))
        log(f"HyperNeRF {what}: {tr.iteration} iterations; ms per iteration "
            f"(CUDA events around train_one / train_batch, a batch's time "
            f"split evenly), " + "; ".join(
                f"stage {k}: median {float(np.median(v)):.3f} over {len(v)}"
                for k, v in sorted(per.items()))
            + f"; test PSNR at the reports {psnrs}; {int(tr.state.n_alive())}"
            f" Gaussians, {int(tr.state.n_kpts())} keypoints; a stage-3 "
            f"step run twice identical {same}")
        fails = []
        if sorted(per) != [0, 1, 2, 3]:
            fails.append(f"stages {sorted(per)}")
        if not psnrs or not psnrs[-1][1] > psnrs[0][1]:
            fails.append("the test PSNR did not rise")
        if not same:
            fails.append("a repeated step differs")
        if fails and not (rehearse and fails == ["the test PSNR did not "
                                                 "rise"]):
            raise AssertionError(f"HyperNeRF {what}: {fails}")

    try:
        with Phase("HyperNeRF: write the scene as a HyperNeRF tree"):
            info = synthetic_scene_info(n_points=n_pts, n_cams=20, n_test=3,
                                        width=w, height=h, dynamic=True,
                                        seed=seed, device=dev)
            cams = sorted(info.train_cameras + info.test_cameras,
                          key=lambda c: c.time)
            write_hypernerf(scene, cams, info.points, info.colors)
            cfg = get_preset("chickchicken")
            cfg.source_path, cfg.ratio = scene, 0.5
            bad = []
            for lazy in (True, False):
                li = load_scene_info(cfg, lazy=lazy)
                for c in li.train_cameras + li.test_cameras:
                    src = cams[int(c.image_name)]
                    u8 = (np.clip(src.image, 0.0, 1.0) * 255).astype(np.uint8)
                    if c.time != src.time or not bits_equal(
                            torch.from_numpy(c.load_image()),
                            torch.from_numpy(u8.astype(np.float32) / 255.0)):
                        bad.append((lazy, c.image_name))
            split = ([c.image_name for c in li.train_cameras],
                     [c.image_name for c in li.test_cameras])
            want = ([f"{i:06d}" for i in range(0, 23, 4)],
                    [f"{i:06d}" for i in range(2, 22, 4)])
            log(f"HyperNeRF tree: {len(cams)} frames at {w}x{h} (rgb/2x), "
                f"{n_pts} points; split {len(split[0])} train / "
                f"{len(split[1])} test, every 4th frame {split == want}; "
                f"images equal to the written bytes / 255 bit for bit "
                f"(lazy and eager) {not bad}")
            if bad or split != want:
                raise AssertionError(f"HyperNeRF tree: {bad}, {split}")
            del li

        with Phase("HyperNeRF: cli.train --preset chickchicken --batch 2"):
            argv = hyper_argv(scene, model, rehearse, 2)
            log("HyperNeRF train argv: " + " ".join(argv[4:]))
            rec = []
            with timed_iterations(dev, rec):
                tr = run(lambda: CT.main(argv), "chickchicken")
            batched = sum(1 for r in rec if r[3] > 1)
            log(f"HyperNeRF chickchicken: {batched} batched steps of 2, "
                f"{len(rec) - batched} single iterations; use_time_decay "
                f"{tr.cfg.train.use_time_decay}")
            if not batched or not tr.cfg.train.use_time_decay and \
                    not rehearse:
                raise AssertionError("no batched step or no time decay")
            report(tr, rec, "chickchicken")
            del tr

        with Phase("HyperNeRF: cli.eval"):
            res = run(lambda: CE.main(["-m", model]), "eval")
            with open(os.path.join(res["out_dir"], "results.json")) as f:
                psnr = json.load(f)["PSNR"]
            log(f"HyperNeRF eval: {1e3 / res['fps']:.3f} ms per test view, "
                f"PSNR {psnr}")
            if not np.isfinite(psnr):
                raise AssertionError("HyperNeRF eval: PSNR")

        with Phase("HyperNeRF: a lemon Trainer, step opacity on from u"):
            cfg = get_preset("test" if rehearse else "lemon")
            if rehearse:
                cfg.model.step_opacity = cfg.train.use_time_decay = True
            hyper_schedule(cfg, u, "")
            cfg.source_path, cfg.ratio = scene, 0.5
            lscene = Scene(load_scene_info(cfg, lazy=True), seed=seed)
            tr = L.Trainer(copy.deepcopy(cfg), lscene, seed=seed, device=dev,
                           log_every=u // 2, quiet=True)
            rec, gated = [], []
            try:
                with timed_iterations(dev, rec), \
                        Capture([(D, "sharp_sigmoid")],
                                lambda *a: gated.append(1)):
                    run(tr.run, "lemon")
            finally:
                lscene.close()
            log(f"HyperNeRF lemon: step opacity from iteration "
                f"{cfg.model.step_opacity_iteration + 1} (the preset's gate "
                f"{get_preset('lemon').model.step_opacity_iteration}); the "
                f"gated opacity evaluated {len(gated)} times")
            if not gated:
                raise AssertionError("the gated opacity never ran")
            report(tr, rec, "lemon")
            del tr
    finally:
        os.environ.pop("GPT_FORCE_CPU", None)
        if saved_env is not None:
            os.environ["GPT_FORCE_CPU"] = saved_env
        shutil.rmtree(root, ignore_errors=True)
    log(f"HyperNeRF: launches of the two runs and cli.eval {launches}")
    return launches


def free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def sharded_cfg(scene: str, rehearse: bool, stage: int):
    """The multi-rank Trainer runs' config: the dnerf preset on phase 18's
    scene as a D-NeRF tree (4,096 rows in a rehearsal, as phase 18's),
    warm-up iterations (stage 0) or stage 1 from iteration 1, the xyz and
    time noise annealed off (as the JAX package's own sharded Trainer test
    has them: the sharded step and the reference draw alike, but the
    batched reference's members sit at other iterations), no reports."""
    from gaussianprediction_tpu_torch.config import get_preset

    cfg = get_preset("dnerf")
    if rehearse:
        cfg.model.max_gaussian_size = cfg.model.capacity = 4_096
    cfg.source_path, cfg.model_path = scene, ""
    if stage == 1:
        cfg.train.jointly_iteration = 1
    cfg.train.xyz_noise_iteration = cfg.train.time_noise_iteration = 1
    cfg.train.test_iterations = ()
    return cfg


def state_digest(state, opt_state) -> str:
    """One SHA-1 over the bytes of every tensor of a Trainer's state."""
    import hashlib

    from gaussianprediction_tpu_torch.models.gaussians import STATS
    from gaussianprediction_tpu_torch.train.optimizer import tree_leaves

    h = hashlib.sha1()
    for x in tree_leaves([state.params, opt_state["m"], opt_state["v"],
                          state.alive, state.kpt_alive]
                         + [getattr(state, k) for k in STATS]):
        if x is not None:
            h.update(x.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def accumulated_iteration(tr, it: int, n_data: int):
    """The single-device counterpart of a sharded Trainer iteration: the
    same n_data cameras and draws, their gradients accumulated by
    make_train_step_batched with Adam at `it` (its members at it - n_data
    + 1 .. it: with the noise annealed off, a member's loss does not
    depend on its iteration). Returns the summed loss."""
    stage = tr._start(it)
    cams = [tr.scene.next_train_camera() for _ in range(n_data)]
    views = [tr._view(c) for c in cams]
    noise, time_noises = tr._sharded_noise(stage)
    zero = None if noise is None else torch.zeros_like(noise)
    tr.state, tr.opt_state, m = tr._batched_step_fn(stage, n_data)(
        tr.state, tr.opt_state, [v[0] for v in views], [v[2] for v in views],
        [v[1] for v in views], it - n_data + 1,
        active_deg=tr.active_sh_degree, noises=[zero] * n_data,
        time_noises=time_noises)
    tr._densification(it, stage)
    return float(m["loss"])


def child_main(spec_path: str) -> int:
    """A rank of phase 22's multi-rank runs (python3 chip_smoke.py --child
    spec.json, with RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and
    MASTER_PORT set): a gloo group on the card (or the CPU), the single
    sharded steps of child_steps, then a Trainer(n_devices=WORLD_SIZE,
    n_data=...) for each (stage, n_data) of the spec's runs, `iterations`
    sharded iterations each; writes rank<r>.json."""
    import torch.distributed as dist

    from gaussianprediction_tpu_torch import kernels
    from gaussianprediction_tpu_torch.data.scene import (
        Scene, load_scene_info,
    )
    from gaussianprediction_tpu_torch.parallel.distributed import (
        maybe_initialize_distributed,
    )
    from gaussianprediction_tpu_torch.train.loop import Trainer

    with open(spec_path) as f:
        spec = json.load(f)
    dev = torch.device(spec["device"])
    if dev.type == "cpu":       # four ranks share the rehearsal's cores
        torch.set_num_threads(1)
    maybe_initialize_distributed(verbose=False, device=dev, backend="gloo")
    rank, world = dist.get_rank(), dist.get_world_size()
    out = {"rank": rank, "runs": [], "steps": []}
    if spec.get("step"):
        out["steps"] = child_steps(spec["step"], dev, rank, world,
                                   os.path.dirname(spec_path))
    info = None
    for stage, n_data in spec["runs"]:
        cfg = sharded_cfg(spec["scene"], spec["device"] == "cpu", stage)
        info = info or load_scene_info(cfg)
        tr = Trainer(cfg, Scene(info, seed=spec["seed"]), seed=spec["seed"],
                     device=dev, quiet=True, n_devices=world, n_data=n_data)
        kernels.reset_launch_counts()
        losses, ms, drops = [], [], []
        for it in range(1, spec["iterations"] + 1):
            t0 = time.perf_counter()
            m = tr.train_one_sharded(it)
            losses.append(float(m["loss"]))
            drops.append(int(m["n_dropped"]))
            ms.append((time.perf_counter() - t0) * 1e3)
        out["runs"].append({
            "stage": stage, "n_data": n_data, "losses": losses, "ms": ms,
            "drops": drops,
            "launches": dict(kernels.launch_counts),
            "digest": state_digest(tr.state, tr.opt_state),
            "mesh": [tr.mesh.data_index, tr.mesh.tile_index]})
    with open(os.path.join(os.path.dirname(spec_path),
                           f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def child_steps(step: dict, dev, rank: int, world: int, folder: str):
    """The ranks' single sharded steps: from the saved state, on a 1 x 4
    and a 2 x 2 mesh, the cameras and draws of the spec. Rank 0 writes
    its state after each (step<i>.npz); every rank returns its digests."""
    import copy

    from gaussianprediction_tpu_torch import kernels
    from gaussianprediction_tpu_torch.config import get_preset
    from gaussianprediction_tpu_torch.convert import (
        flatten, opt_state_from_arrays, state_from_params, unflatten,
    )
    from gaussianprediction_tpu_torch.data.synthetic import orbit_camera
    from gaussianprediction_tpu_torch.parallel.mesh import make_mesh
    from gaussianprediction_tpu_torch.parallel.shard import (
        make_sharded_train_step,
    )

    with np.load(step["inputs"]) as f:
        arr = {k: f[k] for k in f.files}

    def under(prefix):
        return {k[len(prefix):]: v for k, v in arr.items()
                if k.startswith(prefix)}

    cfg = get_preset("dnerf")
    cfg.model.capacity_multiplier = step["capacity_multiplier"]
    size = arr["gts"].shape[1]
    cams = [orbit_camera(a, width=size, height=size, time=tm)
            .to_device_dict(dev) for a, tm in zip(step["angles"],
                                                  step["times"])]
    gts = [torch.as_tensor(g, device=dev) for g in arr["gts"]]
    times = [torch.tensor(tm, dtype=torch.float32, device=dev)
             for tm in step["times"]]
    bg = torch.zeros(3, device=dev)
    noise = torch.as_tensor(arr["noise"], device=dev)
    res = []
    for i, (n_data, n_tile) in enumerate(step["meshes"]):
        state = state_from_params(
            unflatten(under("params/")), arr["alive"], device=dev,
            stats={k[6:]: v for k, v in arr.items()
                   if k.startswith("stats/")})
        opt = opt_state_from_arrays(unflatten(under("opt/")), device=dev)
        mesh = make_mesh(n_data, n_tile)
        fn, _ = make_sharded_train_step(
            copy.deepcopy(cfg), 1, size, size, step["extent"],
            cfg.model.sh_degree, 50, bg, mesh,
            capacity_multiplier=step["capacity_multiplier"])
        kernels.reset_launch_counts()
        st, op, m = fn(state, opt, cams[:n_data], gts[:n_data],
                       times[:n_data], step["iteration"], noise=noise)
        sync(dev)
        res.append({"loss": float(m["loss"]),
                    "n_dropped": int(m["n_dropped"]),
                    "digest": state_digest(st, op),
                    "launches": dict(kernels.launch_counts)})
        if rank == 0:
            np.savez(os.path.join(folder, f"step{i}.npz"),
                     xyz_gradient_accum=st.xyz_gradient_accum.cpu().numpy(),
                     denom=st.denom.cpu().numpy(),
                     xyz=st.params["xyz"].cpu().numpy(),
                     **{f"grads/{k}": v
                        for k, v in flatten(m["grads"]).items()})
    return res


def spawn_ranks(spec: dict, folder: str, world: int, timeout: float):
    """Run `world` child ranks of this script on the spec; returns their
    rank<r>.json. A rank that fails, or one that outlives `timeout` (all
    are killed then), fails the phase."""
    path = os.path.join(folder, "spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    port = free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                   LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port))
        env.pop("GPT_DIST", None)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--child", path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env))
    outs, t_end = [], time.monotonic() + timeout
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(1.0, t_end - time.monotonic()))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        said = [p.communicate()[0] or "" for p in procs[len(outs):]]
        raise AssertionError(
            f"a rank outlived the {timeout} s limit:\n" + "\n".join(
                o[-1500:] for o in outs + said))
    failed = [f"rank {rank} (exit {p.returncode}):\n{o[-2000:]}"
              for rank, (p, o) in enumerate(zip(procs, outs))
              if p.returncode != 0]
    if failed:
        raise AssertionError("\n".join(failed))
    res = []
    for rank in range(world):
        with open(os.path.join(folder, f"rank{rank}.json")) as f:
            res.append(json.load(f))
    return res


def multi_rank_phase(dev, info, ctx, views, seed: int, rehearse: bool):
    """Phase 22's several ranks on one card (sharded_phases says what they
    check). Returns the ranks' launches, summed."""
    import shutil
    import tempfile

    from gaussianprediction_tpu_torch.convert import flatten
    from gaussianprediction_tpu_torch.data.blender import (
        write_nerf_synthetic,
    )
    from gaussianprediction_tpu_torch.data.scene import (
        Scene, load_scene_info,
    )
    from gaussianprediction_tpu_torch.kernels import build
    from gaussianprediction_tpu_torch.models.gaussians import STATS
    from gaussianprediction_tpu_torch.parallel import distributed as PD
    from gaussianprediction_tpu_torch.train.loop import Trainer
    from gaussianprediction_tpu_torch.train.step import (
        make_train_step, make_train_step_batched,
    )

    launches = {}

    def add(got):
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v

    with Phase("sharded: 4 ranks on one card (gloo)"):
        if dev.type == "cuda":
            ok, said = PD.probe_gloo_cuda()
            log(f"gloo takes CUDA tensors (all_gather, sum and max "
                f"all_reduce, 2 ranks on cuda:0): {ok}")
            if not ok:
                log("gloo refuses CUDA tensors; several ranks on one card "
                    "are not run:\n" + said[-2000:])
                return launches
        os.makedirs(BUILD_DIR, exist_ok=True)
        root = tempfile.mkdtemp(prefix="gpt_sharded_", dir=BUILD_DIR)
        try:
            # the single steps' inputs: the training cell's stage-1 state
            # and Adam state, views 0 and 1, a target each, one draw
            cfg, st, op = ctx["cfg"], ctx["state"], ctx["opt"]
            size = ctx["gt"].shape[0]
            gts = [ctx["gt"], ctx["gt"].flip(1)]
            g = torch.Generator(dev).manual_seed(seed + 23)
            noise = torch.randn(st.params["xyz"].shape, generator=g,
                                device=dev)
            step = {"inputs": os.path.join(root, "state.npz"),
                    "angles": [0.5, 1.7], "times": [v.time
                                                     for v in views[:2]],
                    "capacity_multiplier": cfg.model.capacity_multiplier,
                    "extent": ctx["extent"], "iteration": 19_990,
                    "meshes": [[1, 4], [2, 2]]}
            arrays = {f"params/{k}": v
                      for k, v in flatten(st.params).items()}
            arrays.update({f"opt/{k}": v for k, v in flatten(op).items()})
            arrays.update({f"stats/{k}": getattr(st, k).cpu().numpy()
                           for k in STATS})
            arrays.update(alive=st.alive.cpu().numpy(), noise=noise.cpu()
                          .numpy(), gts=torch.stack(gts).cpu().numpy())
            np.savez(step["inputs"], **arrays)
            cams = [views[k].to_device_dict(dev) for k in range(2)]
            ts = [torch.tensor(v.time, dtype=torch.float32, device=dev)
                  for v in views[:2]]
            bg = torch.zeros(3, device=dev)
            sh = cfg.model.sh_degree
            it = step["iteration"]
            step_refs = []
            for s_, o_, m_ in (
                    make_train_step(cfg, 1, size, size, ctx["extent"], sh,
                                    50, bg)(st, op, cams[0], gts[0], ts[0],
                                            it, noise=noise),
                    make_train_step_batched(cfg, 1, size, size,
                                            ctx["extent"], sh, 50, bg, 2)(
                        st, op, cams, gts, ts, it - 1,
                        noises=[noise, noise])):
                step_refs.append((float(m_["loss"]), flatten(m_["grads"]),
                                  s_.xyz_gradient_accum.cpu().numpy(),
                                  s_.denom.cpu().numpy(),
                                  s_.params["xyz"].cpu().numpy()))
            del s_, o_, m_

            # the Trainer runs' scene and their references, decoded here
            scene = os.path.join(root, "scene")
            write_nerf_synthetic(scene, sorted(
                info.train_cameras + info.test_cameras,
                key=lambda c: c.time), info.points, info.colors)
            spec = {"scene": scene, "seed": seed, "device": dev.type,
                    "runs": [[0, 1], [0, 2], [1, 1], [1, 2]],
                    "iterations": 4, "step": step}
            refs, loaded = [], None
            for stage, n_data in spec["runs"]:
                cfg_r = sharded_cfg(scene, rehearse, stage)
                loaded = loaded or load_scene_info(cfg_r)
                tr = Trainer(cfg_r, Scene(loaded, seed=seed), seed=seed,
                             device=dev, quiet=True, n_data=n_data)
                refs.append([
                    float(tr.train_one(i)["loss"]) if n_data == 1
                    else accumulated_iteration(tr, i, n_data)
                    for i in range(1, spec["iterations"] + 1)])
                del tr
            if dev.type == "cuda":
                build.library()          # built once, before the ranks
                torch.cuda.empty_cache()
                free, total = torch.cuda.mem_get_info()
                log(f"device memory before the ranks: {free / 2**30:.1f} "
                    f"GiB free of {total / 2**30:.1f}")
            t0 = time.perf_counter()
            ranks = spawn_ranks(spec, root, 4, timeout=600)
            spawn_s = time.perf_counter() - t0
            for r in ranks:
                for run in r["steps"] + r["runs"]:
                    add(run["launches"])

            # the single steps (inside the densify window, so the
            # statistics move): the JAX package's bars for its sharded step
            # against its single step (tests/test_parallel.py: the loss,
            # xyz_gradient_accum); each gradient leaf within GCN_GRAD_TOL
            # of its largest magnitude, the card-against-reference bound of
            # the GCN phase (the band backward above prints what reordering
            # the same sums alone moves a leaf at this width: 3e-4). The
            # parameters after Adam are printed, not held: Adam's eps of
            # 1e-15 turns the roundoff of a gradient that is ~0 (an
            # occluded Gaussian's, the deform MLP's) into a +-lr step of
            # either sign.
            for i, (ref, mesh) in enumerate(zip(step_refs, step["meshes"])):
                runs = [r["steps"][i] for r in ranks]
                with np.load(os.path.join(root, f"step{i}.npz")) as f:
                    got = {k: f[k] for k in f.files}
                rel = abs(runs[0]["loss"] - ref[0]) / abs(ref[0])
                g_err, g_leaf = max(
                    (float(np.abs(got[f"grads/{k}"] - v).max())
                     / max(float(np.abs(v).max()), 1e-30), k)
                    for k, v in ref[1].items())
                p_err = float(np.abs(got["xyz"] - ref[4]).max())
                a_err = float(np.abs(got["xyz_gradient_accum"]
                                     - ref[2]).max())
                d_same = bool(np.array_equal(got["denom"], ref[3]))
                one = len({run["digest"] for run in runs}) == 1
                what = "make_train_step" if mesh[0] == 1 else \
                    "the batched step of its 2 views"
                log(f"one sharded step, mesh {mesh[0]} x {mesh[1]} (the "
                    f"training cell's stage-1 state) against {what}"
                    f": loss {runs[0]['loss']:.6f} / {ref[0]:.6f} (relative "
                    f"{rel:.3e}); gradients: largest difference {g_err:.3e}"
                    f" of a leaf's max ({g_leaf}); xyz after Adam "
                    f"{p_err:.3e}; "
                    f"xyz_gradient_accum {a_err:.3e}; denom equal {d_same}; "
                    f"n_dropped {runs[0]['n_dropped']}; the 4 ranks' "
                    f"states bit-identical {one}")
                if not (rel <= 1e-4 and g_err <= GCN_GRAD_TOL
                        and a_err <= 1e-5
                        and d_same and one and not runs[0]["n_dropped"]):
                    raise AssertionError(f"the {mesh} sharded step")

            # the Trainers: warm-up iterations at the JAX package's 2e-4
            # (its sharded Trainer test runs warm-up); stage 1 at its 3e-2
            for i, ((stage, n_data), ref) in enumerate(zip(spec["runs"],
                                                          refs)):
                runs = [r["runs"][i] for r in ranks]
                got = runs[0]["losses"]
                rel = max(abs(a - b) / abs(b) for a, b in zip(got, ref))
                one = len({run["digest"] for run in runs}) == 1
                bound = 2e-4 if stage == 0 else 3e-2
                log(f"Trainer(n_devices=4, n_data={n_data}), stage {stage},"
                    f" on 4 gloo ranks: mesh positions "
                    f"{[run['mesh'] for run in runs]}; losses "
                    f"{[round(x, 6) for x in got]} against the "
                    f"single-device Trainer's {[round(x, 6) for x in ref]} "
                    f"(largest relative difference {rel:.3e}, bound "
                    f"{bound}); n_dropped {runs[0]['drops']}; the 4 ranks' "
                    f"states bit-identical {one}; rank 0 ms per iteration "
                    f"{[round(x, 1) for x in runs[0]['ms']]}; launches "
                    f"(rank 0) {runs[0]['launches']}")
                if not (rel <= bound and one) or any(runs[0]["drops"]):
                    raise AssertionError(f"the sharded Trainer, stage "
                                         f"{stage}, n_data {n_data}")
            log(f"4 ranks: {spawn_s:.1f} s from spawn to exit")
        finally:
            shutil.rmtree(root, ignore_errors=True)
    return launches


def sharded_phases(cfg, dev, rstate, iteration, views, ctx, info, seed: int,
                   rehearse: bool, reps: int):
    """Phase 22 ("sharded"): the multi-GPU path (parallel/) on one card.

    Bands, no collectives: phase 6's model and first view rendered as 4
    bands of 13 tile rows (the last one reaching below the image) and as
    50 bands of one row, each at its band multiplier; the bands stitch to
    the whole render bit for bit on every tile row that no capped rect
    touches (a band caps its clamped rect, the JAX order; the capped count
    is printed), n_dropped 0, each band's slot count equal to
    probe_slot_need(tile_band=...) on the bands no capped rect touches,
    #1 equal to its plain version bit for bit on one band's stream; #1's
    device ms on the 4 band streams beside the whole frame's.

    The band backward: an L1 loss summed over the 4 bands' renders,
    backpropagated band by band, against the whole frame's: the
    per-Gaussian feature gradients (the stream backward's output) within
    64 * 2^-24 * the largest |cumsum| of the streams' sorted cotangents
    (phase 12b's bound: the same terms, reduced per band and then summed,
    so the prefix sums associate otherwise), the Gaussians whose rects
    touch a capped rect's rows left out; #6 equal to its plain version
    bit for bit (sums="kernel") on one band, its device ms beside the
    whole frame's.

    The sharded step at world size 1 (nccl on the card, gloo in a
    rehearsal; mesh 1 x 1) from the training cell's stage-1 state and its
    stage-2 hash-grid state, against make_train_step on the same draws:
    loss, every gradient leaf, the parameters, Adam moments and statistics
    equal bit for bit (one band holds the frame, and the step then takes
    the single step's loss), twice bit-identical; ms per step beside the
    single step's.

    Several ranks on the one card: nccl refuses two ranks on one GPU, so
    where gloo's all-gather and all-reduces take CUDA tensors
    (parallel/distributed.py:probe_gloo_cuda, 2 ranks), 4 ranks of this
    script run on cuda:0, the kernel library built here first, each rank's
    state held bit-identical to rank 0's. One sharded step on a 1 x 4 and
    a 2 x 2 mesh from the training cell's stage-1 state, against
    make_train_step (and the batched step of the two views) in this
    process: the loss within 1e-4 relative and xyz_gradient_accum within
    1e-5 (the JAX package's bars for its sharded step,
    tests/test_parallel.py), every gradient leaf within 1e-3 of its
    largest magnitude (GCN_GRAD_TOL, the GCN phase's card-against-
    reference bound; the band backward prints what reordering the same
    sums alone moves a leaf), denom equal. Then Trainer(n_devices=4,
    n_data=1 and 2) over 4 warm-up and 4 stage-1 iterations of phase
    18's scene (written as a D-NeRF tree), against the single-device
    Trainer on the same cameras and draws (n_data=2: the two cameras
    accumulated by make_train_step_batched): the warm-up losses within
    the JAX package's 2e-4 relative (its tests/test_parallel.py:151, a
    warm-up run), the stage-1 losses within its 3e-2 (:201): Adam's eps
    of 1e-15 turns the roundoff of the deform MLP's ~0 gradients into
    +-lr steps of either sign, and the trajectories drift (PERF.md §6,
    PR 17). Where gloo refuses, the phase says so and runs the
    world-size-1 checks only.

    Returns the launches of the bands, the band backward, the sharded
    steps and the ranks' Trainers (counts set to 0 before each)."""
    import torch.distributed as dist

    from gaussianprediction_tpu_torch import kernels
    from gaussianprediction_tpu_torch.models.gaussians import get_shs
    from gaussianprediction_tpu_torch.ops import instance_stream as IS
    from gaussianprediction_tpu_torch.ops import rasterize_kernels as rk
    from gaussianprediction_tpu_torch.ops.instance_stream import (
        probe_slot_need,
    )
    from gaussianprediction_tpu_torch.ops.rasterize import render
    from gaussianprediction_tpu_torch.parallel import distributed as PD
    from gaussianprediction_tpu_torch.parallel.mesh import make_mesh
    from gaussianprediction_tpu_torch.parallel.shard import (
        band_geometry, band_multiplier, make_sharded_train_step,
    )
    from gaussianprediction_tpu_torch.train.step import (
        deform_for_stage, make_train_step,
    )

    launches = {}

    def add(got):
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v

    gt = ctx["gt"]
    size = gt.shape[0]
    grid_y = -(-size // 16)
    cam = views[0].to_device_dict(dev)
    t = torch.tensor(views[0].time, dtype=torch.float32, device=dev)
    bg_t = torch.zeros(3, device=dev)
    sh = cfg.model.sh_degree
    mult = float(cfg.model.capacity_multiplier)
    with torch.no_grad():
        d = deform_for_stage(rstate.params, cfg, rstate, t, iteration, None,
                             1)
        shs = get_shs(rstate.params)
    geo = (d.xyz, d.scaling, d.rotation, d.opacity)
    kw = dict(sh_degree=sh, alive=rstate.alive)

    with Phase("sharded: tile bands on one card (4 x 13 and 50 x 1 rows)"):
        with torch.no_grad(), Capture([(rk, "rasterize_binned")]) as fcap:
            whole = render(*geo, shs, cam, size, size, bg_t,
                           capacity_multiplier=mult, **kw)
        proj = whole["proj"]
        area = (proj.tiles_max - proj.tiles_min).clamp(min=0).prod(-1)
        capped = proj.visible & (area > 1024)
        rows_ok = torch.ones(grid_y, dtype=torch.bool, device=dev)
        for y0, y1 in zip(proj.tiles_min[capped, 1].tolist(),
                          proj.tiles_max[capped, 1].tolist()):
            rows_ok[y0:y1] = False
        px_ok = rows_ok.repeat_interleave(16)[:size]
        band_args = {}
        for n_tile in (4, 50):
            band, _ = band_geometry(size, n_tile)
            bm = band_multiplier(mult, size, n_tile)
            parts, probe_bad, probe_n, drops = [], 0, 0, 0
            kernels.reset_launch_counts()
            for k in range(n_tile):
                tb = (k * band, band)
                with torch.no_grad(), Capture([(rk, "rasterize_binned")]) \
                        as bcap:
                    out = render(*geo, shs, cam, size, size, bg_t,
                                 capacity_multiplier=bm, tile_band=tb, **kw)
                parts.append(out)
                drops += int(out["n_dropped"])
                if n_tile == 4:
                    band_args[k] = bcap.args["rasterize_binned"][0]
                if bool(rows_ok[k * band:(k + 1) * band].all()):
                    probe_n += 1
                    with torch.no_grad():
                        need = int(probe_slot_need(
                            *geo, cam, size, size, alive=rstate.alive,
                            tile_band=tb))
                    probe_bad += need != int(out["n_instances"])
            sync(dev)
            add(kernels.launch_counts)
            same = {}
            for key in ("render", "depth", "alpha", "tidx"):
                st = torch.cat([p[key] for p in parts])[:size]
                a, b = st[px_ok], whole[key][px_ok]
                same[key] = bits_equal(a, b) if a.dtype == torch.float32 \
                    else torch.equal(a, b)
            slots = sum(int(p["n_instances"]) for p in parts)
            log(f"bands {n_tile} x {band} rows (multiplier {bm:.3f}): "
                f"stitched equal to the whole render bit for bit {same} on "
                f"{int(rows_ok.sum())} of {grid_y} tile rows "
                f"({int(capped.sum())} capped rects); n_dropped {drops}; "
                f"slots {slots} (whole view {int(whole['n_instances'])}); "
                f"probe_slot_need equal on"
                f" {probe_n - probe_bad} of {probe_n} bands")
            if not all(same.values()) or drops or probe_bad:
                raise AssertionError(f"the {n_tile} bands")
        with torch.no_grad():
            a = rk.rasterize_binned(*band_args[1])
            ref = rk.rasterize_binned_plain(*band_args[1])
        sync(dev)
        f_same = bits_equal(a, ref)
        whole_fwd = lambda: rk.rasterize_binned(  # noqa: E731
            *fcap.args["rasterize_binned"][0])
        bands_fwd = lambda: [rk.rasterize_binned(*band_args[k])  # noqa: E731
                             for k in range(4)]
        each = [round(time_ms(lambda k=k: rk.rasterize_binned(
            *band_args[k]), dev, reps), 4) for k in range(4)]
        log(f"blend_fwd on band 1's stream equal to its plain version bit "
            f"for bit {f_same}; device ms: whole frame "
            f"{device_ms_of(whole_fwd, dev, reps)}, the 4 bands in turn "
            f"{device_ms_of(bands_fwd, dev, reps)}; event ms: whole frame "
            f"{time_ms(whole_fwd, dev, reps):.4f}, each band {each}")
        if not f_same:
            raise AssertionError("blend_fwd disagrees on a band stream")

    with Phase("sharded: the band backward on one card (4 bands, L1)"):
        denom = float(size * size * 3)
        C = d.xyz.shape[0]

        def leaves():
            return [x.detach().clone().requires_grad_(True)
                    for x in geo + (shs, torch.zeros((C, 2), device=dev))]

        def sorted_mass(cap):
            (gid, _, dinst), _ = cap.args["build_instances_bwd"]
            srt = dinst[:10].index_select(1, torch.sort(
                gid.to(torch.int32), stable=True).indices)
            return float(torch.cumsum(srt, dim=1).abs().max())

        lw = leaves()
        with Capture([(IS, "build_instances_bwd"),
                      (rk, "rasterize_binned_bwd")]) as wcap:
            out = render(*lw[:5], cam, size, size, bg_t,
                         capacity_multiplier=mult, means2d_dummy=lw[5], **kw)
            ((out["render"] - gt).abs().sum() / denom).backward()
        tol = sorted_mass(wcap)
        lb = leaves()
        band, _ = band_geometry(size, 4)
        bm = band_multiplier(mult, size, 4)
        dfeat = torch.zeros_like(wcap.out["build_instances_bwd"])
        bwd_args = []
        kernels.reset_launch_counts()
        for k in range(4):
            y0 = k * band * 16
            rows = min(size, y0 + band * 16) - y0
            with Capture([(IS, "build_instances_bwd"),
                          (rk, "rasterize_binned_bwd")]) as bcap:
                out = render(*lb[:5], cam, size, size, bg_t,
                             capacity_multiplier=bm, tile_band=(k * band,
                                                                band),
                             means2d_dummy=lb[5], **kw)
                ((out["render"][:rows] - gt[y0:y0 + rows]).abs().sum()
                 / denom).backward()
            dfeat += bcap.out["build_instances_bwd"]
            tol += sorted_mass(bcap)
            bwd_args.append(bcap.args["rasterize_binned_bwd"][0])
        sync(dev)
        add(kernels.launch_counts)
        tol *= 64 * EPS32
        # the Gaussians whose rect rows miss every row a capped rect
        # touches: the counts of such rows below each row, differenced
        bad = torch.cat([rows_ok.new_zeros(1, dtype=torch.int64),
                         torch.cumsum((~rows_ok).to(torch.int64), 0)])
        ok = bad[proj.tiles_max[:, 1].clamp(0, grid_y).long()] == \
            bad[proj.tiles_min[:, 1].clamp(0, grid_y).long()]
        derr = float((dfeat - wcap.out["build_instances_bwd"])[ok].abs()
                     .max())
        worst = max(float((x.grad - y.grad).abs().max())
                    / max(float(y.grad.abs().max()), 1e-30)
                    for x, y in zip(lb, lw))
        a = rk.rasterize_binned_bwd(*bwd_args[1])
        b = rk.rasterize_binned_bwd(*bwd_args[1])
        ref = rk.rasterize_binned_bwd_plain(*bwd_args[1],
                                            sums=wrapper_sums(dev))
        sync(dev)
        b_same = bits_equal(a, ref) and bits_equal(a, b)
        whole_bwd = lambda: rk.rasterize_binned_bwd(  # noqa: E731
            *wcap.args["rasterize_binned_bwd"][0])
        bands_bwd = lambda: [rk.rasterize_binned_bwd(*x)  # noqa: E731
                             for x in bwd_args]
        each = [round(time_ms(lambda x=x: rk.rasterize_binned_bwd(*x), dev,
                              reps), 4) for x in bwd_args]
        log(f"band backward: per-Gaussian feature gradients summed over the "
            f"4 bands against the whole frame's, on {int(ok.sum())} of {C} "
            f"Gaussians: max |diff| {derr:.3e} (64 * 2^-24 * max |cumsum| "
            f"{tol:.3e}); leaf gradients: largest difference {worst:.3e} of "
            f"a leaf's max; blend_bwd on band 1 equal to its plain version "
            f"bit for bit and across 2 launches {b_same}; device ms: whole "
            f"frame {device_ms_of(whole_bwd, dev, reps)}, the 4 bands in "
            f"turn {device_ms_of(bands_bwd, dev, reps)}; event ms: whole "
            f"frame {time_ms(whole_bwd, dev, reps):.4f}, each band {each}")
        if not (derr <= tol and b_same):
            raise AssertionError("the band backward")

    env = {"GPT_DIST": "1", "RANK": "0", "WORLD_SIZE": "1",
           "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(free_port())}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        with Phase("sharded: the sharded step at world size 1"):
            PD.maybe_initialize_distributed(device=dev)
            mesh = make_mesh(1, 1)
            extent = ctx["extent"]
            s2 = ctx["s2_cfg"].train.second_stage_iteration
            for stage, scfg, st, op, it in (
                    (1, ctx["cfg"], ctx["state"], ctx["opt"], 20_005),
                    (2, ctx["s2_cfg"], ctx["s2_trans"], ctx["s2_opt"],
                     s2 + 1)):
                g = torch.Generator(dev).manual_seed(seed + 22)
                rows = st.params["xyz" if stage == 1 else "super_xyz"]
                noise = torch.randn(rows.shape, generator=g, device=dev)
                tn = torch.randn((), generator=g, device=dev)
                single = make_train_step(scfg, stage, size, size, extent, sh,
                                         50, bg_t)
                step, _ = make_sharded_train_step(
                    scfg, stage, size, size, extent, sh, 50, bg_t, mesh,
                    capacity_multiplier=scfg.model.capacity_multiplier)
                sargs = (st, op, cam, gt, t, it, None, None, noise, tn)
                margs = (st, op, [cam], [gt], [t], it, None, None, noise,
                         [tn])
                ref = checked(single(*sargs), f"stage-{stage} single step")
                got, n1 = counted_launches(lambda: checked(
                    step(*margs), f"stage-{stage} sharded step"), dev)
                add(n1)
                again = step(*margs)
                same = bits_equal(got[2]["loss"], ref[2]["loss"]) and all(
                    tree_diff(x, y)[0] for x, y in (
                        (got[2]["grads"], ref[2]["grads"]),
                        (got[0].params, ref[0].params),
                        ([got[1]["m"], got[1]["v"]],
                         [ref[1]["m"], ref[1]["v"]])))
                stats = all(torch.equal(getattr(got[0], k), getattr(
                    ref[0], k)) for k in ("xyz_gradient_accum", "denom",
                                          "max_radii2D"))
                twice = tree_diff([again[0].params, again[2]["grads"]],
                                  [got[0].params, got[2]["grads"]])[0]
                ms_m = step_ms(step, margs, dev, 3)
                ms_s = step_ms(single, sargs, dev, 3)
                log(f"stage {stage} ({dist.get_backend()}, mesh 1 x 1): "
                    f"loss {float(got[2]['loss']):.6f}; loss, gradients, "
                    f"params and moments equal to make_train_step's bit "
                    f"for bit {same}, statistics {stats}; twice "
                    f"bit-identical {twice}; ms per step sharded "
                    f"{[round(x, 3) for x in ms_m]}, single "
                    f"{[round(x, 3) for x in ms_s]}; launches {n1}")
                if not (same and stats and twice):
                    raise AssertionError(f"the stage-{stage} sharded step")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    add(multi_rank_phase(dev, info, ctx, views, seed, rehearse))
    return launches


MULTI_K = 4          # phase 23's iterations a call


def multi_runs_equal(a, b) -> bool:
    """Two (state, opt_state, metrics) bit for bit: params, Adam moments
    and step, the statistics, the masks and the metrics."""
    from gaussianprediction_tpu_torch.models.gaussians import STATS

    (sa, oa, ma), (sb, ob, mb) = a, b
    masks = [(sa.alive, sb.alive), (sa.kpt_alive, sb.kpt_alive)]
    return tree_diff([sa.params, oa["m"], oa["v"], ma["grads"]],
                     [sb.params, ob["m"], ob["v"], mb["grads"]])[0] and \
        torch.equal(oa["step"], ob["step"]) and \
        all(x is y or torch.equal(x, y) for x, y in masks) and \
        all(bits_equal(getattr(sa, k), getattr(sb, k)) for k in STATS) and \
        all(bits_equal(ma[k], mb[k])
            for k in ("loss", "l1", "psnr", "n_dropped"))


def check_sync_detector(dev) -> None:
    """Raise unless sync-debug 'error' refuses what the step's path once
    did on every step: a 0-d tensor made from a host scalar on the card
    and a copy of a host tensor there (both block the host until the card
    has run all it was given)."""
    for what, fn in (("torch.tensor(x, device=cuda)",
                      lambda: torch.tensor(0.9, device=dev)),
                     ("a pageable host-to-device copy",
                      lambda: torch.ones(3).to(dev))):
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn()
            caught = False
        except RuntimeError:
            caught = True
        finally:
            torch.cuda.set_sync_debug_mode(0)
        if not caught:
            raise AssertionError(f"sync-debug 'error' let {what} pass")


def trace_busy(path: str):
    """(kernel names, device-busy share) of a torch.profiler Chrome trace:
    the kernels' summed durations over the span of all timed events."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "ts" in e]
    kern = [e for e in events if e.get("cat") == "kernel"]
    t0 = min(float(e["ts"]) for e in events)
    t1 = max(float(e["ts"]) + float(e.get("dur", 0)) for e in events)
    busy = sum(float(e.get("dur", 0)) for e in kern)
    return {e["name"] for e in kern}, busy / max(t1 - t0, 1e-9), \
        (t1 - t0) / 1e3


def multi_phases(dev, ctx, info, seed: int, rehearse: bool, reps: int):
    """Phase 23 ("multi"): several iterations a call.

    (1) make_train_step_multi(K = 4) from the training cell's stage-1
    state (iterations densify_until_iter - 2 .. + 1, so the statistics'
    flag turns off inside the call) and its stage-2 hash-grid state at the
    transition, under the classic blend and under GPT_BLEND_SMT=4, against
    4 single steps on the same draws: params, Adam moments and step, the
    statistics and the last metrics bit for bit; then the multi call once
    more under torch.cuda.set_sync_debug_mode("error") (after the first
    call: a host synchronisation inside it raises), equal again; the ms
    an iteration of the multi call and of the 4 single calls (CUDA
    events, median of 3) and each one's device-busy share in a profiler
    window, printed, not claimed.
    (2) Trainer(steps_per_call=4) against Trainer(steps_per_call=1) on
    phase 18's scene over 88 iterations of trainer_schedule at u = 20
    (densify at 40, 60 and 80, the 1 -> 2 transition at 81):
    state_digest equal. The chunked run traces iterations 41-44 (one
    chunk) through cfg.train.profile_*: the Chrome trace on disk, holding
    the step's hand-written kernels by their __global__ names, its
    device-busy share printed.

    Returns the launches of the multi calls and the two Trainers (counts
    set to 0 before each)."""
    import glob
    import shutil
    import tempfile

    from gaussianprediction_tpu_torch.config import get_preset
    from gaussianprediction_tpu_torch.data.scene import Scene
    from gaussianprediction_tpu_torch.train import loop as L
    from gaussianprediction_tpu_torch.train.step import (
        make_train_step, make_train_step_multi,
    )

    K = MULTI_K
    n = 1 if rehearse else 3
    launches = {}

    def add(got):
        for name, v in got.items():
            launches[name] = launches.get(name, 0) + v

    cam, gt, t, bg_t = ctx["cam"], ctx["gt"], ctx["t"], ctx["bg_t"]
    extent, size = ctx["extent"], ctx["gt"].shape[0]
    sh = ctx["cfg"].model.sh_degree
    s2_it = ctx["s2_cfg"].train.second_stage_iteration + 1
    cases = ((1, ctx["cfg"], ctx["state"], ctx["opt"],
              ctx["cfg"].opt.densify_until_iter - 2),
             (2, ctx["s2_cfg"], ctx["s2_trans"], ctx["s2_opt"], s2_it))
    # the rehearsal leaves out SMT 4 (its plain walks take minutes on the
    # CPU; phase 12 rehearses them) and the profiler windows
    blends = (("classic", {}),) + (() if rehearse else (("smt 4", SMT_ENV),))
    for blend, env in blends:
        for stage, scfg, st, op, it0 in cases:
            with Phase(f"multi: K = {K} at stage {stage}, {blend}"), \
                    variant_env(env):
                g = torch.Generator(dev).manual_seed(seed + 23)
                rows = st.params["xyz" if stage == 1 else "super_xyz"]
                noises = [torch.randn(rows.shape, generator=g, device=dev)
                          for _ in range(K)]
                tnoises = [torch.randn((), generator=g, device=dev)
                           for _ in range(K)] \
                    if scfg.train.use_time_decay else [None] * K
                single = make_train_step(scfg, stage, size, size, extent,
                                         sh, 50, bg_t)
                multi = make_train_step_multi(scfg, stage, size, size,
                                              extent, sh, 50, bg_t, K)

                def singles():
                    s, o = st, op
                    for i in range(K):
                        s, o, m = single(s, o, cam, gt, t, it0 + i,
                                         noise=noises[i],
                                         time_noise=tnoises[i])
                    return s, o, m

                def call():
                    return multi(st, op, [cam] * K, [gt] * K, [t] * K, it0,
                                 noises=noises, time_noises=tnoises)

                ref = checked(singles(), f"stage-{stage} single steps")
                got, n1 = counted_launches(
                    lambda: checked(call(), f"stage-{stage} multi step"),
                    dev)
                add(n1)
                if dev.type == "cuda":
                    sync(dev)
                    torch.cuda.set_sync_debug_mode("error")
                    try:
                        again = call()
                    finally:
                        torch.cuda.set_sync_debug_mode(0)
                    check_sync_detector(dev)
                else:
                    again = call()
                sync(dev)
                same = multi_runs_equal(got, ref)
                twice = multi_runs_equal(again, ref)
                ms_m = [x / K for x in step_ms(call, (), dev, n)]
                ms_s = [x / K for x in step_ms(singles, (), dev, n)]
                log(f"stage {stage}, {blend}: iterations {it0}-{it0 + K - 1}"
                    f", loss {float(got[2]['loss']):.6f}; the multi step "
                    f"equal to {K} single steps bit for bit {same}; under "
                    f"sync-debug 'error' (no host synchronisation inside "
                    f"the call) equal again {twice}; ms an iteration: multi "
                    f"{[round(x, 3) for x in ms_m]} (median "
                    f"{float(np.median(ms_m)):.3f}), singles "
                    f"{[round(x, 3) for x in ms_s]} (median "
                    f"{float(np.median(ms_s)):.3f}); launches {n1}")
                if not rehearse:
                    profile(call, dev, f"the multi call (K = {K}), stage "
                            f"{stage}, {blend}", reps=1, top=0)
                    profile(singles, dev, f"{K} single calls, stage "
                            f"{stage}, {blend}", reps=1, top=0)
                want = ("stack", "expand", "interleave") + (
                    ("blend_fwd_smt", "blend_bwd_smt") if env
                    else ("blend_fwd", "blend_bwd")) + (
                    ("scatter_add_sorted",) if stage == 2 else ())
                missing = [k for k in want if n1.get(k, 0) < K]
                if not (same and twice) or (not rehearse and missing):
                    raise AssertionError(
                        f"the stage-{stage} multi step ({blend}): bit for "
                        f"bit {same}, again {twice}, not launched {missing}")

    tmp = tempfile.mkdtemp(prefix="gpt_multi_")
    try:
        with Phase(f"multi: Trainer(steps_per_call={K}) against "
                   f"steps_per_call=1"):
            chunks, digests = [], []

            class Chunked(L.Trainer):
                def train_chunk(self, a, b):
                    if b > a:       # train_one is a chunk of one
                        chunks.append((a, b))
                    return super().train_chunk(a, b)

            for k in (1, K):
                cfg = get_preset("dnerf")
                if rehearse:
                    cfg.model.max_gaussian_size = cfg.model.capacity = 4_096
                trainer_schedule(cfg, 20, os.path.join(tmp, f"k{k}"))
                cfg.train.test_iterations = ()
                cfg.train.checkpoint_iterations = ()
                cfg.train.save_iterations = ()
                if k > 1:
                    cfg.train.profile_from, cfg.train.profile_steps = 41, K
                tr = Chunked(cfg, Scene(info, seed=seed), seed=seed,
                             device=dev, quiet=True, steps_per_call=k)
                t0 = time.perf_counter()
                _, nk = counted_launches(lambda: tr.run(iterations=88), dev)
                add(nk)
                digests.append(state_digest(tr.state, tr.opt_state))
                log(f"steps_per_call={k}: 88 iterations in "
                    f"{time.perf_counter() - t0:.2f} s, {int(tr.state.n_alive())}"
                    f" Gaussians, {int(tr.state.n_kpts())} keypoints, "
                    f"digest {digests[-1][:16]}, launches {nk}")
            files = glob.glob(os.path.join(tmp, f"k{K}", "profile", "*.json"))
            log(f"chunks {chunks}; digests equal {digests[0] == digests[1]};"
                f" trace files {[os.path.basename(f) for f in files]}")
            if digests[0] != digests[1] or not chunks or len(files) != 1:
                raise AssertionError("the chunked Trainer")
            names, share, span = trace_busy(files[0])
            want = [DEVICE_NAMES[k][0] for k in FWD_KERNELS + ("blend_bwd",)]
            missing = [w for w in want if not any(w in x for x in names)]
            log(f"trace {os.path.basename(files[0])} "
                f"({os.path.getsize(files[0]) / 2**20:.1f} MiB): "
                f"{len(names)} kernel names; device-busy share "
                f"{share:.4f} of {span:.3f} ms; the hand-written kernels "
                f"{want} in it: missing {missing}")
            if not rehearse and missing:
                raise AssertionError(f"kernels missing from the trace: "
                                     f"{missing}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rehearse", action="store_true",
                    help="CPU, 2k Gaussians, 128x128, plain versions")
    ap.add_argument("--child", default=None,
                    help=argparse.SUPPRESS)   # a rank of phase 22
    args = ap.parse_args()
    if args.child:
        return child_main(args.child)

    # the classic phases run the classic blend; phase 12 sets each variant
    for k in [k for k in os.environ if k.startswith("GPT_BLEND_")]:
        log(f"ignoring {k}={os.environ.pop(k)}")

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
        fwd_capture = cap.args

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
    vres, vlaunches, vdevice_ms = variant_phases(
        cfg, dev, state, iteration, views, bg, renders,
        fwd_capture["rasterize_binned"][0], ctx, args.rehearse, reps)
    res.update(vres)
    launches.update(vlaunches)
    device_ms.update(vdevice_ms)
    for k, v in classic_phases(cfg, dev, state, iteration, views, renders,
                               ctx, args.rehearse, reps).items():
        launches[k] = launches.get(k, 0) + v
    sres, slaunches, sdevice_ms = stage23_phases(ctx, dev, args.seed,
                                                 args.rehearse, reps)
    res.update(sres)
    launches.update({k: slaunches.get(k, 0) for k in sres})
    device_ms.update(sdevice_ms)
    eres, elaunches, edevice_ms = encoder_phases(ctx, dev, args.seed,
                                                 args.rehearse, reps)
    res.update(eres)
    for k, v in elaunches.items():
        launches[k] = launches.get(k, 0) + v
    device_ms.update(edevice_ms)
    tr, info = trainer_phases(dev, args.seed, args.rehearse, reps)
    glaunches = gcn_phases(tr, info, dev, args.seed, args.rehearse)
    for k in FWD_KERNELS:
        launches[k] = launches.get(k, 0) + glaunches.get(k, 0)
    del tr
    claunches = cli_phases(info, dev, args.seed, args.rehearse)
    hlaunches = hypernerf_phases(dev, args.seed, args.rehearse)
    for k in CLI_KERNELS:
        launches[k] = launches.get(k, 0) + claunches.get(k, 0) + \
            hlaunches.get(k, 0)
    plaunches = sharded_phases(cfg, dev, state, iteration, views, ctx, info,
                               args.seed, args.rehearse, reps)
    log(f"sharded phase: launches {plaunches}")
    for k, v in plaunches.items():
        if k in launches:
            launches[k] += v
    mlaunches = multi_phases(dev, ctx, info, args.seed, args.rehearse, reps)
    log(f"multi phase: launches {mlaunches}")
    for k, v in mlaunches.items():
        if k in launches:
            launches[k] += v

    line = {"kernels": [
        {
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches.get(name, 0),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "device_ms": device_ms[name],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "kernel_device_ms": r.get("kernel_device_ms"),
            "library_device_ms": r.get("library_device_ms"),
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
