"""Image-quality metric suite over render/gt pairs.

Torch twin of gaussianprediction_tpu/eval/metrics.py: PSNR, SSIM, MS-SSIM,
D-SSIM and LPIPS (vgg, alex) per view, aggregated into results.json and
per_view.json with the JAX package's names and layout, plus per-image
error maps and the text table across scenes. The metrics are computed on
`device` (None means CUDA). MS-SSIM is None for images under 176 px (too
small for 5 dyadic scales); LPIPS is null, with an "LPIPS-note", when no
weights file is set (eval/lpips.py).
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from gaussianprediction_tpu_torch.device import resolve_device
from gaussianprediction_tpu_torch.utils.image import dssim, ms_ssim, psnr, ssim

METRICS = ["SSIM", "MS-SSIM", "D-SSIM", "PSNR", "LPIPS-vgg", "LPIPS-alex"]


@torch.no_grad()
def evaluate_pairs(renders: List[np.ndarray], gts: List[np.ndarray],
                   names: Optional[List[str]] = None,
                   compute_lpips: bool = True, device=None) -> Dict:
    """The metric table over [H, W, 3] float image pairs: {"mean": {...},
    "per_view": {metric: {name: value}}}."""
    dev = resolve_device(device)
    names = names or [f"{i:05d}.png" for i in range(len(renders))]
    lpips_fn = None
    if compute_lpips:
        from gaussianprediction_tpu_torch.eval.lpips import try_load_lpips

        lpips_fn = try_load_lpips(dev)
    per = {m: {} for m in METRICS}
    for name, r, g in zip(names, renders, gts):
        r = torch.as_tensor(np.asarray(r, np.float32), device=dev)
        g = torch.as_tensor(np.asarray(g, np.float32), device=dev)
        per["SSIM"][name] = float(ssim(r, g))
        if min(r.shape[0], r.shape[1]) >= 176:
            per["MS-SSIM"][name] = float(ms_ssim(r, g))
        else:  # too small for 5 dyadic scales
            per["MS-SSIM"][name] = None
        per["D-SSIM"][name] = float(dssim(r, g))
        per["PSNR"][name] = float(psnr(r, g))
        if lpips_fn is not None:
            lv, la = lpips_fn(r, g)
            per["LPIPS-vgg"][name] = lv
            per["LPIPS-alex"][name] = la
        else:
            per["LPIPS-vgg"][name] = None
            per["LPIPS-alex"][name] = None

    def mean_of(d):
        vals = [v for v in d.values() if v is not None]
        return float(np.mean(vals)) if vals else None

    mean = {m: mean_of(per[m]) for m in per}
    if lpips_fn is None and compute_lpips:
        # never leave LPIPS silently null: the architecture is implemented
        # (eval/lpips.py) but pretrained VGG/Alex weights cannot be
        # downloaded in an offline environment — README "LPIPS weights"
        mean["LPIPS-note"] = (
            "LPIPS unavailable: set GPT_LPIPS_WEIGHTS to a weights npz "
            "(tools/export_lpips_npz.py; needs torchvision once, offline "
            "environments cannot fetch the pretrained backbones)"
        )
    return {"mean": mean, "per_view": per}


def write_error_maps(renders, gts, deltas_dir: str):
    """Per-image |render - gt| x 255 maps, deltas/{idx:05d}.jpg through
    imageio (.png where it has no JPEG writer); where imageio is absent,
    .png through data/image_io.write_png."""
    from gaussianprediction_tpu_torch.data.image_io import write_png

    try:
        import imageio.v2 as imageio
    except ImportError:
        imageio = None
    os.makedirs(deltas_dir, exist_ok=True)
    for idx, (r, g) in enumerate(zip(renders, gts)):
        err = np.abs(np.asarray(r, np.float32) - np.asarray(g, np.float32))
        u8 = (np.clip(err, 0.0, 1.0) * 255).astype(np.uint8)
        png = os.path.join(deltas_dir, f"{idx:05d}.png")
        if imageio is None:
            write_png(png, u8)
            continue
        try:
            imageio.imwrite(os.path.join(deltas_dir, f"{idx:05d}.jpg"), u8)
        except (ValueError, OSError):  # no JPEG plugin in this environment
            imageio.imwrite(png, u8)


def _load_dir(d: str, files: List[str], resize_ratio: float):
    from gaussianprediction_tpu_torch.data.image_io import load_image

    out = []
    for f in files:
        img = load_image(os.path.join(d, f))
        if resize_ratio != 1.0:
            h, w = img.shape[:2]
            img = load_image(os.path.join(d, f), resize_wh=(
                int(w * resize_ratio), int(h * resize_ratio)))
        out.append(img)
    return out


def evaluate_dirs(renders_dir: str, gt_dir: str, out_dir: Optional[str] = None,
                  resize_ratio: float = 1.0, device=None) -> Dict:
    """Read two image directories (files paired in sorted order, renders
    with "depth" in the name skipped), write results.json, per_view.json
    and the error maps (deltas/) into out_dir (default: the renders'
    parent)."""
    out_dir = out_dir or os.path.dirname(renders_dir.rstrip("/"))
    rnames = sorted(f for f in os.listdir(renders_dir) if "depth" not in f)
    gnames = sorted(os.listdir(gt_dir))[:len(rnames)]
    renders = _load_dir(renders_dir, rnames, resize_ratio)
    gts = _load_dir(gt_dir, gnames, resize_ratio)
    results = evaluate_pairs(renders, gts, names=rnames, device=device)
    write_error_maps(renders, gts, os.path.join(out_dir, "deltas"))
    with open(os.path.join(out_dir, "results.json"), "w") as f:
        json.dump(results["mean"], f, indent=2)
    with open(os.path.join(out_dir, "per_view.json"), "w") as f:
        json.dump(results["per_view"], f, indent=2)
    return results


def results_table(result_dirs: Dict[str, str]) -> str:
    """results.json of each scene -> a text table with per-metric
    averages."""
    rows = {}
    metrics_order = ["PSNR", "SSIM", "MS-SSIM", "D-SSIM", "LPIPS-vgg",
                     "LPIPS-alex"]
    for scene, d in result_dirs.items():
        with open(os.path.join(d, "results.json")) as f:
            rows[scene] = json.load(f)
    header = ["scene"] + metrics_order
    lines = ["  ".join(f"{h:>12}" for h in header)]
    sums = {m: [] for m in metrics_order}
    for scene, r in rows.items():
        vals = []
        for m in metrics_order:
            v = r.get(m)
            vals.append("-" if v is None else f"{v:.4f}")
            if v is not None:
                sums[m].append(v)
        lines.append("  ".join(
            [f"{scene:>12}"] + [f"{v:>12}" for v in vals]))
    avg = ["average"] + [
        f"{np.mean(sums[m]):.4f}" if sums[m] else "-" for m in metrics_order
    ]
    lines.append("  ".join(f"{v:>12}" for v in avg))
    return "\n".join(lines)
