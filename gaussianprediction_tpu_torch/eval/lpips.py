"""LPIPS perceptual metric (VGG16 / AlexNet backbones), weights-gated.

Torch twin of gaussianprediction_tpu/eval/lpips.py (LPIPS v0.1):
channel-normalised deep features from conv stacks, per-layer learned
linear weights, a spatially averaged distance. The pretrained backbones
and linear weights are read from the .npz named by `GPT_LPIPS_WEIGHTS`
(the JAX package's layout: "vgg/conv{i}/w" and "alex/conv{i}/w" HWIO
kernels, "…/b" biases, "vgg/lin{k}" and "alex/lin{k}" channel weights);
`try_load_lpips()` returns None without one, and the metric suite then
reports LPIPS as null. The kernels are turned to OIHW for F.conv2d,
which runs in full f32 (device.py keeps cuDNN out of TF32).
"""
from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from gaussianprediction_tpu_torch.device import resolve_device

# ImageNet normalization used by LPIPS's scaling layer
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

# VGG16 feature config up to conv5_3 (layer indices after which LPIPS taps)
VGG_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
           512, 512, 512, "M", 512, 512, 512]
VGG_TAPS = (1, 3, 6, 9, 12)      # conv indices (0-based) of relu1_2..relu5_3
ALEX_CFG = [(64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1),
            (256, 3, 1, 1), (256, 3, 1, 1)]  # (out, k, stride, pad)


def _conv(params, name, x, stride=1, pad=1):
    return F.conv2d(x, params[f"{name}/w"], params[f"{name}/b"],
                    stride=stride, padding=pad)


def _normalize_feat(f, eps=1e-10):
    n = torch.sqrt(torch.sum(f * f, dim=1, keepdim=True))
    return f / (n + eps)


def _vgg_features(params, x):
    feats = []
    conv_i = 0
    for c in VGG_CFG:
        if c == "M":
            x = F.max_pool2d(x, 2, 2)
        else:
            x = torch.relu(_conv(params, f"vgg/conv{conv_i}", x))
            if conv_i in VGG_TAPS:
                feats.append(x)
            conv_i += 1
    return feats


def _alex_features(params, x):
    feats = []
    for i, (_, k, s, p) in enumerate(ALEX_CFG):
        x = torch.relu(_conv(params, f"alex/conv{i}", x, stride=s, pad=p))
        feats.append(x)
        if i in (0, 1):
            x = F.max_pool2d(x, 3, 2)
    return feats


def _lpips_distance(params, prefix, feat_fn, a, b):
    """a, b [H, W, 3] in [0, 1] -> the LPIPS distance (0-d tensor)."""
    shift = torch.as_tensor(_SHIFT, device=a.device)
    scale = torch.as_tensor(_SCALE, device=a.device)

    def nchw(x):
        return ((x * 2.0 - 1.0 - shift) / scale).permute(2, 0, 1)[None]

    fa = feat_fn(params, nchw(a))
    fb = feat_fn(params, nchw(b))
    total = 0.0
    for k, (x, y) in enumerate(zip(fa, fb)):
        d = (_normalize_feat(x) - _normalize_feat(y)) ** 2
        lin = params[f"{prefix}/lin{k}"]            # [C] nonneg weights
        total = total + torch.mean(torch.sum(d * lin[None, :, None, None],
                                             dim=1))
    return total


def load_lpips_params(path: str, device=None):
    """The weights .npz -> {key: tensor on the device}, conv kernels
    turned from HWIO to OIHW."""
    dev = resolve_device(device)
    out = {}
    with np.load(path) as f:
        for k in f.files:
            a = f[k]
            if a.ndim == 4:
                a = a.transpose(3, 2, 0, 1)
            out[k] = torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                     device=dev)
    return out


def try_load_lpips(device=None) -> Optional[Callable]:
    """Returns fn(render, gt) -> (lpips_vgg, lpips_alex) computed on the
    device, or None when no weights file is set (GPT_LPIPS_WEIGHTS names
    an .npz)."""
    path = os.environ.get("GPT_LPIPS_WEIGHTS", "")
    if not path or not os.path.exists(path):
        return None
    dev = resolve_device(device)
    params = load_lpips_params(path, dev)
    has_vgg = any(k.startswith("vgg/") for k in params)
    has_alex = any(k.startswith("alex/") for k in params)

    @torch.no_grad()
    def compute(render, gt):
        """[H, W, 3] numpy arrays or tensors in [0, 1]."""
        r = torch.as_tensor(render, dtype=torch.float32, device=dev)
        g = torch.as_tensor(gt, dtype=torch.float32, device=dev)
        lv = float(_lpips_distance(params, "vgg", _vgg_features, r, g)) \
            if has_vgg else None
        la = float(_lpips_distance(params, "alex", _alex_features, r, g)) \
            if has_alex else None
        return lv, la

    return compute
