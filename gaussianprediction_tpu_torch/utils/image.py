"""Image losses and quality metrics (channels-last [..., H, W, C]).

Torch twin of gaussianprediction_tpu/utils/image.py: l1_loss, psnr, the
windowed SSIM of the reference (11-tap gaussian window, sigma 1.5, 'same'
zero padding, C1 = 0.01^2, C2 = 0.03^2), dssim and the photometric
training loss dssim_l1_loss, l2_loss, and the 5-scale ms_ssim of the
metric suite (valid-region windows, 2x2 average pooling between scales,
ReLU'd terms, as pytorch_msssim). The separable blur is two banded-matrix
products, as in the JAX package: plain f32 matmuls (TF32 stays off, see
device.py), no convolution.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def l1_loss(a, b):
    return torch.mean(torch.abs(a - b))


def l2_loss(a, b):
    return torch.mean((a - b) ** 2)


def psnr(img, gt):
    """20*log10(1/sqrt(mse)) over the whole image."""
    mse = torch.mean((img - gt) ** 2)
    return 20.0 * torch.log10(1.0 / torch.sqrt(torch.clamp(mse, min=1e-12)))


@functools.lru_cache(maxsize=8)
def _gaussian_window(window_size: int, sigma: float) -> np.ndarray:
    x = np.arange(window_size, dtype=np.float64)
    g = np.exp(-((x - window_size // 2) ** 2) / (2.0 * sigma**2))
    return (g / g.sum()).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _banded_blur_matrix(n: int, window_size: int, sigma: float,
                        device: torch.device,
                        valid: bool = False) -> torch.Tensor:
    """[n, n] banded matrix applying the 1-d window along one axis with
    'same' zero padding, or its [n - 2 (window_size // 2), n] valid-region
    rows; built once per device (a training step blurs five times, and
    copying 800x800 matrices from the host each time showed in the
    profile)."""
    taps = _gaussian_window(window_size, sigma)
    half = window_size // 2
    m = np.zeros((n, n), np.float32)
    for k, t in enumerate(taps):
        src = np.arange(n) + (k - half)
        ok = (src >= 0) & (src < n)
        m[np.arange(n)[ok], src[ok]] += t
    if valid:
        m = m[half:n - half]
    return torch.as_tensor(m, device=device)


def _blur(img, window_size: int, sigma: float, valid: bool = False):
    *batch, H, W, C = img.shape
    x = img.reshape(-1, H, W * C)
    mh = _banded_blur_matrix(H, window_size, sigma, img.device, valid)
    mw = _banded_blur_matrix(W, window_size, sigma, img.device, valid)
    x = torch.matmul(mh, x).reshape(-1, mh.shape[0], W, C)   # rows
    x = torch.einsum("vw,bhwc->bhvc", mw, x)                 # columns
    return x.reshape(*batch, mh.shape[0], mw.shape[0], C)


def _ssim_maps(img1, img2, window_size: int, sigma: float,
               valid: bool = False):
    """(ssim map, contrast-structure map)."""
    C1, C2 = 0.01**2, 0.03**2
    blur = lambda x: _blur(x, window_size, sigma, valid)  # noqa: E731
    mu1, mu2 = blur(img1), blur(img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = blur(img1 * img1) - mu1_sq
    sigma2_sq = blur(img2 * img2) - mu2_sq
    sigma12 = blur(img1 * img2) - mu1_mu2
    cs_num, cs_den = 2 * sigma12 + C2, sigma1_sq + sigma2_sq + C2
    ssim_map = ((2 * mu1_mu2 + C1) * cs_num) / (
        (mu1_sq + mu2_sq + C1) * cs_den)
    return ssim_map, cs_num / cs_den


def ssim(img1, img2, window_size: int = 11, sigma: float = 1.5):
    """Mean SSIM with the reference's zero-padded 'same' window."""
    ssim_map, _ = _ssim_maps(img1, img2, window_size, sigma)
    return torch.mean(ssim_map)


def dssim(img1, img2):
    return (1.0 - ssim(img1, img2)) / 2.0


MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _pool2(x):
    """2x2 average pooling of [..., H, W, C] (H and W even)."""
    *b, H, W, C = x.shape
    return x.reshape(*b, H // 2, 2, W // 2, 2, C).sum(dim=(-4, -2)) / 4.0


def ms_ssim(img1, img2, window_size: int = 11, sigma: float = 1.5):
    """Multi-scale SSIM over 5 scales: valid-region windows, the odd
    trailing row and column dropped and 2x2 average pooling between
    scales, the contrast-structure terms and the last SSIM term through
    ReLU, combined as prod(term ** MSSSIM_WEIGHTS)."""
    levels = len(MSSSIM_WEIGHTS)
    vals = []
    a, b = img1, img2
    for i in range(levels):
        ssim_map, cs_map = _ssim_maps(a, b, window_size, sigma, valid=True)
        if i < levels - 1:
            vals.append(torch.relu(torch.mean(cs_map)))
            h, w = a.shape[-3] - a.shape[-3] % 2, a.shape[-2] - a.shape[-2] % 2
            a = _pool2(a[..., :h, :w, :])
            b = _pool2(b[..., :h, :w, :])
        else:
            vals.append(torch.relu(torch.mean(ssim_map)))
    weights = torch.tensor(MSSSIM_WEIGHTS, dtype=torch.float32,
                           device=img1.device)
    return torch.prod(torch.stack(vals) ** weights)


def dssim_l1_loss(img, gt, lambda_dssim: float = 0.2):
    """(1-λ)·L1 + λ·(1-SSIM): the photometric training loss."""
    return (1.0 - lambda_dssim) * l1_loss(img, gt) + lambda_dssim * (
        1.0 - ssim(img, gt))
