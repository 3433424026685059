"""Core math utilities: quaternions, rotations, covariances, encodings.

Torch twin of gaussianprediction_tpu/utils/math.py, same formulas in the
same order of operations. Quaternions are (w, x, y, z) throughout.
"""
from __future__ import annotations

import torch


def inverse_sigmoid(x):
    """log(x / (1-x)); inverse of the opacity activation."""
    return torch.log(x / (1.0 - x))


def quat_mul(q1, q2):
    """Hamilton product q1 ⊗ q2 (so R(q1q2) = R(q1) @ R(q2)), wxyz."""
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack(
        [
            w2 * w1 - x2 * x1 - y2 * y1 - z2 * z1,
            x2 * w1 + w2 * x1 + z2 * y1 - y2 * z1,
            y2 * w1 - z2 * x1 + w2 * y1 + x2 * z1,
            z2 * w1 + y2 * x1 - x2 * y1 + w2 * z1,
        ],
        dim=-1,
    )


def quat_to_rotmat(q):
    """Unit-normalize quaternion(s) and convert to rotation matrices.
    q: (..., 4) wxyz -> (..., 3, 3)."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = torch.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y),
            2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x),
            2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y),
        ],
        dim=-1,
    )
    return R.reshape(q.shape[:-1] + (3, 3))


def build_scaling_rotation(s, q):
    """L = R(q) @ diag(s): factor of the 3D covariance Σ = L Lᵀ."""
    return quat_to_rotmat(q) * s[..., None, :]


def covariance_from_scaling_rotation(s, q, scaling_modifier=1.0):
    """Σ = (R S)(R S)ᵀ packed as [Σ00, Σ01, Σ02, Σ11, Σ12, Σ22]."""
    L = build_scaling_rotation(scaling_modifier * s, q)
    C = L @ L.transpose(-1, -2)
    return torch.stack(
        [C[..., 0, 0], C[..., 0, 1], C[..., 0, 2],
         C[..., 1, 1], C[..., 1, 2], C[..., 2, 2]],
        dim=-1,
    )


def cov6_to_mat(cov6):
    """Unpack (..., 6) upper-triangular covariance into (..., 3, 3)."""
    a, b, c, d, e, f = (cov6[..., i] for i in range(6))
    row0 = torch.stack([a, b, c], dim=-1)
    row1 = torch.stack([b, d, e], dim=-1)
    row2 = torch.stack([c, e, f], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def positional_encoding(x, freqs: int):
    """NeRF-style sin/cos encoding, interleaved like the reference:
    [sin(x0), cos(x0), sin(x1), cos(x1), ..., sin(xd 2^(F-1)), cos(...)]."""
    freq_bands = 2.0 ** torch.arange(freqs, dtype=x.dtype, device=x.device)
    pts = (x[..., None] * freq_bands).reshape(
        x.shape[:-1] + (freqs * x.shape[-1],)
    )
    return torch.stack([torch.sin(pts), torch.cos(pts)], dim=-1).reshape(
        x.shape[:-1] + (2 * freqs * x.shape[-1],)
    )


def sharp_sigmoid(t, beta):
    """1 / (1 + exp(-t / beta))."""
    return torch.sigmoid(t / beta)


def step_opacity_fn(t, u, beta):
    """Temporal step-opacity 1/(1+exp(-(t-u)/beta))."""
    return torch.sigmoid((t - u) / beta)
