"""Real spherical-harmonics evaluation for view-dependent Gaussian color.

Torch twin of gaussianprediction_tpu/utils/sh.py (the hard-coded real SH
basis up to degree 3 used by 3DGS)."""
from __future__ import annotations

import torch

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)


def sh_basis(deg: int, dirs):
    """dirs: (..., 3) unit vectors -> (..., (deg+1)**2) basis values."""
    assert 0 <= deg <= 3
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    terms = [C0 * torch.ones_like(x)]
    if deg >= 1:
        terms += [-C1 * y, C1 * z, -C1 * x]
    if deg >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        terms += [
            C2[0] * xy,
            C2[1] * yz,
            C2[2] * (2.0 * zz - xx - yy),
            C2[3] * xz,
            C2[4] * (xx - yy),
        ]
    if deg >= 3:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        terms += [
            C3[0] * y * (3 * xx - yy),
            C3[1] * xy * z,
            C3[2] * y * (4 * zz - xx - yy),
            C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
            C3[4] * x * (4 * zz - xx - yy),
            C3[5] * z * (xx - yy),
            C3[6] * x * (xx - 3 * yy),
        ]
    return torch.stack(terms, dim=-1)


def eval_sh(deg: int, sh, dirs):
    """sh: (..., 3, K) coefficients with K >= (deg+1)**2; dirs (..., 3).
    Returns (..., 3)."""
    basis = sh_basis(deg, dirs)
    B = basis.shape[-1]
    return torch.einsum("...cb,...b->...c", sh[..., :B], basis)


def sh_to_rgb_clamped(deg: int, sh, dirs):
    """SH -> RGB with the +0.5 shift and clamp-at-zero used by 3DGS; also
    returns the clamp mask."""
    rgb = eval_sh(deg, sh, dirs) + 0.5
    clamped = rgb < 0.0
    return torch.clamp(rgb, min=0.0), clamped


def rgb_to_sh(rgb):
    return (rgb - 0.5) / C0
