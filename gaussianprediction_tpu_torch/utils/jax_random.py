"""jax.random's threefry draws, reproduced with numpy.

The JAX package draws a few constants from fixed keys: the Fourier
encoder's direction matrix (jax.random.normal(PRNGKey(20240519), ...)) and
the transition diagnostics' keypoint noise (jax.random.normal(PRNGKey(0),
...)). The port makes the same numbers without JAX:

  - key_data(seed): PRNGKey(seed)'s two uint32 words (the seed's high and
    low 32 bits);
  - random_bits(key, shape): threefry2x32 over a 64-bit counter, the flat
    row-major index split into its high and low words, the two output
    words xor-ed (jax_threefry_partitionable=True, the default since JAX
    0.5);
  - uniform(key, shape, lo, hi): the top 23 bits as the mantissa of a
    float in [1, 2), minus 1, scaled to [lo, hi), then max(lo, .);
  - normal(key, shape): sqrt(2) * erf_inv(uniform in (-1, 1)), erf_inv by
    XLA's single-precision polynomial (Giles) in w = -log1p(-x^2), its
    Horner steps fused multiply-adds (taken in float64, rounded once).

The bits are JAX's exactly. The normals agree with JAX's to a few f32
ulps: XLA's log1p rounds otherwise than numpy's in the last bits
(tests/test_torch_encoders.py states the tolerance).
"""
from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# erf_inv's polynomial in w = -log1p(-x^2): w < 5, then w >= 5
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)


def key_data(seed: int) -> np.ndarray:
    """PRNGKey(seed) as uint32[2]: the seed's high and low 32 bits."""
    s = int(seed)
    return np.array([(s >> 32) & 0xFFFFFFFF, s & 0xFFFFFFFF], np.uint32)


def _rotl(x, r: int):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key, x0, x1):
    """The 20-round threefry2x32 block cipher of (x0, x1) under key
    (uint32 arrays; wrapping arithmetic)."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x = [x0.astype(np.uint32) + ks[0], x1.astype(np.uint32) + ks[1]]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def random_bits(key, shape) -> np.ndarray:
    """jax.random.bits(key, shape) (uint32)."""
    count = np.arange(int(np.prod(shape, dtype=np.int64)), dtype=np.uint64)
    hi = (count >> np.uint64(32)).astype(np.uint32)
    lo = (count & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    b0, b1 = threefry2x32(key, hi, lo)
    return (b0 ^ b1).reshape(shape)


def uniform(key, shape, lo: float = 0.0, hi: float = 1.0) -> np.ndarray:
    """jax.random.uniform(key, shape, float32, lo, hi)."""
    bits = random_bits(key, shape)
    one = np.float32(1.0)
    f = ((bits >> np.uint32(9)) | one.view(np.uint32)).view(np.float32) - one
    lo, hi = np.float32(lo), np.float32(hi)
    return np.maximum(lo, f * (hi - lo) + lo).astype(np.float32)


def erf_inv(x) -> np.ndarray:
    """XLA's float32 erf_inv (x in (-1, 1))."""
    x = np.asarray(x, np.float32)
    w = -np.log1p(-(x * x)).astype(np.float32)
    small = w < np.float32(5.0)
    w = np.where(small, w - np.float32(2.5),
                 np.sqrt(w) - np.float32(3.0)).astype(np.float32)
    p = np.where(small, np.float32(_ERFINV_SMALL[0]),
                 np.float32(_ERFINV_LARGE[0])).astype(np.float32)
    for a, b in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
        c = np.where(small, np.float64(np.float32(a)),
                     np.float64(np.float32(b)))
        p = (c + p.astype(np.float64) * w).astype(np.float32)
    return (p * x).astype(np.float32)


def normal(key, shape) -> np.ndarray:
    """jax.random.normal(key, shape, float32)."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform(key, shape, lo, 1.0)
    return (np.float32(np.sqrt(2.0)) * erf_inv(u)).astype(np.float32)
