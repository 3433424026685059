"""Parity of the port's `fourier` and `brick` weight encoders
(ops/fourier_enc.py, ops/hashgrid.py's brick grid), the numpy copy of
jax.random's draws they rest on (utils/jax_random.py) and the encoder
dispatch of models/deform.py:blend_weights with the JAX package.

Tolerances, and why:
  - jax.random bits: equal (integer threefry); normals within
    8 * 2^-24 * max(1, |x|) a value: XLA's f32 log1p rounds otherwise
    than numpy's in the last bits (measured: 4 * 2^-24 * max(1, |x|) at
    most over 100k draws);
  - fourier_dirs: within 8 * 2^-24 of each column's largest |entry| (the
    normals' ulps, then a norm and two products);
  - fourier_encode: each package's features of the same B within
    8 * 2^-24 * max|phase| of an f64 oracle, max|phase| = Σ_i |B_ij| (the
    largest phase of column j over [0, 1]^3): f32 phases near 1e4 carry
    errors near 1e-3 rad, so the two packages' features are not compared
    with each other;
  - brick geometry (brick rows, cell parities): equal; fractions equal;
  - the brick encoding: 1e-5 of the largest feature (JAX and torch order
    the contraction's sums each their own way);
  - the brick table gradient through the plain scatter_add_sorted: per
    slot within 64 * 2^-24 * Σ|contributions| of the JAX CPU scatter-add;
  - blend_weights for each encoder: nn_idx equal, weights within 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import n, one_torch_thread, t  # noqa: F401

from gaussianprediction_tpu import config as jcfg
from gaussianprediction_tpu.models import deform as jdeform
from gaussianprediction_tpu.models import gaussians as jgauss
from gaussianprediction_tpu.ops import fourier_enc as jfe
from gaussianprediction_tpu.ops import hashgrid as jhash
from gaussianprediction_tpu_torch import config as tcfg
from gaussianprediction_tpu_torch.convert import state_from_params
from gaussianprediction_tpu_torch.models import deform as tdeform
from gaussianprediction_tpu_torch.models.gaussians import weight_model
from gaussianprediction_tpu_torch.ops import fourier_enc as tfe
from gaussianprediction_tpu_torch.ops import hashgrid as thash
from gaussianprediction_tpu_torch.utils import jax_random as jr

EPS32 = 2.0 ** -24
BOUND = 1.6


def _points(num=2000, seed=0):
    """Points inside the box, on its faces and corners, and outside it."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.0, 1.0, (num, 3)) * BOUND
    x[:100] = rng.choice([-BOUND, BOUND], (100, 3))
    x[100:200, 1] = BOUND
    x[200:300] *= 1.7
    return x.astype(np.float32)


@pytest.mark.parametrize("seed,shape", [(20240519, (3, 64)), (0, (512, 3)),
                                        (7, (5000,))])
def test_jax_random_draws(seed, shape):
    key = jax.random.PRNGKey(seed)
    kd = jr.key_data(seed)
    np.testing.assert_array_equal(kd, np.asarray(jax.random.key_data(key)))
    np.testing.assert_array_equal(jr.random_bits(kd, shape),
                                  np.asarray(jax.random.bits(key, shape)))
    ours = jr.normal(kd, shape)
    ref = np.asarray(jax.random.normal(key, shape, jnp.float32))
    assert ours.dtype == np.float32 and ours.shape == shape
    tol = 8 * EPS32 * np.maximum(1.0, np.abs(ref))
    assert np.all(np.abs(ours - ref) <= tol)


@pytest.mark.parametrize("ladder", [(16, 4, 16, 2048), (16, 4, 16, 512),
                                    (4, 4, 16, 64)])
def test_fourier_dirs_match_jax(ladder):
    ours = tfe.fourier_dirs(*ladder)
    ref = np.asarray(jfe.fourier_dirs(*ladder))
    assert ours.dtype == np.float32 and ours.shape == ref.shape
    col = np.abs(ref).max(axis=0, keepdims=True)
    assert np.all(np.abs(ours - ref) <= 8 * EPS32 * col)
    assert tfe.fourier_feature_dim(*ladder[:2]) == \
        jfe.fourier_feature_dim(*ladder[:2])


def test_fourier_encode_against_f64_oracle():
    B = np.asarray(jfe.fourier_dirs(16, 4, 16, 2048))
    xyz = _points()
    x64 = np.clip((xyz.astype(np.float64) + BOUND) / (2 * BOUND), 0, 1)
    phase = x64 @ B.astype(np.float64)
    oracle = np.concatenate([np.sin(phase), np.cos(phase)], -1)
    tol = 8 * EPS32 * np.tile(np.abs(B).sum(0), 2)[None]
    ours = n(tfe.fourier_encode(t(B), t(xyz), BOUND))
    ref = np.asarray(jfe.fourier_encode(jnp.asarray(B), jnp.asarray(xyz),
                                        BOUND))
    assert ours.shape == ref.shape == (xyz.shape[0], 128)
    for feats in (ours, ref):
        assert np.all(np.abs(feats - oracle) <= tol)


@pytest.fixture(scope="module")
def bricks():
    """16 levels of F=4 bricks, 2^10 rows a hashed level (levels 0-2 dense,
    the rest hashed), scaled so the encoding is not all roundoff."""
    tables = thash.init_brickgrid(np.random.default_rng(1), 16, 4, 10,
                                  16, 2048)
    tables = {k: (v * 1e4).astype(np.float32) for k, v in tables.items()}
    return tables, _points()


def test_brick_layout_and_geometry_match_jax(bricks):
    tables, xyz = bricks
    for res in (1, 2, 16, 31, 80, 2048):
        assert thash._brick_counts(res, 16) == jhash._brick_counts(res, 16)
    ref = jhash.init_brickgrid(jax.random.PRNGKey(0), 16, 4, 10, 16, 2048)
    ours = thash.init_brickgrid(np.random.default_rng(0), 16, 4, 10, 16,
                                2048)
    assert [v.shape for v in ours.values()] == \
        [tuple(v.shape) for v in ref.values()]
    assert all(v.dtype == np.float32 and np.abs(v).max() <= 1e-4
               for v in ours.values())
    jspecs, jtotal = jhash.brick_specs(tables, 16, 2048)
    tspecs, ttotal = thash.brick_specs(tables, 16, 2048)
    assert tspecs == jspecs and ttotal == jtotal
    dense = [s for s in tspecs if s[1] ** 3 <= s[2]]
    assert 0 < len(dense) < len(tspecs)           # both kinds of level
    jb, ja, jf = jhash._brick_geom(jnp.asarray(xyz), jspecs, BOUND)
    tb, ta, tf = thash._brick_geom(t(xyz), tspecs, BOUND)
    assert tb.dtype == ta.dtype == torch.int32
    np.testing.assert_array_equal(n(tb), n(jb))
    np.testing.assert_array_equal(n(ta), n(ja))
    np.testing.assert_array_equal(n(tf), n(jf))
    assert n(tb).min() >= 0 and n(tb).max() < ttotal


def test_brick_encode_and_table_gradient_match_jax(bricks):
    tables, xyz = bricks
    jt = {k: jnp.asarray(v) for k, v in tables.items()}
    g = np.random.default_rng(2).normal(
        size=(xyz.shape[0], 64)).astype(np.float32)

    @jax.jit
    def encode_vjp(tb, gg):
        out, vjp = jax.vjp(lambda tb_: jhash.brickgrid_encode_fast(
            tb_, jnp.asarray(xyz), BOUND, 16, 2048), tb)
        # the cotangent |g| gives Σ w |g| = Σ |w g| per slot
        return out, vjp(gg)[0], vjp(jnp.abs(gg))[0]

    jout, jg, jabs = encode_vjp(jt, jnp.asarray(g))
    tt = {k: t(v).requires_grad_(True) for k, v in tables.items()}
    tout = thash.brickgrid_encode_fast(tt, t(xyz), BOUND, 16, 2048)
    scale = float(np.abs(n(jout)).max())
    np.testing.assert_allclose(n(tout), n(jout), rtol=0, atol=1e-5 * scale)
    tout.backward(t(g))
    for k in tables:
        bound = 64 * EPS32 * n(jabs[k])
        assert np.all(np.abs(n(tt[k].grad) - n(jg[k])) <= bound), k
    # the cell-granular stream: ascending level ranges, in the cell view
    keys, w = thash.brick_keys_weights(*thash._brick_geom(
        t(xyz), thash.brick_specs(tables, 16, 2048)[0], BOUND))
    total = thash.brick_specs(tables, 16, 2048)[1] * thash.BRICK_CELLS
    k = n(keys)
    assert k.dtype == np.int32 and 0 <= k.min() and k.max() < total
    assert np.all(k[1:].min(axis=(1, 2)) > k[:-1].max(axis=(1, 2)))
    np.testing.assert_allclose(n(w).sum(-1), 1.0, atol=1e-6)


@pytest.fixture(scope="module")
def blend_model():
    """A `test`-preset model of 300 points with 16 live keypoints."""
    rng = np.random.default_rng(3)
    C, Ck, F = 512, 32, 8
    pts = rng.uniform(-1.0, 1.0, (C, 3)).astype(np.float32)
    alive = np.zeros(C, bool)
    alive[:300] = True
    kalive = np.zeros(Ck, bool)
    kalive[:16] = True
    base = {
        "xyz": pts,
        "motion_feature": rng.normal(0, 0.3, (C, F)).astype(np.float32),
        "super_xyz": rng.uniform(-1.0, 1.0, (Ck, 3)).astype(np.float32),
        "super_feature": rng.normal(0, 0.3, (Ck, F)).astype(np.float32),
    }
    return base, alive, kalive


@pytest.mark.parametrize("enc", ["hashgrid", "brick", "fourier"])
def test_blend_weights_each_encoder_matches_jax(blend_model, enc):
    base, alive, kalive = blend_model
    jc, tc = jcfg.get_preset("test"), tcfg.get_preset("test")
    jc.model.weight_encoder = tc.model.weight_encoder = enc
    tables, wmlp = weight_model(tc, np.random.default_rng(4))
    assert (tables is None) == (enc == "fourier")
    params = dict(base, weight_mlp=[
        {k: v.astype(np.float32) for k, v in layer.items()}
        for layer in wmlp])
    if tables is not None:
        params["hash_tables"] = {k: (v * 1e3).astype(np.float32)
                                 for k, v in tables.items()}
    jstate = jgauss.GaussianState(
        params=jax.tree.map(jnp.asarray, params), alive=jnp.asarray(alive),
        kpt_alive=jnp.asarray(kalive),
        **{k: jnp.zeros(512, jnp.int32 if k == "max_radii2D"
                        else jnp.float32)
           for k in ("xyz_gradient_accum", "xyz_gradient_accum_max",
                     "denom", "max_radii2D", "xyz_motion_accum_max",
                     "motion_denom")})
    jidx, jwx, jwr = jax.jit(lambda s: jdeform.blend_weights(
        s.params, jc, s))(jstate)
    tstate = state_from_params(params, alive, kalive, device="cpu")
    tidx, twx, twr = tdeform.blend_weights(tstate.params, tc, tstate)
    np.testing.assert_array_equal(n(tidx), n(jidx))
    np.testing.assert_allclose(n(twx), n(jwx), rtol=0, atol=1e-6)
    np.testing.assert_allclose(n(twr), n(jwr), rtol=0, atol=1e-6)
    # the weights are not all uniform (the encoder reaches the logits)
    assert float(n(twx).std(axis=1).max()) > 1e-3
