"""Parity of the port's hash-grid encoder (ops/hashgrid.py), its table
gradient kernel's plain version (ops/hashgrid_kernels.py) and the
selection and clustering ops of stages 2/3 (ops/knn.py:hybrid_knn,
ops/fps.py, ops/kmeans.py) with the JAX package.

Tolerances, and why:
  - corner keys: bit-exact (integer hashing; the port takes the uint32
    products in int64 and keeps the low 32 bits);
  - trilinear weights: 1e-7 (f32 products of values in [0, 1]);
  - the encoding: 1e-6 of the largest feature (sums of 8 weighted rows);
  - the table gradient and scatter_add_sorted: per slot within
    64 * 2^-24 * Σ|contributions| of the slot, f32 roundoff of a sum taken
    in another order (the JAX VJP scatter-adds unsorted; the Pallas kernel
    accumulates one-hot matmuls chunk by chunk);
  - KNN: the indices equal on every row whose K+1 smallest distances are
    apart by more than 1e-5 * (1 + d_K) (the squared distances are
    |q|^2 + |p|^2 - 2 q.p, whose roundoff grows with the norms; lax.top_k
    and torch.topk may order a closer pair either way), and at least 95%
    of the rows clear; the distances to 1e-5 * (1 + d);
  - FPS: the selections equal (3-d points in general position: the
    largest distance leads the runner-up by far more than roundoff);
  - k-means: well-separated blobs, because a Lloyd iteration amplifies an
    assignment flipped on an ulp into a different clustering; assignments
    equal, centroids and keypoint xyz within 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import n, one_torch_thread, t  # noqa: F401

from gaussianprediction_tpu.ops import fps as jfps
from gaussianprediction_tpu.ops import hashgrid as jhash
from gaussianprediction_tpu.ops import hashgrid_pallas as jhp
from gaussianprediction_tpu.ops import kmeans as jkm
from gaussianprediction_tpu.ops import knn as jknn
from gaussianprediction_tpu_torch.ops import fps as tfps
from gaussianprediction_tpu_torch.ops import hashgrid as thash
from gaussianprediction_tpu_torch.ops import hashgrid_kernels as thk
from gaussianprediction_tpu_torch.ops import kmeans as tkm
from gaussianprediction_tpu_torch.ops import knn as tknn

EPS32 = 2.0 ** -24
BOUND = 1.6


def _points(num=3000, seed=0):
    """Points inside the box, on its faces and corners, and outside it."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.0, 1.0, (num, 3)) * BOUND
    x[:200] = rng.choice([-BOUND, BOUND], (200, 3))          # corners
    x[200:400, 0] = BOUND                                     # a face
    x[400:600] *= 1.7                                         # outside
    x[600:620] = 0.0
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def grid():
    """16 levels, F=4, T=2^14: levels 0-1 dense, the rest hashed."""
    rng = np.random.default_rng(1)
    tables = thash.init_hashgrid(rng, n_levels=16, n_features=4, log2_T=14)
    # larger than tcnn's init, so the encoding is not all roundoff
    tables = {k: (v * 1e4).astype(np.float32) for k, v in tables.items()}
    return tables, _points()


def test_keys_and_weights_match_jax(grid):
    tables, xyz = grid
    jspecs, jtotal = jhash.hashgrid_specs(tables, 16, 2048)
    tspecs, ttotal = thash.hashgrid_specs(tables, 16, 2048)
    assert tspecs == jspecs and ttotal == jtotal
    dense = [s for r, s, _ in tspecs if (r + 1) ** 3 <= s]
    assert 0 < len(dense) < len(tspecs)          # both kinds of level
    # eager, as the JAX package's own tests call it (under jit XLA may
    # reassociate (x + b) / 2b * res, moving frac by a few ulps of pos)
    jk, jw = jhash.hashgrid_keys_weights(jnp.asarray(xyz), jspecs, BOUND)
    tk, tw = thash.hashgrid_keys_weights(t(xyz), tspecs, BOUND)
    assert tk.dtype == torch.int32
    np.testing.assert_array_equal(n(tk), n(jk))
    np.testing.assert_allclose(n(tw), n(jw), rtol=0, atol=1e-7)
    assert n(tk).max() < ttotal and n(tk).min() >= 0


def test_level_sizes_and_init():
    res = thash.level_resolutions(16, 16, 2048)
    assert res == jhash.level_resolutions(16, 16, 2048)
    sizes = [thash.level_table_size(r, 19) for r in res]
    assert sizes[:5] == [4913, 12167, 32768, 79507, 205379]
    assert sizes[5:] == [524288] * 11 and sum(sizes) == 6_101_902
    tab = thash.init_hashgrid(np.random.default_rng(0), 16, 4, 19)
    assert [v.shape for v in tab.values()] == [(s, 4) for s in sizes]
    assert all(v.dtype == np.float32 and np.abs(v).max() <= 1e-4
               for v in tab.values())


def test_encode_and_table_gradient_match_jax(grid):
    tables, xyz = grid
    jt = {k: jnp.asarray(v) for k, v in tables.items()}
    tt = {k: t(v).requires_grad_(True) for k, v in tables.items()}
    g = np.random.default_rng(2).normal(
        size=(xyz.shape[0], 64)).astype(np.float32)

    @jax.jit
    def encode_vjp(tb, gg):
        out, vjp = jax.vjp(lambda tb_: jhash.hashgrid_encode_fast(
            tb_, jnp.asarray(xyz), BOUND, 16, 2048), tb)
        # the cotangent |g| gives Σ w |g| = Σ |w g| per slot
        return out, vjp(gg)[0], vjp(jnp.abs(gg))[0]

    jout, jg, jabs = encode_vjp(jt, jnp.asarray(g))
    tout = thash.hashgrid_encode_fast(tt, t(xyz), BOUND, 16, 2048)
    scale = float(np.abs(n(jout)).max())
    np.testing.assert_allclose(n(tout), n(jout), rtol=0, atol=1e-6 * scale)
    # the plain encode (autograd through the gathers) agrees too
    np.testing.assert_allclose(n(thash.hashgrid_encode(tt, t(xyz))),
                               n(jout), rtol=0, atol=1e-6 * scale)

    xyz_t = t(xyz).requires_grad_(True)
    tout = thash.hashgrid_encode_fast(tt, xyz_t, BOUND, 16, 2048)
    grads = torch.autograd.grad(tout, list(tt.values()) + [xyz_t], t(g))
    assert not grads[-1].any()                 # no gradient reaches xyz
    for (k, tg) in zip(tt, grads[:-1]):
        tol = 64 * EPS32 * n(jabs[k]) + 1e-30
        err = np.abs(n(tg) - n(jg[k]))
        assert (err <= tol).all(), (k, float(err.max()))
    assert any(n(jg[k]).any() for k in tt)


def _stream(F=3):
    """Sorted keys into 40,000 slots (blocks of 8192 in the Pallas kernel):
    blocks 1 and 2 empty, slot 30,000 with a run of 5,000, and
    M = 29,123 (not a multiple of the kernel's CHUNK of 2048)."""
    rng = np.random.default_rng(3)
    n_slots = 40_000
    keys = np.concatenate([
        rng.integers(0, 8192, 12_000), rng.integers(24_576, n_slots, 12_123),
        np.full(5000, 30_000)]).astype(np.int32)
    keys.sort()
    vals = rng.normal(size=(F, keys.shape[0])).astype(np.float32)
    assert keys.shape[0] % jhp.CHUNK
    return keys, vals, n_slots


def test_scatter_add_sorted_plain_matches_pallas():
    keys, vals, n_slots = _stream()
    ref = n(jhp.scatter_add_sorted(jnp.asarray(keys), jnp.asarray(vals),
                                   n_slots, interpret=True))
    out = thk.scatter_add_sorted(t(keys), t(vals), n_slots)
    assert out.shape == (3, n_slots) and out.dtype == torch.float32
    absum = np.zeros((3, n_slots), np.float64)
    for f in range(3):
        np.add.at(absum[f], keys, np.abs(vals[f]))
    np.testing.assert_array_less(np.abs(n(out) - ref),
                                 64 * EPS32 * absum + 1e-30)
    empty = np.ones(n_slots, bool)
    empty[keys] = False
    assert not n(out)[:, empty].any() and not ref[:, empty].any()
    assert empty[8192:24_576].all()


def test_scatter_add_sorted_rejects_bad_inputs():
    keys, vals, n_slots = _stream(F=2)
    k, v = t(keys), t(vals)
    for bad in ((k.to(torch.int64), v), (k, v.to(torch.float64)),
                (k, v.T.contiguous().T), (k[:-1], v),
                (k, torch.zeros((9, k.shape[0])))):
        with pytest.raises(ValueError):
            thk.scatter_add_sorted(*bad, n_slots)


def _near_ties(d_sorted, K):
    """Rows whose K+1 smallest distances are closer than the margin."""
    d = d_sorted[:, :K + 1]
    gap = np.diff(d, axis=1)
    return (gap <= 1e-5 * (1.0 + d[:, K:K + 1])).any(axis=1)


def test_hybrid_knn_matches_jax():
    rng = np.random.default_rng(4)
    xyz = rng.uniform(-1, 1, (2000, 3)).astype(np.float32)
    feat = rng.normal(0, 0.5, (2000, 32)).astype(np.float32)
    kx = rng.uniform(-1, 1, (200, 3)).astype(np.float32)
    kf = rng.normal(0, 0.5, (200, 32)).astype(np.float32)
    alive = np.arange(200) < 150
    K = 6
    jd, ji = jax.jit(lambda *a: jknn.hybrid_knn(
        *a, K, 0.5, point_valid=jnp.asarray(alive)))(
            jnp.asarray(xyz), jnp.asarray(feat), jnp.asarray(kx),
            jnp.asarray(kf))
    td, ti = tknn.hybrid_knn(t(xyz), t(feat), t(kx), t(kf), K, 0.5,
                             point_valid=t(alive))
    assert ti.dtype == torch.int32
    q = np.concatenate([xyz, feat * 0.5], 1).astype(np.float64)
    p = np.concatenate([kx, kf * 0.5], 1).astype(np.float64)
    d64 = ((q[:, None, :] - p[None]) ** 2).sum(-1)
    d64[:, ~alive] = np.inf
    tie = _near_ties(np.sort(d64, axis=1), K)
    assert tie.mean() < 0.05
    np.testing.assert_array_equal(n(ti)[~tie], n(ji)[~tie])
    assert alive[n(ti)].all()
    np.testing.assert_allclose(n(td), n(jd), rtol=0,
                               atol=1e-5 * (1.0 + float(n(jd).max())))


def test_fps_matches_jax():
    rng = np.random.default_rng(5)
    pts = rng.uniform(-1, 1, (3000, 3)).astype(np.float32)
    valid = rng.random(3000) < 0.7
    ji = jax.jit(lambda p, v: jfps.furthest_point_sampling(
        p, 64, valid=v, start_idx=17))(jnp.asarray(pts), jnp.asarray(valid))
    ti = tfps.furthest_point_sampling(t(pts), 64, valid=t(valid),
                                      start_idx=17)
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(n(ti), n(ji))
    assert valid[n(ti)].all() and len(set(n(ti).tolist())) == 64


def _blobs(k=12, per=250, D=35, seed=6):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-5, 5, (k, D))
    x = (np.repeat(centers, per, 0)
         + rng.normal(0, 0.05, (k * per, D))).astype(np.float32)
    perm = rng.permutation(k * per)
    valid = rng.random(k * per) < 0.9
    return x[perm], valid


def test_feature_kmeans_matches_jax():
    feats, valid = _blobs()
    xyz = feats[:, :3].copy()
    key = jax.random.PRNGKey(3)
    start = int(jax.random.randint(key, (), 0, feats.shape[0]))
    (jx, jc), ja = jax.jit(lambda a, b, v: (
        jkm.feature_kmeans(a, b, 12, key, valid=v),
        jkm.kmeans(b, 12, key, valid=v)[1]))(
            jnp.asarray(xyz), jnp.asarray(feats), jnp.asarray(valid))
    tx, tc = tkm.feature_kmeans(t(xyz), t(feats), 12, valid=t(valid),
                                start_idx=start)
    np.testing.assert_allclose(n(tc), n(jc), rtol=0, atol=1e-5)
    np.testing.assert_allclose(n(tx), n(jx), rtol=0, atol=1e-5)
    _, ta = tkm.kmeans(t(feats), 12, valid=t(valid), start_idx=start)
    np.testing.assert_array_equal(n(ta)[valid], n(ja)[valid])
    # one cluster per blob
    assert len(set(n(ta)[valid].tolist())) == 12
    # drawn from a generator instead of handed over: a valid clustering
    _, ga = tkm.kmeans(t(feats), 12, torch.Generator().manual_seed(0),
                       n_iters=5, valid=t(valid))
    assert ga.shape == (feats.shape[0],)
