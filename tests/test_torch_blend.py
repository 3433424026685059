"""Parity of the port's forward tile blend (ops/rasterize_kernels.py) and
its torch oracle (ops/rasterize_reference.py) with the JAX package.

The same instance stream (built by the JAX package) is blended by the
JAX Pallas forward kernel (interpret mode) and by the port. The port
follows the CUDA semantics of the oracle (sequential T *= 1-alpha, the
done latch at T < 1e-4, tidx = first strict maximum of the weight); the
Pallas kernel scans in 256-lane chunks, so the two differ at the ulp
level in association. Tolerances are the JAX package's own
(tests/test_rasterizer.py): rgb and T 2e-5, depth 2e-4; tidx is held
equal at every pixel whose top weight beats the runner-up by more than
1e-6 relative (ties break differently by design).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import n, scene, t

from gaussianprediction_tpu.data.synthetic import orbit_camera
from gaussianprediction_tpu.ops import instance_stream as JS
from gaussianprediction_tpu.ops import projection as JP
from gaussianprediction_tpu.ops import rasterize_pallas as JR
from gaussianprediction_tpu.ops import rasterize_reference as JO
from gaussianprediction_tpu_torch.ops import projection as TP
from gaussianprediction_tpu_torch.ops import rasterize_kernels as TR
from gaussianprediction_tpu_torch.ops import rasterize_reference as TO

W, H = 128, 112
GX, GY = 8, 7


def _projected(num, seed, opacity_boost=0.0, scale_range=(-5.0, -3.0)):
    g = scene(num, seed=seed, scale_range=scale_range,
              opacity_boost=opacity_boost)
    cam = orbit_camera(0.5, width=W, height=H).to_device_dict()
    q = g["rotation"] / np.linalg.norm(g["rotation"], axis=-1, keepdims=True)
    proj = JP.project_from_params(
        jnp.asarray(g["xyz"]), jnp.asarray(g["scaling"]), jnp.asarray(q),
        cam, W, H, opacity=jnp.asarray(g["opacity"]))
    feat = jnp.concatenate(
        [proj.mean2d, proj.conic, jnp.asarray(g["opacity"])[:, None],
         jnp.asarray(g["colors"]), proj.depth[:, None]], axis=-1)
    return g, proj, feat


def _stream(num, seed, opacity_boost=0.0):
    """The JAX package's instance stream of a random scene."""
    _, proj, feat = _projected(num, seed, opacity_boost)
    stream, _ = JS.build_instances_fwd(
        feat, proj.depth, proj.tiles_min, proj.tiles_max, proj.visible,
        GX, GY, 12 * num, 1024, interpret=True)
    assert int(stream.n_dropped) == 0
    return stream


def _assert_blend_close(ours, ref, w2):
    ours, ref = n(ours), n(ref)
    for c, tol in ((0, 2e-5), (1, 2e-5), (2, 2e-5), (4, 2e-5), (3, 2e-4)):
        np.testing.assert_allclose(ours[..., c], ref[..., c], atol=tol,
                                   rtol=0, err_msg=f"channel {c}")
    wmax = ours[..., TR.O_WMAX]
    clear = (wmax - n(w2)) > 1e-6 * wmax
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(ours[..., TR.O_GID][clear],
                                  ref[..., TR.O_GID][clear])


@pytest.mark.parametrize("case", ["sparse", "dense_occlusion"])
def test_blend_matches_pallas_kernel(case):
    boost = 4.0 if case == "dense_occlusion" else 0.0
    s = _stream(1500, seed=1, opacity_boost=boost)
    ref = JR.rasterize_binned(s.inst, s.tile_start, s.tile_end, GX, GY,
                              True, True)
    aux = {}
    ours = TR.rasterize_binned_plain(t(s.inst), t(s.tile_start),
                                     t(s.tile_end), GX, GY, True, aux=aux)
    assert aux["pairs"] > 0
    # the wrapper takes the plain version for CPU tensors
    wrapped = TR.rasterize_binned(t(s.inst), t(s.tile_start),
                                  t(s.tile_end), GX, GY, True)
    assert torch.equal(wrapped, ours)
    _assert_blend_close(ours, ref, aux["w2"])
    if case == "dense_occlusion":   # the done latch fired somewhere
        assert (n(ours)[..., TR.O_T] < 1e-3).any()


def test_without_tidx():
    from gaussianprediction_tpu_torch.ops.instance_stream import (
        build_instances_fwd,
    )

    _, proj, feat = _projected(500, seed=2)
    s = build_instances_fwd(t(feat), t(proj.tiles_min), t(proj.tiles_max),
                            t(proj.visible), GX, GY, 6000)
    out = TR.rasterize_binned(s.inst, s.tile_start, s.tile_end, GX, GY,
                              with_tidx=False)
    assert (n(out)[..., TR.O_WMAX] == 0).all()
    assert (n(out)[..., TR.O_GID] == -1).all()
    assert (n(out)[..., TR.O_T] < 1).any()


def test_torch_oracle_matches_jax_oracle():
    g, proj, _ = _projected(400, seed=3, scale_range=(-3.4, -2.0))
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    ref = JO.rasterize_pixels_reference(
        proj, jnp.asarray(g["colors"]), jnp.asarray(g["opacity"]),
        jnp.asarray(bg), W, H)
    tproj = TP.Projected(*[t(x) for x in proj])
    ours = TO.rasterize_pixels_reference(tproj, t(g["colors"]),
                                         t(g["opacity"]), t(bg), W, H)
    np.testing.assert_allclose(n(ours[0]), n(ref[0]), atol=2e-5)
    np.testing.assert_allclose(n(ours[1]), n(ref[1]), atol=2e-4)
    np.testing.assert_allclose(n(ours[2]), n(ref[2]), atol=2e-5)
    assert np.mean(n(ours[3]) == n(ref[3])) > 0.99
