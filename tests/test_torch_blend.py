"""Parity of the port's tile blend (ops/rasterize_kernels.py), forward and
backward, and its torch oracle (ops/rasterize_reference.py) with the JAX
package.

The same instance stream (built by the JAX package) is blended by the
JAX Pallas forward kernel (interpret mode) and by the port. The port
follows the CUDA semantics of the oracle (sequential T *= 1-alpha, the
done latch at T < 1e-4, tidx = first strict maximum of the weight); the
Pallas kernel scans in 256-lane chunks, so the two differ at the ulp
level in association. Tolerances are the JAX package's own
(tests/test_rasterizer.py): rgb and T 2e-5, depth 2e-4; tidx is held
equal at every pixel whose top weight beats the runner-up by more than
1e-6 relative (ties break differently by design).

The backward's plain version is held to the JAX custom VJP (Pallas
backward kernel, interpret mode) on the same stream and cotangent, row by
row within 2e-4 of the row's largest magnitude: the tolerance the JAX
package holds its own backward to against the oracle
(tests/test_rasterizer.py), since the Pallas kernel sums through bf16x3
MXU splits and takes dop = sum(dpower) / op. Through the port's render it
is held to the gradient of the JAX lax.scan oracle with that same
tolerance.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import n, one_torch_thread, scene, t  # noqa: F401

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


@pytest.mark.parametrize("case", ["unaligned", "saturated"])
def test_backward_matches_pallas_vjp(case):
    """Segments start anywhere in the stream (unaligned); with high
    opacity the done latch fires (saturated)."""
    import jax

    boost = 4.0 if case == "saturated" else 0.0
    s = _stream(1500, seed=1, opacity_boost=boost)
    assert (np.asarray(s.tile_start) % 128 != 0).any()
    out, vjp = jax.vjp(
        lambda inst: JR.rasterize_binned(inst, s.tile_start, s.tile_end, GX,
                                         GY, True, False), s.inst)
    cot = np.random.default_rng(3).normal(size=out.shape).astype(np.float32)
    (ref,) = vjp(jnp.asarray(cot))
    inst = t(s.inst)
    ours_out = TR.rasterize_binned(inst, t(s.tile_start), t(s.tile_end), GX,
                                   GY, False)
    if case == "saturated":
        assert (n(ours_out)[..., TR.O_T] < 1e-3).any()
    dpix = TR.pixel_grads(ours_out, t(cot))
    ours = TR.rasterize_binned_bwd_plain(inst, t(s.tile_start),
                                         t(s.tile_end), GX, GY, dpix)
    # the wrapper takes the plain version for CPU tensors
    assert torch.equal(TR.rasterize_binned_bwd(
        inst, t(s.tile_start), t(s.tile_end), GX, GY, dpix), ours)
    ref = np.asarray(ref)[:, :ours.shape[1]]
    ours = n(ours)
    assert not ours[10:].any()
    for c in range(10):
        scale = np.abs(ref[c]).max()
        assert scale > 0
        np.testing.assert_allclose(ours[c], ref[c], rtol=0,
                                   atol=2e-4 * scale, err_msg=f"row {c}")


def test_render_gradients_match_jax_oracle():
    """d loss / d (xyz, log scale, rotation, opacity, colour) through the
    port's render (stream and blend backward) against the JAX lax.scan
    oracle's, as tests/test_rasterizer.py holds the Pallas render."""
    import jax

    from gaussianprediction_tpu.data.synthetic import random_gaussians
    from gaussianprediction_tpu_torch.data.synthetic import (
        orbit_camera as torbit,
    )
    from gaussianprediction_tpu_torch.ops.rasterize import render

    g = random_gaussians(100, seed=2, scale_range=(-3.4, -2.0))
    opac = (1.0 / (1.0 + np.exp(-g["opacity_logit"][:, 0]))).astype(
        np.float32)
    cam = orbit_camera(0.5, width=W, height=H).to_device_dict()
    tcam = torbit(0.5, width=W, height=H).to_device_dict("cpu")
    target = np.random.default_rng(9).uniform(0, 1, (H, W, 3)).astype(
        np.float32)

    def loss_oracle(xyz, log_s, rot, op, col):
        rot = rot / jnp.linalg.norm(rot, axis=-1, keepdims=True)
        proj = JP.project_from_params(xyz, jnp.exp(log_s), rot, cam, W, H)
        rgb, depth, _, _ = JO.rasterize_pixels_reference(
            proj, col, op, jnp.zeros(3), W, H)
        return jnp.mean((rgb - target) ** 2) + 0.1 * jnp.mean(depth)

    args = [g["xyz"], g["log_scales"], g["rotation"], opac, g["colors"]]
    ref = jax.grad(loss_oracle, argnums=(0, 1, 2, 3, 4))(
        *[jnp.asarray(a) for a in args])
    targs = [t(a).requires_grad_(True) for a in args]
    xyz, log_s, rot, op, col = targs
    out = render(xyz, torch.exp(log_s), rot, op, None, tcam, W, H,
                 torch.zeros(3), colors_precomp=col)
    assert int(out["n_dropped"]) == 0
    loss = torch.mean((out["render"] - t(target)) ** 2) + \
        0.1 * torch.mean(out["depth"])
    loss.backward()
    names = ["xyz", "log_scales", "rotation", "opacity", "colors"]
    for name, a, b in zip(names, targs, ref):
        scale = max(np.abs(np.asarray(b)).max(), 1e-6)
        np.testing.assert_allclose(n(a.grad), np.asarray(b), rtol=0,
                                   atol=2e-4 * scale + 1e-8, err_msg=name)
