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

from torch_port_util import (  # noqa: F401
    adversarial_stream, crafted_stream, n, one_torch_thread, scene, t,
)

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
    assert 0 < aux["warp_pairs_kept"] < aux["warp_pairs"]
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


def test_backward_plain_sums_in_kernel_order():
    """sums="kernel" sums each tile's pixels as the backward kernels do:
    halves within each warp of 32 pixels (offsets 16 down to 1), then the
    eight warps left to right; bit for bit against a float32 numpy loop in
    that order. The whole plain backward in that order differs from the
    default (torch's reduction) only by the sums' f32 roundoff (within
    1e-6 of each row's largest magnitude; 2.4e-7 measured), since the
    per-pixel walk (T, S, the latch) does not read the sums; and the
    variants' plain versions in it equal the classic one bit for bit."""
    from gaussianprediction_tpu_torch.ops import blend_variants as TBV

    rng = np.random.default_rng(5)
    x = (rng.standard_normal((10, 3, 256))
         * 10.0 ** rng.integers(-6, 6, (10, 3, 256))).astype(np.float32)
    x[rng.random(x.shape) < 0.5] = 0.0
    got = n(TR._pixel_sums(t(x), "kernel"))
    ref = np.empty((10, 3), np.float32)
    for i in np.ndindex(10, 3):
        w = x[i].reshape(8, 32)
        for o in (16, 8, 4, 2, 1):
            w = (w[:, :o] + w[:, o:]).astype(np.float32)
        acc = w[0, 0]
        for k in range(1, 8):
            acc = np.float32(acc + w[k, 0])
        ref[i] = acc
    assert np.array_equal(got.view(np.int32), ref.view(np.int32))
    with pytest.raises(ValueError):
        TR._pixel_sums(t(x), "serial")

    counts = np.random.default_rng(2).integers(0, 400, GX * GY)
    inst, ts, te = (t(a) for a in crafted_stream(counts, GX, 7,
                                                  opacity=(0.3, 0.9)))
    out = TR.rasterize_binned(inst, ts, te, GX, GY, False)
    assert (n(out)[..., TR.O_T] < 1e-3).any()        # latches fire
    cot = t(np.random.default_rng(3).normal(size=out.shape).astype(
        np.float32))
    dpix = TR.pixel_grads(out, cot)
    a = TR.rasterize_binned_bwd_plain(inst, ts, te, GX, GY, dpix,
                                      sums="kernel")
    b = TR.rasterize_binned_bwd_plain(inst, ts, te, GX, GY, dpix)
    scale = b[:10].abs().amax(dim=1, keepdim=True)
    assert float(scale.min()) > 0 and not torch.equal(a, b)
    assert float(((a - b)[:10].abs() / scale).max()) <= 1e-6
    c = TBV.rasterize_binned_bwd_smt_plain(inst, ts, te, GX, GY, 3, dpix,
                                           sums="kernel")
    assert torch.equal(c.view(torch.int32), a.view(torch.int32))


def _passing_pixels(inst, tile, col, grid_x, grid_y):
    """[N, 256] bool: for the segment entry of each (tile, col), which of
    its tile's pixels (by pixel index) pass the plain version's f32 tests
    (valid, power <= 0, alpha >= 1/255), the done latch ignored."""
    px, py = TR._pixel_coords(grid_x, grid_y, "cpu")
    d = inst[:, col][:, :, None]
    dx = px[tile] - d[TR.C_MX]
    dy = py[tile] - d[TR.C_MY]
    power = -0.5 * (d[TR.C_CA] * dx * dx + d[TR.C_CC] * dy * dy) \
        - d[TR.C_CB] * dx * dy
    alpha = torch.clamp(d[TR.C_OP] * torch.exp(power), max=TR.ALPHA_CLAMP)
    return (d[TR.C_VALID] > 0.5) & (power <= 0.0) & (alpha >= TR.ALPHA_MIN)


def test_fwd_warp_cull_keeps_every_passing_pair():
    """The forward kernels skip an instance for a warp only where no pixel
    of the warp passes the alpha test (ops/rasterize_kernels.py:warp_keep,
    the plain model of common.cuh's warp_keeps). Held on crafted_stream's
    instances and adversarial_stream's: support ellipses that end within
    1e-3 px of a warp edge on either side (with the margins set to zero
    the model drops some of their passing pairs), op one ulp either side
    of 1/255, degenerate conics, non-finite channels, invalid instances
    and far means. The cull must still skip a real share of the pairs."""
    inst, ts, te, gx, gy = adversarial_stream(seed=3)
    inst, ts, te = t(inst), t(ts), t(te)
    tile, cols, keep = TR.fwd_warp_keep(inst, ts, te, gx, gy)
    ok = _passing_pixels(inst, tile, cols, gx, gy)
    need = ok[:, TR.fwd_thread_pixels()].view(-1, TR.WARPS, 32).any(-1)
    assert int(need.sum()) > 1000
    assert not (need & ~keep).any()
    assert float(keep.float().mean()) < 0.6
    ch = inst[:, cols].to(torch.float64)
    valid = ch[TR.C_VALID] > 0.5
    odd = ~torch.isfinite(ch[:6]).all(0) | (ch[TR.C_OP] <= TR.CULL_OP_MIN) \
        | (ch[TR.C_CA] * ch[TR.C_CC] <= ch[TR.C_CB] ** 2)
    assert int((valid & odd).sum()) >= 10 and int((~valid).sum()) >= 2
    assert keep[valid & odd].all() and not keep[~valid].any()
