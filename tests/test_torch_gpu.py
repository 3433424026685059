"""Card-only tests of the port's CUDA kernels (marker `gpu`).

Each holds one kernel to its plain PyTorch version on the card, at the
plain version's own contract: stack, expand and interleave equal bit for
bit; the blend within 2e-5 on rgb and T and 2e-4 on depth, tidx equal where
the top weight beats the runner-up by more than 1e-6 relative (the same
tolerances as the CPU parity tests, though the two agree bit for bit on an
H100 in practice). The backward blend sums each instance's per-pixel
products in another order than the plain version (warp shuffles, then
warps), so its rows 0-9 are held to 1e-5 of the row's largest magnitude,
with at most 0.1% of the columns beyond it (a done latch that flips on an
ulp), and two launches bit-identical. The scans are held to
64 * 2^-24 * cumsum(|x|), a bound on f32 roundoff of sums of that depth.
One training step on the card is held to the same step on the CPU through
the plain versions. The table-gradient kernel scatter_add_sorted is held
per slot to 64 * 2^-24 * Σ|contributions| of its plain version (the same
roundoff bound; on the card the plain version's index_add_ sums with
atomics in no fixed order) and to the serial sum on the CPU bit for bit
(the kernel sums each run in stream order, as that loop does), with two
launches bit-identical; a stage-2 step run twice from one state is
bit-identical. Whether a card is present is decided inside the
`cuda_device` fixture; without one every test here skips.

This file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -m gpu
"""
import numpy as np
import pytest
import torch

from torch_port_util import cuda_device  # noqa: F401

from gaussianprediction_tpu_torch.data.synthetic import (
    orbit_camera, random_gaussians,
)
from gaussianprediction_tpu_torch.kernels import launch_counts
from gaussianprediction_tpu_torch.ops import expand as TE
from gaussianprediction_tpu_torch.ops import hashgrid_kernels as THK
from gaussianprediction_tpu_torch.ops import rasterize_kernels as TR
from gaussianprediction_tpu_torch.ops import scan as TS

pytestmark = pytest.mark.gpu


def _gaussians(num, seed, dev, scale_range=(-5.0, -3.0), boost=0.0):
    g = random_gaussians(num, seed=seed, scale_range=scale_range)
    t = {k: torch.from_numpy(v).to(dev) for k, v in g.items()}
    op = torch.sigmoid(t["opacity_logit"][:, 0] + boost)
    rot = t["rotation"] / torch.linalg.norm(t["rotation"], dim=-1,
                                            keepdim=True)
    return t["xyz"], torch.exp(t["log_scales"]), rot, op, t["colors"]


def test_stack_kernel_equals_plain(cuda_device):
    chans = [torch.randn(100_003, device=cuda_device) for _ in range(15)]
    before = launch_counts["stack"]
    out = TE.stack_rows(chans, nch=16)
    torch.cuda.synchronize()
    assert launch_counts["stack"] == before + 1
    assert torch.equal(out, TE.stack_rows_plain(chans, 16))


@pytest.mark.parametrize("emit", [False, True])
def test_expand_kernel_equals_plain(cuda_device, emit):
    r = np.random.default_rng(3)
    rw = r.integers(0, 9, 50_000).astype(np.int32)
    rh = r.integers(1, 7, 50_000).astype(np.int32)
    count1 = np.maximum(rw * rh, 1)
    offs = (np.cumsum(count1) - count1).astype(np.int32)
    rows = np.zeros((16, rw.size), np.float32)
    rows[:10] = r.normal(size=(10, rw.size))
    rows[10], rows[11], rows[12] = offs, r.integers(0, 45, rw.size), \
        r.integers(0, 44, rw.size)
    rows[13], rows[14] = rw, np.arange(rw.size)
    total1 = int(count1.sum())
    cap = total1 + 5000
    args = (torch.from_numpy(rows).to(cuda_device),
            torch.from_numpy(offs).to(cuda_device),
            torch.tensor([total1 - 77], dtype=torch.int32,
                         device=cuda_device))
    before = launch_counts["expand"]
    if emit:
        out = TE.expand_emit(*args, cap, 50, 2500)
        ref = TE.emit_from_raw(TE.expand_rows_raw_plain(*args, cap),
                               args[2], 50, 2500)
    else:
        out = TE.expand_rows_raw(*args, cap)
        ref = TE.expand_rows_raw_plain(*args, cap)
    torch.cuda.synchronize()
    assert launch_counts["expand"] == before + 1
    assert torch.equal(out, ref)


def test_interleave_kernel_equals_plain(cuda_device):
    chans = [torch.randn(70_001, device=cuda_device) for _ in range(11)]
    before = launch_counts["interleave"]
    out = TE.interleave_rows(chans)
    torch.cuda.synchronize()
    assert launch_counts["interleave"] == before + 1
    assert torch.equal(out, TE.interleave_rows_plain(chans))


@pytest.mark.parametrize("boost", [0.0, 4.0], ids=["sparse", "dense"])
def test_blend_kernel_equals_plain(cuda_device, boost):
    from gaussianprediction_tpu_torch.ops import projection as PJ
    from gaussianprediction_tpu_torch.ops.instance_stream import (
        build_instances_fwd,
    )

    W = H = 256
    xyz, scal, rot, op, col = _gaussians(20_000, 1, cuda_device, boost=boost)
    cam = orbit_camera(0.5, width=W, height=H).to_device_dict(cuda_device)
    proj = PJ.project_from_params(xyz, scal, rot, cam, W, H, opacity=op)
    feat = torch.cat([proj.mean2d, proj.conic, op[:, None], col,
                      proj.depth[:, None]], dim=-1)
    s = build_instances_fwd(feat, proj.tiles_min, proj.tiles_max,
                            proj.visible, 16, 16, 12 * 20_000)
    assert int(s.n_dropped) == 0
    before = launch_counts["blend_fwd"]
    out = TR.rasterize_binned(s.inst, s.tile_start, s.tile_end, 16, 16)
    torch.cuda.synchronize()
    assert launch_counts["blend_fwd"] == before + 1
    aux = {}
    ref = TR.rasterize_binned_plain(s.inst, s.tile_start, s.tile_end, 16,
                                    16, aux=aux)
    err = (out - ref).abs()
    assert float(err[..., [0, 1, 2, 4]].max()) <= 2e-5
    assert float(err[..., 3].max()) <= 2e-4
    wmax = ref[..., TR.O_WMAX]
    clear = (wmax - aux["w2"]) > 1e-6 * wmax
    assert torch.equal(out[..., TR.O_GID][clear], ref[..., TR.O_GID][clear])


def _stream_on(dev, num, boost, W=256):
    from gaussianprediction_tpu_torch.ops import projection as PJ
    from gaussianprediction_tpu_torch.ops.instance_stream import (
        build_instances_fwd,
    )

    g = W // 16
    xyz, scal, rot, op, col = _gaussians(num, 1, dev, boost=boost)
    cam = orbit_camera(0.5, width=W, height=W).to_device_dict(dev)
    proj = PJ.project_from_params(xyz, scal, rot, cam, W, W, opacity=op)
    feat = torch.cat([proj.mean2d, proj.conic, op[:, None], col,
                      proj.depth[:, None]], dim=-1)
    s = build_instances_fwd(feat, proj.tiles_min, proj.tiles_max,
                            proj.visible, g, g, 12 * num)
    assert int(s.n_dropped) == 0
    return s, g


@pytest.mark.parametrize("boost", [0.0, 4.0], ids=["sparse", "dense"])
def test_blend_bwd_kernel_equals_plain(cuda_device, boost):
    s, g = _stream_on(cuda_device, 20_000, boost)
    out = TR.rasterize_binned(s.inst, s.tile_start, s.tile_end, g, g)
    cot = torch.randn(out.shape, device=cuda_device,
                      generator=torch.Generator(cuda_device).manual_seed(0))
    dpix = TR.pixel_grads(out, cot)
    before = launch_counts["blend_bwd"]
    a = TR.rasterize_binned_bwd(s.inst, s.tile_start, s.tile_end, g, g, dpix)
    b = TR.rasterize_binned_bwd(s.inst, s.tile_start, s.tile_end, g, g, dpix)
    torch.cuda.synchronize()
    assert launch_counts["blend_bwd"] == before + 2
    assert torch.equal(a, b)                      # deterministic
    ref = TR.rasterize_binned_bwd_plain(s.inst, s.tile_start, s.tile_end, g,
                                        g, dpix)
    assert not a[10:].any()
    scale = ref[:10].abs().amax(dim=1, keepdim=True).clamp(min=1e-30)
    bad = ((a[:10] - ref[:10]).abs() > 1e-5 * scale).any(dim=0)
    assert float(ref[:10].abs().max()) > 0
    assert int(bad.sum()) <= 1e-3 * int((ref[:10] != 0).any(dim=0).sum())


def test_scan_kernels_equal_cumsum(cuda_device):
    gen = torch.Generator(cuda_device).manual_seed(1)
    n = 1_000_003
    chans = [torch.randn(n, device=cuda_device, generator=gen)
             for _ in range(10)]
    eps = 2.0 ** -24
    before = dict(launch_counts)
    out = TS.cumsum_channels(chans)
    ref = TS.cumsum_channels_plain(chans)
    mat = torch.randn((16, n), device=cuda_device, generator=gen)
    out2 = TS.cumsum_rows(mat)
    ref2 = TS.cumsum_rows_plain(mat)
    torch.cuda.synchronize()
    assert launch_counts["cumsum_channels"] == \
        before.get("cumsum_channels", 0) + 1
    assert launch_counts["cumsum_rows"] == before.get("cumsum_rows", 0) + 1
    assert not out[10:].any()
    stacked = torch.stack(chans)
    tol = 64 * eps * torch.cumsum(stacked.abs(), dim=1)
    assert bool(((out[:10] - ref[:10]).abs() <= tol).all())
    tol2 = 64 * eps * torch.cumsum(mat.abs(), dim=1)
    assert bool(((out2 - ref2).abs() <= tol2).all())
    assert torch.equal(out2, TS.cumsum_rows(mat))   # deterministic


def _sorted_stream(case, dev):
    """(keys, vals, n_slots) of one case, sorted, on the card."""
    g = torch.Generator().manual_seed(3)
    if case == "random":
        n_slots = 1_000_003                      # not a multiple of 256
        keys = torch.randint(0, n_slots, (3_000_000,), generator=g)
    elif case == "skewed":
        n_slots = 50_001
        keys = torch.cat([torch.full((1_000_000,), 777),
                          torch.randint(0, n_slots, (200_000,), generator=g)])
    else:  # "empty": whole ranges of slots receive nothing
        n_slots = 300_007
        keys = torch.cat([torch.randint(0, 1000, (100_000,), generator=g),
                          torch.randint(250_000, 260_000, (100_000,),
                                        generator=g)])
    keys = torch.sort(keys.to(torch.int32)).values
    vals = torch.randn((4, keys.shape[0]), generator=g)
    return keys.to(dev), vals.to(dev), n_slots


@pytest.mark.parametrize("case", ["random", "skewed", "empty"])
def test_scatter_add_sorted_kernel_equals_plain(cuda_device, case):
    keys, vals, n_slots = _sorted_stream(case, cuda_device)
    before = launch_counts["scatter_add_sorted"]
    a = THK.scatter_add_sorted(keys, vals, n_slots)
    b = THK.scatter_add_sorted(keys, vals, n_slots)
    torch.cuda.synchronize()
    assert launch_counts["scatter_add_sorted"] == before + 2
    assert torch.equal(a, b)                      # deterministic
    ref = THK.scatter_add_sorted_plain(keys, vals, n_slots)
    tol = 64 * 2.0 ** -24 * THK.scatter_add_sorted_plain(keys, vals.abs(),
                                                         n_slots)
    assert bool(((a - ref).abs() <= tol).all())
    serial = THK.scatter_add_sorted_plain(keys.cpu(), vals.cpu(), n_slots)
    assert torch.equal(a.cpu(), serial)
    hit = torch.zeros(n_slots, dtype=torch.bool, device=cuda_device)
    hit[keys.to(torch.int64)] = True
    assert not a[:, ~hit].any()


def test_stage2_step_on_card_is_deterministic(cuda_device):
    """A `test`-preset model through the stage-1 -> 2 transition, then one
    stage-2 step (kernel #7 and the keypoint blend's GEMM backward) run
    twice from the same state: loss, params and moments bit-identical."""
    from gaussianprediction_tpu_torch.config import get_preset
    from gaussianprediction_tpu_torch.models.gaussians import create_from_pcd
    from gaussianprediction_tpu_torch.train import optimizer as O
    from gaussianprediction_tpu_torch.train.loop import stage_transition
    from gaussianprediction_tpu_torch.train.step import make_train_step

    cfg = get_preset("test")
    rng = np.random.default_rng(4)
    pts = rng.uniform(-1, 1, (400, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (400, 3)).astype(np.float32)
    state = create_from_pcd(cfg, pts, cols, torch.Generator().manual_seed(0),
                            device=cuda_device)
    params = dict(state.params)
    params["motion_feature"] = 0.3 * torch.randn(
        params["motion_feature"].shape, device=cuda_device,
        generator=torch.Generator(cuda_device).manual_seed(1))
    state = state.replace(params=params)
    it = cfg.train.second_stage_iteration + 1
    state, opt = stage_transition(state, O.init_adam(state.params), cfg, it,
                                  torch.Generator(cuda_device).manual_seed(2))
    step = make_train_step(cfg, 2, 64, 64, 1.0, 1, 50,
                           torch.zeros(3, device=cuda_device))
    cam = orbit_camera(0.9, width=64, height=64).to_device_dict(cuda_device)
    gt = torch.rand((64, 64, 3), device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(3))
    before = launch_counts["scatter_add_sorted"]
    outs = [step(state, opt, cam, gt, torch.tensor(0.3, device=cuda_device),
                 it, torch.Generator(cuda_device).manual_seed(5))
            for _ in range(2)]
    assert launch_counts["scatter_add_sorted"] == before + 2
    (s1, o1, m1), (s2, o2, m2) = outs
    assert int(m1["n_dropped"]) == 0 and torch.isfinite(m1["loss"])
    assert torch.equal(m1["loss"], m2["loss"])
    for a, b in zip(O.tree_leaves([s1.params, o1["m"], o1["v"]]),
                    O.tree_leaves([s2.params, o2["m"], o2["v"]])):
        assert torch.equal(a, b)


def test_render_matches_oracle_on_card(cuda_device):
    from gaussianprediction_tpu_torch.ops import projection as PJ
    from gaussianprediction_tpu_torch.ops.rasterize import render
    from gaussianprediction_tpu_torch.ops.rasterize_reference import (
        rasterize_pixels_reference,
    )

    W = H = 64
    xyz, scal, rot, op, col = _gaussians(300, 2, cuda_device,
                                         scale_range=(-3.4, -2.0))
    cam = orbit_camera(0.5, width=W, height=H).to_device_dict(cuda_device)
    bg = torch.tensor([0.2, 0.1, 0.0], device=cuda_device)
    out = render(xyz, scal, rot, op, None, cam, W, H, bg,
                 colors_precomp=col)
    proj = PJ.project_from_params(xyz, scal, rot, cam, W, H, opacity=op)
    rgb, depth, alpha, _ = rasterize_pixels_reference(proj, col, op, bg, W,
                                                      H)
    assert int(out["n_dropped"]) == 0
    assert float((out["render"] - rgb).abs().max()) <= 2e-5
    assert float((out["alpha"] - alpha).abs().max()) <= 2e-5
    assert float((out["depth"] - depth).abs().max()) <= 2e-4


def test_wrappers_reject_mixed_devices(cuda_device):
    with pytest.raises(ValueError):
        TE.stack_rows([torch.zeros(8), torch.zeros(8, device=cuda_device)])
    with pytest.raises(ValueError):
        TS.cumsum_channels([torch.zeros(8),
                            torch.zeros(8, device=cuda_device)])
    ts = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError):
        TR.rasterize_binned_bwd(torch.zeros((16, 8), device=cuda_device), ts,
                                ts, 1, 1, torch.zeros((1, 256, 8)))


def test_train_step_on_card_matches_cpu(cuda_device):
    """One stage-1 step at 2k Gaussians and 128x128 on the card (kernels)
    and on the CPU (plain versions), from the same state: loss to 1e-5
    relative, each gradient to 2e-4 of its largest magnitude (the backward
    sums in another order, and CUDA's and the CPU's exp differ in the last
    ulp), params to 2e-3 of the group's learning rate (v0 > 0 keeps the
    update smooth in the gradient), the statistics' integer parts equal."""
    from gaussianprediction_tpu_torch.config import get_preset
    from gaussianprediction_tpu_torch.convert import (
        opt_state_from_arrays, state_from_params,
    )
    from gaussianprediction_tpu_torch.models.gaussians import (
        deform_mlp_sizes,
    )
    from gaussianprediction_tpu_torch.ops.mlp import init_mlp
    from gaussianprediction_tpu_torch.train import optimizer as O
    from gaussianprediction_tpu_torch.train.step import make_train_step
    from gaussianprediction_tpu_torch.utils.sh import rgb_to_sh

    cfg = get_preset("dnerf")
    num, W = 2000, 128
    g = random_gaussians(num, seed=11, scale_range=(-5.0, -3.0))
    rng = np.random.default_rng(12)
    params = {
        "xyz": g["xyz"], "features_dc": rgb_to_sh(g["colors"])[:, None, :],
        "features_rest": (0.1 * rng.normal(size=(num, 15, 3))).astype(
            np.float32),
        "scaling": g["log_scales"], "rotation": g["rotation"],
        "opacity": g["opacity_logit"],
        "motion_feature": (1e-3 * rng.normal(size=(num, 32))).astype(
            np.float32),
        "df_mlp": init_mlp(rng, deform_mlp_sizes(cfg)),
    }
    v0 = O.tree_map(lambda x: np.full(x.shape, 0.04 * (np.abs(x).mean()
                                                        + 1e-3) ** 2,
                                      np.float32), params)
    opt = {"m": O.tree_map(np.zeros_like, params), "v": v0, "step": 3}
    gt = rng.uniform(0, 1, (W, W, 3)).astype(np.float32)
    noise = rng.normal(size=(num, 3)).astype(np.float32)
    out = {}
    for dev in (torch.device("cpu"), cuda_device):
        state = state_from_params(params, np.ones(num, bool), device=dev)
        step = make_train_step(cfg, 1, W, W, 1.0, 3, 50,
                               torch.zeros(3, device=dev))
        cam = orbit_camera(0.9, width=W, height=W).to_device_dict(dev)
        before = launch_counts["blend_bwd"]
        out[dev.type] = step(state, opt_state_from_arrays(opt, dev), cam,
                             torch.from_numpy(gt).to(dev),
                             torch.tensor(0.3, device=dev), 2000,
                             noise=torch.from_numpy(noise).to(dev),
                             time_noise=torch.tensor(0.5, device=dev))
        if dev.type == "cuda":
            assert launch_counts["blend_bwd"] == before + 1
    (sc, oc, mc), (sg, og, mg) = out["cpu"], out["cuda"]
    assert int(mg["n_dropped"]) == int(mc["n_dropped"]) == 0
    assert float(mg["loss"]) == pytest.approx(float(mc["loss"]), rel=1e-5)
    groups = O.active_groups(cfg, 1)
    for key in mc["grads"]:
        lr = float(O.group_lr(O.GROUP_OF_PARAM[key], cfg, 1.0, 2000))
        assert O.GROUP_OF_PARAM[key] in groups
        for a, b, pa, pb in zip(O.tree_leaves(mg["grads"][key]),
                                O.tree_leaves(mc["grads"][key]),
                                O.tree_leaves(sg.params[key]),
                                O.tree_leaves(sc.params[key])):
            scale = float(b.abs().max())
            assert float((a.cpu() - b).abs().max()) <= 2e-4 * scale, key
            assert float((pa.cpu() - pb).abs().max()) <= 2e-3 * lr, key
    assert torch.equal(sg.denom.cpu(), sc.denom)
    assert torch.equal(sg.max_radii2D.cpu(), sc.max_radii2D)
