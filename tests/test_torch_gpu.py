"""Card-only tests of the port's CUDA kernels (marker `gpu`).

Each holds one kernel to its plain PyTorch version on the card, at the
plain version's own contract: stack, expand and interleave equal bit for
bit; the forward blend kernels (classic, flat, multi-tile, sequential-tile)
equal bit for bit in all 8 output channels to their plain versions run on
the card (the CPU's torch.exp rounds otherwise than the kernels' expf: up
to 9.5e-7 apart), on scene streams, crafted ones and an adversarial one
that tests their warp cull at its edges (tests/torch_port_util.py:
adversarial_stream). The backward blend is held to its plain version on
the card bit for bit, the plain version summing each instance's
per-pixel products in the kernels' order (sums="kernel": halves within
each warp, then the warps in order), and two launches bit-identical. The scans are held to
64 * 2^-24 * cumsum(|x|), a bound on f32 roundoff of sums of that depth.
One training step on the card is held to the same step on the CPU through
the plain versions. The table-gradient kernel scatter_add_sorted is held
to its plain version on the CPU bit for bit (both sum in the kernel's
fixed order: each run's pieces within tiles of TILE positions in stream
order, the pieces in tile order; the plain version's index_add_ is serial
there), per slot to 64 * 2^-24 * Σ|contributions| of index_add_ on the
card (the same roundoff bound; index_add_ sums with atomics in no fixed
order), with two launches bit-identical, on streams with a run of 800k
zeros, runs of 100k, runs of TILE - 1, TILE and TILE + 1 across tile
boundaries, one slot taking the whole stream and fewer positions than a
tile; a stage-2 step run twice from one state is bit-identical.
Interleave runs at n = 1, 3, 4, 70,000 and 70,001, stack at k = 1, 15
and 16 rows of n = 0, 1, 3, 4 and 200,003, on rows that are 16-byte
aligned and on rows that are not. The flat work-list, multi-tile and
sequential-tile blend kernels (GPT_BLEND_FLAT, GPT_BLEND_MT, GPT_BLEND_SMT
at 2, 4 and 7) are held to the classic kernels bit for bit (every bit of
the output, forward and backward, two launches identical) and to their
plain versions (bit for bit, both run on the card), on a random stream,
a skewed one (one tile's segment of 100,003 instances) and one with
empty tiles, the last among them. The Trainer runs 30 iterations of the `test` preset on the card
across the 0 -> 1 transition, and its checkpoint loads into a second
Trainer bit for bit. Motion extrapolation: one GCN training step on the
card is held to the same step on the CPU (loss to 1e-5 relative, each
gradient to 1e-3 of its leaf's largest magnitude, the biases of the graph
convolutions that feed a batch norm left out: their exact gradient is 0),
render_kpts on a stage-2 `test`-preset model to the CPU's frames within
2e-5 (render_set's tolerance), and LPIPS on the card to the committed
goldens of tests/test_eval.py::TestLPIPSGolden at rtol 2e-3. The classic
render path (render(fast_binning=False)) on the card equals the fast
path's render bit for bit and a step through it repeats bit for bit; the
forward and backward kernels equal their plain versions, and every
variant the classic kernels, on its CHUNK-aligned stream; a render and a
step under GPT_ELLIPSE_CULL=1 keep their bits; a batched step repeats bit
for bit and sums its members' gradients; evaluate_dirs runs on the card's
machine without imageio. The multi-GPU path on the one card: tile-band
renders stitch to the whole render bit for bit, an L1 loss backpropagated
band by band matches the whole frame's within the streams' cumsum
roundoff, the sharded step on a one-rank nccl mesh equals the single step
bit for bit, and two gloo ranks on cuda:0 (where gloo takes CUDA tensors)
match the single step within the JAX package's bounds. The multi step
(K = 3) equals three single steps bit for bit at stages 1 and 2, and makes
no host synchronisation under torch.cuda.set_sync_debug_mode("error").
Whether a card is present is decided inside the `cuda_device` fixture; without one
every test here skips.

This file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -m gpu
"""
import numpy as np
import pytest
import torch

from torch_port_util import (  # noqa: F401
    LPIPS_GOLDEN_ALEX, LPIPS_GOLDEN_VGG, adversarial_stream, crafted_stream,
    cuda_device, lpips_golden_weights,
)

from gaussianprediction_tpu_torch.data.synthetic import (
    orbit_camera, random_gaussians,
)
from gaussianprediction_tpu_torch.kernels import launch_counts
from gaussianprediction_tpu_torch.ops import blend_variants as TBV
from gaussianprediction_tpu_torch.ops import expand as TE
from gaussianprediction_tpu_torch.ops import hashgrid_kernels as THK
from gaussianprediction_tpu_torch.ops import rasterize_kernels as TR
from gaussianprediction_tpu_torch.ops import scan as TS

pytestmark = pytest.mark.gpu


def _bits(x):
    return x.contiguous().view(torch.int32)


def _gaussians(num, seed, dev, scale_range=(-5.0, -3.0), boost=0.0):
    g = random_gaussians(num, seed=seed, scale_range=scale_range)
    t = {k: torch.from_numpy(v).to(dev) for k, v in g.items()}
    op = torch.sigmoid(t["opacity_logit"][:, 0] + boost)
    rot = t["rotation"] / torch.linalg.norm(t["rotation"], dim=-1,
                                            keepdim=True)
    return t["xyz"], torch.exp(t["log_scales"]), rot, op, t["colors"]


@pytest.mark.parametrize("k", [1, 15, 16])
@pytest.mark.parametrize("n", [0, 1, 3, 4, 200_003])
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "misaligned"])
def test_stack_kernel_equals_plain(cuda_device, k, n, offset):
    """The 16-byte path and the scalar one (tails; rows that are views of
    one tensor at an offset of 1 float, so no row is 16-byte aligned)."""
    base = torch.randn(k * n + offset, device=cuda_device)
    chans = [base[offset + c * n:offset + (c + 1) * n] for c in range(k)]
    before = launch_counts["stack"]
    out = TE.stack_rows(chans, nch=16)
    torch.cuda.synchronize()
    assert launch_counts["stack"] == before + (n > 0)
    assert torch.equal(_bits(out), _bits(TE.stack_rows_plain(chans, 16)))


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


@pytest.mark.parametrize("n", [1, 3, 4, 70_001, 70_000])
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "misaligned"])
def test_interleave_kernel_equals_plain(cuda_device, n, offset):
    """The 16-byte path and the scalar one (tails; rows that are views of
    one tensor at an offset of 1 float, so no row is 16-byte aligned)."""
    base = torch.randn(11 * n + offset, device=cuda_device)
    base[offset + 10 * n::3] = -1.0            # some invalid gids
    chans = [base[offset + c * n:offset + (c + 1) * n] for c in range(11)]
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
    assert 0 < aux["warp_pairs_kept"] < aux["warp_pairs"]
    assert torch.equal(_bits(out), _bits(ref))


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


@pytest.mark.parametrize("case", ["sparse", "dense", "skewed", "empty"])
def test_blend_bwd_kernel_equals_plain(cuda_device, case):
    """On streams of a scene (few and many instances a pixel) and on the
    crafted ones of the variant tests (_variant_stream), the plain version
    run on the card."""
    if case in ("sparse", "dense"):
        s, g = _stream_on(cuda_device, 20_000, 4.0 if case == "dense" else 0.0)
        args = (s.inst, s.tile_start, s.tile_end, g, g)
    else:
        args = _variant_stream(case, cuda_device)
    out = TR.rasterize_binned(*args)
    cot = torch.randn(out.shape, device=cuda_device,
                      generator=torch.Generator(cuda_device).manual_seed(0))
    dpix = TR.pixel_grads(out, cot)
    before = launch_counts["blend_bwd"]
    a = TR.rasterize_binned_bwd(*args, dpix)
    b = TR.rasterize_binned_bwd(*args, dpix)
    torch.cuda.synchronize()
    assert launch_counts["blend_bwd"] == before + 2
    assert torch.equal(_bits(a), _bits(b))        # deterministic
    ref = TR.rasterize_binned_bwd_plain(*args, dpix, sums="kernel")
    assert float(ref[:10].abs().max()) > 0
    assert torch.equal(_bits(a), _bits(ref))


def _variant_stream(case, dev):
    """(inst, tile_start, tile_end, grid_x, grid_y) of a blend-variant
    case."""
    if case == "random":
        s, g = _stream_on(dev, 20_000, 0.0)
        return s.inst, s.tile_start, s.tile_end, g, g
    if case == "skewed":    # the last tile's segment: 100,003 instances
        counts, gx = [700, 250, 40, 100_003], 2
        arrs = crafted_stream(counts, gx, 5, sigma=(0.5, 1.5),
                              opacity=(0.1, 0.6))
    else:                   # empty tiles, the first and the last among them
        counts, gx = [0, 300, 0, 0, 700, 256, 1, 513, 0, 255, 257, 1000, 0,
                      40, 0], 5
        arrs = crafted_stream(counts, gx, 6)
    inst, ts, te = (torch.from_numpy(a).to(dev) for a in arrs)
    return inst, ts, te, gx, len(counts) // gx


VARIANTS = [TR.BlendVariant("flat"), TR.BlendVariant("mt", 1),
            TR.BlendVariant("mt", 3), TR.BlendVariant("mt", 4),
            TR.BlendVariant("mt", 8), TR.BlendVariant("smt", 2),
            TR.BlendVariant("smt", 4), TR.BlendVariant("smt", 7)]


@pytest.mark.parametrize("case", ["random", "skewed", "empty"])
def test_blend_variant_kernels_equal_classic(cuda_device, case):
    inst, ts, te, gx, gy = _variant_stream(case, cuda_device)
    ref = TR.rasterize_binned(inst, ts, te, gx, gy, True, TR.CLASSIC)
    cot = torch.randn(ref.shape, device=cuda_device,
                      generator=torch.Generator(cuda_device).manual_seed(0))
    dpix = TR.pixel_grads(ref, cot)
    dref = TR.rasterize_binned_bwd(inst, ts, te, gx, gy, dpix, TR.CLASSIC)
    assert float(dref[:10].abs().max()) > 0
    for v in VARIANTS:
        before = dict(launch_counts)
        outs = [TR.rasterize_binned(inst, ts, te, gx, gy, True, v)
                for _ in range(2)]
        douts = [TR.rasterize_binned_bwd(inst, ts, te, gx, gy, dpix, v)
                 for _ in range(2)]
        torch.cuda.synchronize()
        for k in (f"blend_fwd_{v.kind}", f"blend_bwd_{v.kind}"):
            assert launch_counts[k] == before.get(k, 0) + 2, (v, k)
        for a in outs:
            assert torch.equal(_bits(a), _bits(ref)), v
        for a in douts:
            assert torch.equal(_bits(a), _bits(dref)), v


@pytest.mark.parametrize("case", ["random", "skewed", "empty"])
@pytest.mark.parametrize("variant", [VARIANTS[i] for i in (0, 3, 5, 6, 7)],
                         ids=["flat", "mt4", "smt2", "smt4", "smt7"])
def test_blend_variant_kernels_equal_plain(cuda_device, case, variant):
    """Forward and backward bit for bit, the plain versions run on the
    card (on the CPU, torch.exp rounds otherwise than the kernels'
    expf)."""
    inst, ts, te, gx, gy = _variant_stream(case, cuda_device)
    out = TR.rasterize_binned(inst, ts, te, gx, gy, True, variant)
    cot = torch.randn(out.shape, device=cuda_device,
                      generator=torch.Generator(cuda_device).manual_seed(1))
    dpix = TR.pixel_grads(out, cot)
    dout = TR.rasterize_binned_bwd(inst, ts, te, gx, gy, dpix, variant)
    args = (inst, ts, te, gx, gy)
    if variant.kind == "flat":
        ref = TBV.rasterize_binned_flat_plain(*args, True)
        dref = TBV.rasterize_binned_bwd_flat_plain(*args, dpix,
                                                   sums="kernel")
    elif variant.kind == "smt":
        ref = TBV.rasterize_binned_smt_plain(*args, variant.tpb, True)
        dref = TBV.rasterize_binned_bwd_smt_plain(*args, variant.tpb, dpix,
                                                  sums="kernel")
    else:
        ref = TBV.rasterize_binned_mt_plain(*args, variant.tpb, True)
        dref = TBV.rasterize_binned_bwd_mt_plain(*args, variant.tpb, dpix,
                                                 sums="kernel")
    assert torch.equal(_bits(out), _bits(ref))
    assert float(dref[:10].abs().max()) > 0
    assert torch.equal(_bits(dout), _bits(dref))


def test_fwd_kernels_equal_plain_on_adversarial_stream(cuda_device):
    """Every forward kernel (classic and the eight variant geometries) on
    the stream that tests the warp cull at its edges (footprints ending
    within 1e-3 px of a warp edge, op one ulp either side of 1/255,
    degenerate conics, non-finite channels, invalid instances), bit for
    bit against the plain version run on the card, with and without tidx;
    each launch counted."""
    inst, ts, te, gx, gy = (torch.from_numpy(a).to(cuda_device)
                            if isinstance(a, np.ndarray) else a
                            for a in adversarial_stream(seed=3))
    for with_tidx in (True, False):
        aux = {}
        ref = TR.rasterize_binned_plain(inst, ts, te, gx, gy, with_tidx,
                                        aux=aux)
        assert 0 < aux["warp_pairs_kept"] < aux["warp_pairs"]
        assert (ref[..., TR.O_T] < 1e-3).any()        # latches fire
        for v in [TR.CLASSIC] + VARIANTS:
            before = dict(launch_counts)
            out = TR.rasterize_binned(inst, ts, te, gx, gy, with_tidx, v)
            torch.cuda.synchronize()
            k = "blend_fwd" if v.kind == "classic" else f"blend_fwd_{v.kind}"
            assert launch_counts[k] == before.get(k, 0) + 1, (v, k)
            assert torch.equal(_bits(out), _bits(ref)), (v, with_tidx)


def test_blend_variant_wrappers_reject_mixed_devices(cuda_device):
    ts = torch.zeros(1, dtype=torch.int32)
    inst = torch.zeros((16, 8), device=cuda_device)
    dpix = torch.zeros((1, 256, 8))
    with pytest.raises(ValueError):
        TBV.rasterize_binned_flat(inst, ts, ts, 1, 1)
    with pytest.raises(ValueError):
        TBV.rasterize_binned_bwd_flat(inst, ts, ts, 1, 1, dpix)
    with pytest.raises(ValueError):
        TBV.rasterize_binned_mt(inst, ts, ts, 1, 1, 4)
    with pytest.raises(ValueError):
        TBV.rasterize_binned_bwd_mt(inst, ts, ts, 1, 1, 4, dpix)
    with pytest.raises(ValueError):
        TBV.rasterize_binned_smt(inst, ts, ts, 1, 1, 4)
    with pytest.raises(ValueError):
        TBV.rasterize_binned_bwd_smt(inst, ts, ts, 1, 1, 4, dpix)


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
    C = THK.TILE
    zero_key = None
    if case == "random":
        n_slots = 1_000_003                      # not a multiple of 256
        keys = torch.randint(0, n_slots, (3_000_000,), generator=g)
    elif case == "skewed":
        n_slots = 50_001
        keys = torch.cat([torch.full((1_000_000,), 777),
                          torch.randint(0, n_slots, (200_000,), generator=g)])
    elif case == "empty":  # whole ranges of slots receive nothing
        n_slots = 300_007
        keys = torch.cat([torch.randint(0, 1000, (100_000,), generator=g),
                          torch.randint(250_000, 260_000, (100_000,),
                                        generator=g)])
    elif case == "dead_run":  # the Trainer's dead rows: one run of zeros
        n_slots, zero_key = 524_288, 300_000
        keys = torch.cat([torch.full((800_003,), zero_key),
                          torch.randint(0, n_slots, (800_000,), generator=g)])
    elif case == "runs_100k":
        n_slots = 1_000
        keys = torch.repeat_interleave(torch.arange(8) * 97 + 5, 100_000)
    elif case == "tile_edges":  # runs of C-1, C, C+1 across boundaries
        n_slots = 70_001
        lens = [C // 2, C - 1, 3, C, 5, C + 1, C - 1, 1, C + 1, 2 * C]
        keys = torch.cat(
            [torch.full((n,), 10 + 7 * r) for r, n in enumerate(lens)]
            + [torch.randint(200, n_slots, (5_000,), generator=g)])
    elif case == "one_slot":
        n_slots = 3
        keys = torch.full((1_000_001,), 1)
    else:  # "short": fewer positions than one tile
        n_slots = 5_000
        keys = torch.randint(0, n_slots, (C - 5,), generator=g)
    keys = torch.sort(keys.to(torch.int32)).values
    vals = torch.randn((4, keys.shape[0]), generator=g)
    if zero_key is not None:
        vals[:, keys == zero_key] = 0.0
    return keys.to(dev), vals.to(dev), n_slots


@pytest.mark.parametrize("case", [
    "random", "skewed", "empty", "dead_run", "runs_100k", "tile_edges",
    "one_slot", "short"])
def test_scatter_add_sorted_kernel_equals_plain(cuda_device, case):
    """Two launches bit-identical; bit for bit the CPU plain version (the
    kernel's order); within 64 * 2^-24 * Σ|v| of index_add_; slots that
    receive nothing exactly 0."""
    keys, vals, n_slots = _sorted_stream(case, cuda_device)
    before = launch_counts["scatter_add_sorted"]
    a = THK.scatter_add_sorted(keys, vals, n_slots)
    b = THK.scatter_add_sorted(keys, vals, n_slots)
    torch.cuda.synchronize()
    assert launch_counts["scatter_add_sorted"] == before + 2
    assert torch.equal(a, b)                      # deterministic
    ref = THK.scatter_add_sorted_plain(keys.cpu(), vals.cpu(), n_slots)
    assert torch.equal(a.cpu(), ref)
    lib = torch.zeros_like(a).index_add_(1, keys, vals)
    tol = 64 * 2.0 ** -24 * torch.zeros_like(a).index_add_(1, keys,
                                                            vals.abs())
    assert bool(((a - lib).abs() <= tol).all())
    hit = torch.zeros(n_slots, dtype=torch.bool, device=cuda_device)
    hit[keys.to(torch.int64)] = True
    assert not a[:, ~hit].any()


def _stage2_twice(dev, encoder):
    """A `test`-preset model with the given weight encoder through the
    stage-1 -> 2 transition, then one stage-2 step run twice from the same
    state: (the two outputs, kernel #7's launches in them)."""
    from gaussianprediction_tpu_torch.config import get_preset
    from gaussianprediction_tpu_torch.models.gaussians import create_from_pcd
    from gaussianprediction_tpu_torch.train import optimizer as O
    from gaussianprediction_tpu_torch.train.loop import stage_transition
    from gaussianprediction_tpu_torch.train.step import make_train_step

    cfg = get_preset("test")
    cfg.model.weight_encoder = encoder
    rng = np.random.default_rng(4)
    pts = rng.uniform(-1, 1, (400, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (400, 3)).astype(np.float32)
    state = create_from_pcd(cfg, pts, cols, torch.Generator().manual_seed(0),
                            device=dev)
    params = dict(state.params)
    params["motion_feature"] = 0.3 * torch.randn(
        params["motion_feature"].shape, device=dev,
        generator=torch.Generator(dev).manual_seed(1))
    state = state.replace(params=params)
    it = cfg.train.second_stage_iteration + 1
    state, opt = stage_transition(state, O.init_adam(state.params), cfg, it,
                                  torch.Generator(dev).manual_seed(2))
    step = make_train_step(cfg, 2, 64, 64, 1.0, 1, 50,
                           torch.zeros(3, device=dev))
    cam = orbit_camera(0.9, width=64, height=64).to_device_dict(dev)
    gt = torch.rand((64, 64, 3), device=dev,
                    generator=torch.Generator(dev).manual_seed(3))
    before = launch_counts["scatter_add_sorted"]
    outs = [step(state, opt, cam, gt, torch.tensor(0.3, device=dev), it,
                 torch.Generator(dev).manual_seed(5)) for _ in range(2)]
    return outs, launch_counts["scatter_add_sorted"] - before


def _assert_identical(outs):
    from gaussianprediction_tpu_torch.train import optimizer as O

    (s1, o1, m1), (s2, o2, m2) = outs
    assert int(m1["n_dropped"]) == 0 and torch.isfinite(m1["loss"])
    assert torch.equal(m1["loss"], m2["loss"])
    for a, b in zip(O.tree_leaves([s1.params, o1["m"], o1["v"]]),
                    O.tree_leaves([s2.params, o2["m"], o2["v"]])):
        assert torch.equal(a, b)


def test_stage2_step_on_card_is_deterministic(cuda_device):
    """A `test`-preset model through the stage-1 -> 2 transition, then one
    stage-2 step (kernel #7 and the keypoint blend's GEMM backward) run
    twice from the same state: loss, params and moments bit-identical."""
    outs, launches = _stage2_twice(cuda_device, "hashgrid")
    assert launches == 2
    _assert_identical(outs)


@pytest.mark.parametrize("encoder", ["fourier", "brick"])
def test_encoder_stage2_step_on_card_is_deterministic(cuda_device, encoder):
    """The same with the fourier encoder (no tables, no #7) and the brick
    encoder (#7 on the cell-granular stream)."""
    outs, launches = _stage2_twice(cuda_device, encoder)
    assert launches == (2 if encoder == "brick" else 0)
    assert ("hash_tables" in outs[0][0].params) == (encoder == "brick")
    _assert_identical(outs)


def test_brick_table_gradient_kernel_equals_plain(cuda_device):
    """#7 on the brick encoder's cell-granular stream (16 levels of F=4
    bricks, 2^16 rows a hashed level, 50k points): the sorted stream
    through the kernel bit for bit its plain version on the CPU, two
    launches bit-identical, within 64 * 2^-24 * Σ|v| of index_add_, empty
    slots 0; and the encoder's whole backward on the card run twice
    bit-identical. (Not bit for bit the CPU's: a division by a scalar is a
    multiplication by its reciprocal on the card, so a fraction may move
    by an ulp and a corner key at a cell's edge with it.)"""
    from gaussianprediction_tpu_torch.ops import hashgrid as HG

    g = torch.Generator().manual_seed(6)
    tables = HG.init_brickgrid(np.random.default_rng(6), 16, 4, 16, 16,
                               2048)
    specs, nb = HG.brick_specs(tables, 16, 2048)
    xyz = (torch.rand((50_000, 3), generator=g) * 2.0 - 1.0) * 1.2
    grad = torch.randn((50_000, 64), generator=g)
    keys, w = HG.brick_keys_weights(*HG._brick_geom(xyz.to(cuda_device),
                                                    specs, 1.6))
    L, n, _ = keys.shape
    total = nb * HG.BRICK_CELLS
    g_l = grad.to(cuda_device).reshape(n, L, 4).permute(2, 1, 0)
    vals = (w[None] * g_l[..., None]).reshape(4, L, n * 8)
    ks, perm = torch.sort(keys.reshape(L, n * 8), dim=1, stable=True)
    vs = torch.gather(vals, 2, perm[None].expand(4, L, n * 8))
    ks, vs = ks.reshape(-1).contiguous(), vs.reshape(4, -1).contiguous()
    a = THK.scatter_add_sorted(ks, vs, total)
    b = THK.scatter_add_sorted(ks, vs, total)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert torch.equal(a.cpu(), THK.scatter_add_sorted_plain(
        ks.cpu(), vs.cpu(), total))
    lib = torch.zeros_like(a).index_add_(1, ks, vs)
    tol = 64 * 2.0 ** -24 * torch.zeros_like(a).index_add_(1, ks, vs.abs())
    assert bool(((a - lib).abs() <= tol).all())
    hit = torch.zeros(total, dtype=torch.bool, device=cuda_device)
    hit[ks.to(torch.int64)] = True
    assert not a[:, ~hit].any() and int(hit.sum()) < total
    # the encoder's whole backward on the card, twice: bit-identical
    grads = []
    for _ in range(2):
        tt = {k: torch.as_tensor(v, device=cuda_device).requires_grad_(True)
              for k, v in tables.items()}
        out = HG.brickgrid_encode_fast(tt, xyz.to(cuda_device), 1.6, 16,
                                       2048)
        out.backward(grad.to(cuda_device))
        grads.append([tt[k].grad for k in tables])
    assert all(torch.equal(x, y) for x, y in zip(*grads))


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


def test_trainer_on_card_crosses_stage_1_and_round_trips(cuda_device,
                                                         tmp_path):
    """30 iterations of the Trainer on the `test` preset at 64x64 on the
    card (stage 0 -> 1 at 10), through the kernels; then its checkpoint
    loaded by a second Trainer bit for bit, the generator's state too."""
    from gaussianprediction_tpu_torch.config import get_preset
    from gaussianprediction_tpu_torch.data.scene import (
        Scene, synthetic_scene_info,
    )
    from gaussianprediction_tpu_torch.train import checkpoint as ckpt
    from gaussianprediction_tpu_torch.train import optimizer as O
    from gaussianprediction_tpu_torch.train.loop import Trainer

    cfg = get_preset("test")
    info = synthetic_scene_info(n_points=200, n_cams=6, n_test=1, width=64,
                                height=64, dynamic=True, device=cuda_device)
    tr = Trainer(cfg, Scene(info), device=cuda_device, quiet=True,
                 log_every=5)
    before = dict(launch_counts)
    hist = tr.run(iterations=30)
    torch.cuda.synchronize()
    for k in ("blend_fwd", "blend_bwd", "stack", "expand", "interleave"):
        assert launch_counts[k] > before.get(k, 0), k
    logged = [h for h in hist if "loss" in h]
    assert len(logged) == 6 and all(h["n_dropped"] == 0 for h in logged)
    assert all(np.isfinite(h["loss"]) for h in logged)
    assert sorted(tr._multi_steps) == [(0, 1), (1, 1)]
    path = str(tmp_path / "chkpnt30.npz")
    tr.save_checkpoint(path)
    tr2 = Trainer(get_preset("test"), Scene(info), seed=5,
                  device=cuda_device, quiet=True)
    tr2.load_checkpoint(path)
    assert tr2.iteration == 30
    assert torch.equal(tr.generator.get_state(), tr2.generator.get_state())
    for a, b in zip(O.tree_leaves(tr.state.params) + O.tree_leaves(
            tr.opt_state), O.tree_leaves(tr2.state.params) + O.tree_leaves(
            tr2.opt_state)):
        assert a.device.type == b.device.type == "cuda"
        assert torch.equal(_bits(a) if a.is_floating_point() else a,
                           _bits(b) if b.is_floating_point() else b)
    for k in ("alive", "kpt_alive") + ckpt.STATS:
        assert torch.equal(getattr(tr.state, k), getattr(tr2.state, k)), k


def test_gcn_train_step_on_card_matches_cpu(cuda_device):
    from gaussianprediction_tpu_torch.motion import gcn_train as GT

    cfg = GT.GCNConfig(linear_size=64, num_stage=2, norm_rotation=True)
    K, B = 20, 16
    rng = np.random.default_rng(6)
    xi, xg = (rng.normal(size=(B, f, K, 3)).astype(np.float32)
              for f in (10, 1))
    ri, rg = (rng.normal(size=(B, f, K, 4)).astype(np.float32)
              for f in (10, 1))
    out = {}
    for dev in (torch.device("cpu"), cuda_device):
        model = GT.init_gcn(cfg, K, seed=3, device=dev)
        loss, grads = GT.train_step(
            model, GT.init_adam(model), 0.01,
            *[torch.from_numpy(a).to(dev) for a in (xi, ri, xg, rg)], cfg)
        names = [n for n, _ in model.named_parameters()]
        out[dev.type] = (float(loss), [g.cpu() for g in grads])
    (lc, gc), (lg, gg) = out["cpu"], out["cuda"]
    assert lg == pytest.approx(lc, rel=1e-5)
    for name, a, b in zip(names, gg, gc):
        if name.split(".")[-2].startswith("gc") and name.endswith("bias"):
            continue
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-3 * scale, name


def test_render_kpts_on_card_matches_cpu(cuda_device):
    from gaussianprediction_tpu_torch.config import get_preset
    from gaussianprediction_tpu_torch.eval.render import render_kpts
    from gaussianprediction_tpu_torch.models.gaussians import create_from_pcd
    from gaussianprediction_tpu_torch.motion.dataset import (
        extract_trajectories,
    )
    from gaussianprediction_tpu_torch.train import optimizer as O
    from gaussianprediction_tpu_torch.train.loop import stage_transition

    cfg = get_preset("test")
    rng = np.random.default_rng(4)
    pts = rng.uniform(-1, 1, (400, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (400, 3)).astype(np.float32)
    cpu = torch.device("cpu")
    state = create_from_pcd(cfg, pts, cols, torch.Generator().manual_seed(0),
                            device=cpu)
    params = dict(state.params)
    params["motion_feature"] = 0.3 * torch.randn(
        params["motion_feature"].shape,
        generator=torch.Generator().manual_seed(1))
    it = cfg.train.second_stage_iteration + 1
    state, _ = stage_transition(state.replace(params=params),
                                O.init_adam(params), cfg, it,
                                torch.Generator().manual_seed(2))
    it += cfg.train.xyz_noise_iteration
    traj = extract_trajectories(state, cfg, [0.2, 0.5], [], it)
    views = [orbit_camera(0.5 + i, width=64, height=64, time=0.2 + 0.3 * i)
             for i in range(2)]
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    frames, stats = {}, {}
    for dev in (cpu, cuda_device):
        before = launch_counts["blend_fwd"]
        frames[dev.type] = render_kpts(
            state.to(dev), cfg, it, views, bg, traj.kpts_xyz_train,
            traj.kpts_r_train, stats=stats)
        if dev.type == "cuda":
            assert launch_counts["blend_fwd"] == before + 2
        assert stats["n_dropped"] == [0, 0]
    for a, b in zip(frames["cuda"], frames["cpu"]):
        assert float(np.abs(a - b).max()) <= 2e-5
    assert float(np.ptp(frames["cpu"][0])) > 0.05


def test_lpips_on_card_matches_goldens(cuda_device, tmp_path, monkeypatch):
    from gaussianprediction_tpu_torch.eval.lpips import try_load_lpips

    path = str(tmp_path / "lpips_det.npz")
    a, b = lpips_golden_weights(path)
    monkeypatch.setenv("GPT_LPIPS_WEIGHTS", path)
    fn = try_load_lpips(cuda_device)
    lv, la = fn(a, b)
    np.testing.assert_allclose(lv, LPIPS_GOLDEN_VGG, rtol=2e-3)
    np.testing.assert_allclose(la, LPIPS_GOLDEN_ALEX, rtol=2e-3)
    assert fn(a, a) == (0.0, 0.0)


def test_cli_train_then_eval_on_card(cuda_device, tmp_path, monkeypatch):
    """cli.train -> cli.eval on a 32x32 D-NeRF tree on disk, on the card
    (no GPT_FORCE_CPU): the state lives on the card, the forward and
    backward kernels launch, and results.json holds a finite PSNR."""
    import json
    import os

    from gaussianprediction_tpu_torch.cli import eval as CE
    from gaussianprediction_tpu_torch.cli import train as CT
    from gaussianprediction_tpu_torch.data.blender import (
        write_nerf_synthetic,
    )
    from gaussianprediction_tpu_torch.data.scene import synthetic_scene_info

    monkeypatch.delenv("GPT_FORCE_CPU", raising=False)
    info = synthetic_scene_info(n_points=80, n_cams=12, n_test=0, width=32,
                                height=32, dynamic=True, device=cuda_device)
    scene, model = str(tmp_path / "scene"), str(tmp_path / "model")
    write_nerf_synthetic(scene, info.train_cameras, info.points,
                         info.colors)
    before = dict(launch_counts)
    tr = CT.main(["-s", scene, "-m", model, "--preset", "test",
                  "--iterations", "40", "--max_time", "0.75",
                  "--test_iterations", "40"])
    torch.cuda.synchronize()
    assert tr.device.type == "cuda" and tr.iteration == 40
    for k in ("stack", "expand", "interleave", "blend_fwd", "blend_bwd"):
        assert launch_counts[k] > before.get(k, 0), k
    res = CE.main(["-m", model])
    with open(os.path.join(res["out_dir"], "results.json")) as f:
        psnr = json.load(f)["PSNR"]
    assert np.isfinite(psnr) and psnr > 5


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P"])
def test_native_png_decoder_equals_pil(cuda_device, tmp_path, mode):
    """On the card's machine: the port's native decoder builds and gives
    PIL's floats (byte / 255) bit for bit, where PIL is installed."""
    Image = pytest.importorskip("PIL.Image")
    from gaussianprediction_tpu_torch.data import native

    assert native.available(), native.build_error
    c = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4, "P": 1}[mode]
    arr = np.random.default_rng(2).integers(0, 256, (21, 17, c), np.uint8)
    img = Image.fromarray(arr[..., 0] if c == 1 else arr,
                          "L" if mode == "P" else mode)
    if mode == "P":
        img = img.convert("P")
    p = str(tmp_path / f"{mode}.png")
    img.save(p)
    for channels, conv in ((3, "RGB"), (4, "RGBA")):
        want = np.asarray(Image.open(p).convert(conv), np.float32) / 255.0
        np.testing.assert_array_equal(native.decode_png(p, channels), want)


# ------------------------------------------ the classic path, cull, batch


def _binning_model(dev, num=2000, W=128):
    """A stage-1 `dnerf` model of `num` Gaussians (SH 3, the d=4 w=256
    deform MLP) on `dev`, its config with room for the binning path's
    CHUNK-aligned segments, a camera, a target and a time."""
    from gaussianprediction_tpu_torch.config import get_preset
    from gaussianprediction_tpu_torch.convert import state_from_params
    from gaussianprediction_tpu_torch.models.gaussians import (
        deform_mlp_sizes,
    )
    from gaussianprediction_tpu_torch.ops.mlp import init_mlp
    from gaussianprediction_tpu_torch.train import optimizer as O
    from gaussianprediction_tpu_torch.utils.sh import rgb_to_sh

    cfg = get_preset("dnerf")
    cfg.model.capacity_multiplier = 24
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
    state = state_from_params(params, np.ones(num, bool), device=dev)
    cam = orbit_camera(0.9, width=W, height=W).to_device_dict(dev)
    gt = torch.from_numpy(rng.uniform(0, 1, (W, W, 3)).astype(
        np.float32)).to(dev)
    return cfg, state, O.init_adam(state.params), cam, gt, \
        torch.tensor(0.3, device=dev)


def _classic_binning(monkeypatch):
    """Route the port's render through the binning path
    (fast_binning=False) for the test: the steps call rasterize.render."""
    import functools

    from gaussianprediction_tpu_torch.ops import rasterize as TRZ

    monkeypatch.setattr(TRZ, "render", functools.partial(
        TRZ.render, fast_binning=False))


def _step_twice(dev, cfg, state, opt, cam, gt, t, batch=1):
    """One stage-1 step (batch 1) or batched step run twice from one
    state, each from a generator seeded 5."""
    from gaussianprediction_tpu_torch.train.step import (
        make_train_step, make_train_step_batched,
    )

    W = gt.shape[1]
    bg = torch.zeros(3, device=dev)
    if batch == 1:
        step = make_train_step(cfg, 1, W, W, 1.0, 3, 50, bg)
        return [step(state, opt, cam, gt, t, 2000,
                     torch.Generator(dev).manual_seed(5))
                for _ in range(2)]
    step = make_train_step_batched(cfg, 1, W, W, 1.0, 3, 50, bg, batch)
    return [step(state, opt, [cam] * batch, [gt] * batch, [t] * batch, 2000,
                 torch.Generator(dev).manual_seed(5)) for _ in range(2)]


def _stage2_model(dev):
    """A `test`-preset model through the stage-1 -> 2 transition:
    (cfg, state, opt_state, the transition's iteration)."""
    from gaussianprediction_tpu_torch.config import get_preset
    from gaussianprediction_tpu_torch.models.gaussians import create_from_pcd
    from gaussianprediction_tpu_torch.train import optimizer as O
    from gaussianprediction_tpu_torch.train.loop import stage_transition

    cfg = get_preset("test")
    rng = np.random.default_rng(4)
    pts = rng.uniform(-1, 1, (400, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (400, 3)).astype(np.float32)
    state = create_from_pcd(cfg, pts, cols, torch.Generator().manual_seed(0),
                            device=dev)
    params = dict(state.params)
    params["motion_feature"] = 0.3 * torch.randn(
        params["motion_feature"].shape, device=dev,
        generator=torch.Generator(dev).manual_seed(1))
    it = cfg.train.second_stage_iteration + 1
    state, opt = stage_transition(state.replace(params=params),
                                  O.init_adam(params), cfg, it,
                                  torch.Generator(dev).manual_seed(2))
    return cfg, state, opt, it


@pytest.mark.parametrize("stage", [1, 2])
def test_multi_step_on_card_equals_single_steps(cuda_device, stage):
    """make_train_step_multi (K = 3) against three single steps on the
    card, bit for bit (params, moments, statistics, the last metrics),
    then the multi call again under torch.cuda.set_sync_debug_mode
    ("error"): no host synchronisation inside it, and the same bits.
    Stage 1 from _binning_model's dnerf model across densify_until_iter,
    stage 2 from the `test`-preset model at the transition."""
    from gaussianprediction_tpu_torch.models.gaussians import STATS
    from gaussianprediction_tpu_torch.train import optimizer as O
    from gaussianprediction_tpu_torch.train.step import (
        make_train_step, make_train_step_multi,
    )

    dev, K = cuda_device, 3
    if stage == 1:
        cfg, state, opt, cam, gt, t = _binning_model(dev)
        it0, W, sh = cfg.opt.densify_until_iter - 1, 128, 3
    else:
        cfg, state, opt, it0 = _stage2_model(dev)
        W, sh = 64, 1
        cam = orbit_camera(0.9, width=W, height=W).to_device_dict(dev)
        gt = torch.rand((W, W, 3), device=dev,
                        generator=torch.Generator(dev).manual_seed(3))
        t = torch.tensor(0.3, device=dev)
    rows = state.params["xyz" if stage == 1 else "super_xyz"]
    g = torch.Generator(dev).manual_seed(6)
    noises = [torch.randn(rows.shape, generator=g, device=dev)
              for _ in range(K)]
    bg = torch.zeros(3, device=dev)
    single = make_train_step(cfg, stage, W, W, 1.0, sh, 50, bg)
    s, o = state, opt
    for i in range(K):
        s, o, m = single(s, o, cam, gt, t, it0 + i, noise=noises[i])
    multi = make_train_step_multi(cfg, stage, W, W, 1.0, sh, 50, bg, K)

    def call():
        return multi(state, opt, [cam] * K, [gt] * K, [t] * K, it0,
                     noises=noises)

    outs = [call()]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs.append(call())
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert int(m["n_dropped"]) == 0 and torch.isfinite(m["loss"])
    for s3, o3, m3 in outs:
        assert (s.kpt_alive is None) == (s3.kpt_alive is None)
        for a, b in zip(
                O.tree_leaves([s.params, o, m, s.alive]
                              + [getattr(s, k) for k in STATS]),
                O.tree_leaves([s3.params, o3, m3, s3.alive]
                              + [getattr(s3, k) for k in STATS])):
            assert torch.equal(a, b)
        if s.kpt_alive is not None:
            assert torch.equal(s.kpt_alive, s3.kpt_alive)


def test_binning_render_and_step_on_card(cuda_device, monkeypatch):
    """render(fast_binning=False) on the card: the fast path's render bit
    for bit, the forward kernel launched on the CHUNK-aligned stream; a
    stage-1 step through the binning path run twice from one state bit-
    identical, launching the backward kernel. (Its gradients are not the
    fast path's bit for bit here: the per-Gaussian reduction scans the
    same columns behind a zero prefix of another length, and the card's
    row-wise scan associates by position.)"""
    from gaussianprediction_tpu_torch.models.deform import deform_stage1
    from gaussianprediction_tpu_torch.models.gaussians import get_shs
    from gaussianprediction_tpu_torch.ops.rasterize import render

    cfg, state, opt, cam, gt, t = _binning_model(cuda_device)
    with torch.no_grad():
        d = deform_stage1(state.params, cfg, state, t, 20_000)
        args = (d.xyz, d.scaling, d.rotation, d.opacity,
                get_shs(state.params), cam, 128, 128,
                torch.zeros(3, device=cuda_device))
        fast = render(*args, capacity_multiplier=24)
        before = launch_counts["blend_fwd"]
        slow = render(*args, capacity_multiplier=24, fast_binning=False)
        torch.cuda.synchronize()
    assert launch_counts["blend_fwd"] == before + 1
    assert int(slow["n_dropped"]) == 0
    for k in ("render", "depth", "alpha"):
        assert torch.equal(_bits(fast[k]), _bits(slow[k])), k
    _classic_binning(monkeypatch)
    before = launch_counts["blend_bwd"]
    outs = _step_twice(cuda_device, cfg, state, opt, cam, gt, t)
    torch.cuda.synchronize()
    assert launch_counts["blend_bwd"] == before + 2
    _assert_identical(outs)


def test_blend_kernels_equal_plain_on_binning_stream(cuda_device):
    """The forward and backward kernels on a binning stream (segments
    CHUNK-aligned, not contiguous): equal bit for bit to their plain
    versions on the card (the backward's in the kernels' order), and every
    variant's kernels to the classic ones."""
    from gaussianprediction_tpu_torch.ops import binning as TB
    from gaussianprediction_tpu_torch.ops import projection as PJ
    from gaussianprediction_tpu_torch.ops.rasterize import binned_instances

    W, g = 256, 16
    xyz, scal, rot, op, col = _gaussians(20_000, 1, cuda_device)
    cam = orbit_camera(0.5, width=W, height=W).to_device_dict(cuda_device)
    proj = PJ.project_from_params(xyz, scal, rot, cam, W, W, opacity=op)
    feat = torch.cat([proj.mean2d, proj.conic, op[:, None], col,
                      proj.depth[:, None]], dim=-1)
    bins = TB.bin_gaussians(proj, W, W, 16 * 20_000, align=128)
    assert int(bins.n_dropped) == 0
    assert bool((bins.tile_end[:-1] < bins.tile_start[1:]).any())
    args = (binned_instances(feat, bins.gauss_id), bins.tile_start,
            bins.tile_end, g, g)
    out = TR.rasterize_binned(*args)
    assert torch.equal(_bits(out), _bits(TR.rasterize_binned_plain(*args)))
    dpix = TR.pixel_grads(out, torch.randn_like(out))
    d = TR.rasterize_binned_bwd(*args, dpix)
    assert torch.equal(_bits(d), _bits(TR.rasterize_binned_bwd(*args, dpix)))
    assert torch.equal(_bits(d), _bits(TR.rasterize_binned_bwd_plain(
        *args, dpix, sums="kernel")))
    for v in (TR.BlendVariant("flat"), TR.BlendVariant("mt", 4),
              TR.BlendVariant("smt", 4)):
        assert torch.equal(_bits(TR.rasterize_binned(*args, variant=v)),
                           _bits(out)), v
        assert torch.equal(_bits(TR.rasterize_binned_bwd(
            *args, dpix, variant=v)), _bits(d)), v


def test_ellipse_cull_on_card_keeps_the_bits(cuda_device, monkeypatch):
    """GPT_ELLIPSE_CULL=1 on the card: a render and a stage-1 step equal
    bit for bit to the same with the cull off, with fewer instances in the
    segments."""
    from gaussianprediction_tpu_torch.ops import instance_stream as IS

    cfg, state, opt, cam, gt, t = _binning_model(cuda_device)
    seen = []
    orig = IS.build_instances_fwd
    monkeypatch.setattr(IS, "build_instances_fwd", lambda *a, **k: (
        seen.append(orig(*a, **k)) or seen[-1]))
    outs = []
    for cull in ("0", "1"):
        monkeypatch.setenv("GPT_ELLIPSE_CULL", cull)
        outs.append(_step_twice(cuda_device, cfg, state, opt, cam, gt, t)[0])
    n_seg = [int((s[0].tile_end - s[0].tile_start).sum())
             for s in (seen[0], seen[-1])]
    assert 0 < n_seg[1] < n_seg[0]
    _assert_identical(outs)


def test_batched_step_on_card(cuda_device):
    """make_train_step_batched with 3 members on the card: run twice from
    one state bit-identical, and its gradients the members' single-render
    gradients summed in member order, bit for bit (the same draws from
    the same generator)."""
    from gaussianprediction_tpu_torch.train import optimizer as O
    from gaussianprediction_tpu_torch.train import step as S

    cfg, state, opt, cam, gt, t = _binning_model(cuda_device)
    before = launch_counts["blend_bwd"]
    outs = _step_twice(cuda_device, cfg, state, opt, cam, gt, t, batch=3)
    torch.cuda.synchronize()
    assert launch_counts["blend_bwd"] == before + 6
    _assert_identical(outs)
    loss_and_grads, _ = S._step_parts(cfg, 1, 128, 128, 1.0, 3,
                                      torch.zeros(3, device=cuda_device))
    gen = torch.Generator(cuda_device).manual_seed(5)
    total = None
    for j in range(3):
        tj = S.time_with_noise(cfg, t, gen, 50, S.time_noise_anneal(
            cfg, 2000 + j, 1).to(cuda_device))
        g = loss_and_grads(state, cam, gt, tj, 2000 + j, gen, None, None)[1]
        total = g if total is None else O.tree_map(torch.add, total, g)
    for a, b in zip(O.tree_leaves(outs[0][2]["grads"]),
                    O.tree_leaves(total)):
        assert torch.equal(a, b)


def test_evaluate_dirs_on_card(cuda_device, tmp_path):
    """eval/metrics.py:evaluate_dirs on the card's machine, which has no
    imageio: two directories of PNGs, results.json and the error maps."""
    import json
    import os

    from gaussianprediction_tpu_torch.data.image_io import write_png
    from gaussianprediction_tpu_torch.eval.metrics import evaluate_dirs

    rd, gd = tmp_path / "renders", tmp_path / "gt"
    rd.mkdir()
    gd.mkdir()
    rng = np.random.default_rng(4)
    for i in range(2):
        a = rng.integers(0, 256, (48, 40, 3), np.uint8)
        b = np.clip(a.astype(int) + rng.integers(-20, 20, a.shape), 0,
                    255).astype(np.uint8)
        write_png(str(rd / f"{i:05d}.png"), a)
        write_png(str(gd / f"{i:05d}.png"), b)
    res = evaluate_dirs(str(rd), str(gd), device=cuda_device)
    assert np.isfinite(res["mean"]["PSNR"]) and res["mean"]["PSNR"] > 10
    with open(tmp_path / "results.json") as f:
        assert json.load(f)["PSNR"] == res["mean"]["PSNR"]
    assert len(os.listdir(tmp_path / "deltas")) == 2


# ---- the multi-GPU path (parallel/) on the one card ----------------------
def _bands_of(height, n_tile):
    from gaussianprediction_tpu_torch.parallel.shard import band_geometry

    band, _ = band_geometry(height, n_tile)
    return [(k * band, band) for k in range(n_tile)]


def test_band_renders_stitch_on_card(cuda_device):
    """render(tile_band=...) on the card: 3 bands of 3 tile rows (the last
    reaching below the 128-pixel image) and 8 of one row stitch to the
    whole render bit for bit (no rect of the view is capped), nothing
    dropped, #1 launched once a band."""
    from gaussianprediction_tpu_torch.models.gaussians import get_shs
    from gaussianprediction_tpu_torch.ops.rasterize import render
    from gaussianprediction_tpu_torch.train.step import deform_for_stage

    cfg, state, _, cam, _, t = _binning_model(cuda_device)
    with torch.no_grad():
        d = deform_for_stage(state.params, cfg, state, t, 2000, None, 1)
        args = (d.xyz, d.scaling, d.rotation, d.opacity,
                get_shs(state.params), cam, 128, 128,
                torch.zeros(3, device=cuda_device))
        whole = render(*args, alive=state.alive, capacity_multiplier=24)
        proj = whole["proj"]
        assert int((proj.tiles_max - proj.tiles_min).clamp(min=0)
                   .prod(-1).max()) <= 1024
        for n_tile in (3, 8):
            before = launch_counts["blend_fwd"]
            parts = [render(*args, alive=state.alive, capacity_multiplier=24,
                            tile_band=b) for b in _bands_of(128, n_tile)]
            torch.cuda.synchronize()
            assert launch_counts["blend_fwd"] == before + n_tile
            assert all(int(p["n_dropped"]) == 0 for p in parts)
            for k in ("render", "depth", "alpha", "tidx"):
                got = torch.cat([p[k] for p in parts])[:128]
                assert torch.equal(got, whole[k]), (n_tile, k)


def test_band_backward_on_card(cuda_device, monkeypatch):
    """An L1 loss summed over 3 bands' renders, backpropagated band by
    band on the card, against the whole frame's: the per-Gaussian feature
    gradients within 64 * 2^-24 * the largest |cumsum| of the streams'
    sorted cotangents (the same terms, reduced per band, then summed);
    the backward kernel on a band stream equal to its plain version bit
    for bit (sums="kernel")."""
    from gaussianprediction_tpu_torch.models.gaussians import get_shs
    from gaussianprediction_tpu_torch.ops import instance_stream as IS
    from gaussianprediction_tpu_torch.ops.rasterize import render
    from gaussianprediction_tpu_torch.train.step import deform_for_stage

    cfg, state, _, cam, gt, t = _binning_model(cuda_device)
    seen = []
    orig_bwd = IS.build_instances_bwd

    def spy(gid_row, kept, d_inst, *a, **k):
        out = orig_bwd(gid_row, kept, d_inst, *a, **k)
        srt = d_inst[:10].index_select(1, torch.sort(
            gid_row.to(torch.int32), stable=True).indices)
        seen.append((out, float(torch.cumsum(srt, 1).abs().max())))
        return out

    monkeypatch.setattr(IS, "build_instances_bwd", spy)
    blend_in = []
    orig_blend = TR.rasterize_binned_bwd
    monkeypatch.setattr(TR, "rasterize_binned_bwd", lambda *a, **k: (
        blend_in.append(a) or orig_blend(*a, **k)))
    with torch.no_grad():
        d = deform_for_stage(state.params, cfg, state, t, 2000, None, 1)
    base = (d.xyz, d.scaling, d.rotation, d.opacity, get_shs(state.params))
    denom = 128 * 128 * 3.0
    for bands in ([None], _bands_of(128, 3)):
        leaves = [x.detach().clone().requires_grad_(True) for x in base]
        for b in bands:
            out = render(*leaves, cam, 128, 128,
                         torch.zeros(3, device=cuda_device),
                         alive=state.alive, capacity_multiplier=24,
                         tile_band=b)
            y0 = 0 if b is None else b[0] * 16
            rows = min(128, y0 + out["render"].shape[0]) - y0
            ((out["render"][:rows] - gt[y0:y0 + rows]).abs().sum()
             / denom).backward()
    whole = seen[0][0]
    banded = sum(o for o, _ in seen[1:])
    tol = 64 * 2.0 ** -24 * sum(m for _, m in seen)
    assert float((banded - whole).abs().max()) <= tol
    a = orig_blend(*blend_in[2])
    ref = TR.rasterize_binned_bwd_plain(*blend_in[2], sums="kernel")
    assert torch.equal(_bits(a), _bits(ref))


@pytest.fixture
def one_rank_group(cuda_device):
    """A one-rank nccl group through maybe_initialize_distributed
    (GPT_DIST=1, env://), destroyed after the test."""
    import os

    import torch.distributed as dist

    from gaussianprediction_tpu_torch.parallel import distributed as PD
    from torch_port_util import free_port

    env = {"GPT_DIST": "1", "RANK": "0", "WORLD_SIZE": "1",
           "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(free_port())}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        assert PD.maybe_initialize_distributed(verbose=False) is False
        assert dist.get_backend() == "nccl"
        yield dist
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def test_one_rank_nccl_step_equals_single_step(cuda_device, one_rank_group):
    """The sharded step on a 1 x 1 nccl mesh equals make_train_step on the
    same draws bit for bit: loss, gradients, parameters, moments and
    statistics."""
    from gaussianprediction_tpu_torch.parallel.mesh import make_mesh
    from gaussianprediction_tpu_torch.parallel.shard import (
        make_sharded_train_step,
    )
    from gaussianprediction_tpu_torch.train import optimizer as O
    from gaussianprediction_tpu_torch.train.step import make_train_step

    cfg, state, opt, cam, gt, t = _binning_model(cuda_device)
    bg = torch.zeros(3, device=cuda_device)
    g = torch.Generator(cuda_device).manual_seed(3)
    noise = torch.randn(state.params["xyz"].shape, generator=g,
                        device=cuda_device)
    tn = torch.randn((), generator=g, device=cuda_device)
    single = make_train_step(cfg, 1, 128, 128, 1.0, 3, 50, bg)
    step, _ = make_sharded_train_step(cfg, 1, 128, 128, 1.0, 3, 50, bg,
                                      make_mesh(1, 1), capacity_multiplier=24)
    s1, o1, m1 = single(state, opt, cam, gt, t, 2000, noise=noise,
                        time_noise=tn)
    s2, o2, m2 = step(state, opt, [cam], [gt], [t], 2000, noise=noise,
                      time_noises=[tn])
    assert torch.equal(m1["loss"], m2["loss"])
    for a, b in zip(O.tree_leaves([m1["grads"], s1.params, o1["m"],
                                   o1["v"]]),
                    O.tree_leaves([m2["grads"], s2.params, o2["m"],
                                   o2["v"]])):
        assert torch.equal(_bits(a), _bits(b))
    for k in ("xyz_gradient_accum", "denom", "max_radii2D"):
        assert torch.equal(getattr(s1, k), getattr(s2, k)), k


def test_two_gloo_ranks_on_card(cuda_device, tmp_path):
    """Two ranks on cuda:0 over gloo (nccl refuses two ranks on one card),
    where gloo's all-gather and all-reduces take CUDA tensors (the probe
    of parallel/distributed.py; else skipped): the sharded step on a 1 x 2
    mesh against make_train_step in this process, as the JAX package holds
    its sharded step to its single step (loss to 1e-4 relative, parameters
    and xyz_gradient_accum to 1e-5), both ranks' states bit-identical."""
    from gaussianprediction_tpu_torch.convert import flatten
    from gaussianprediction_tpu_torch.parallel.distributed import (
        probe_gloo_cuda,
    )
    from gaussianprediction_tpu_torch.train import optimizer as O
    from gaussianprediction_tpu_torch.train.step import make_train_step
    from torch_port_util import load_ranks, spawn

    ok, said = probe_gloo_cuda()
    if not ok:
        pytest.skip("gloo takes no CUDA tensors here:\n" + said[-500:])
    cfg, state, opt, cam, gt, t = _binning_model(torch.device("cpu"))
    # second moments > 0: Adam's first step from v = 0 is a ±lr sign step,
    # which roundoff flips on gradients near 0
    gen = torch.Generator().manual_seed(6)
    opt["v"] = O.tree_map(lambda x: (0.2 * (x.abs().mean() + 1e-3)) ** 2
                          * (0.5 + torch.rand(x.shape, generator=gen)),
                          state.params)
    opt["step"] = torch.tensor(4, dtype=torch.int32)
    arrays = {f"params/{k}": v for k, v in flatten(state.params).items()}
    arrays.update({f"opt/{k}": v for k, v in flatten(opt).items()})
    arrays["alive"] = state.alive.numpy()
    arrays["gts"] = gt.numpy()[None]
    np.savez(tmp_path / "inputs.npz", **arrays)
    case = dict(inputs=str(tmp_path / "inputs.npz"), n_data=1, n_tile=2,
                stage=1, iteration=2000, angles=[0.9], times=[0.3],
                bg=[0.0, 0.0, 0.0], extent=1.0, sh_degree=3, total_frame=50,
                capacity_multiplier=24.0, preset="dnerf",
                cfg={"train": {"xyz_noise_iteration": 1,
                               "time_noise_iteration": 1}})
    spawn({"job": "steps", "width": 128, "height": 128, "cases": [case],
           "device": "cuda", "backend": "gloo"}, tmp_path, 2, timeout=300,
          one_gpu=True)
    ranks = load_ranks(tmp_path, 2)
    cfg.train.xyz_noise_iteration = cfg.train.time_noise_iteration = 1
    dev = cuda_device
    state, opt = state.to(dev), O.tree_map(lambda x: x.to(dev), opt)
    s1, _, m1 = make_train_step(cfg, 1, 128, 128, 1.0, 3, 50,
                                torch.zeros(3, device=dev))(
        state, opt, orbit_camera(0.9, width=128, height=128)
        .to_device_dict(dev), gt.to(dev), t.to(dev), 2000)
    got = ranks[0]
    assert int(got["case0/n_dropped"]) == 0
    assert float(got["case0/loss"]) == pytest.approx(float(m1["loss"]),
                                                     rel=1e-4)
    for k, v in flatten(s1.params).items():
        np.testing.assert_allclose(got[f"case0/params/{k}"], v, rtol=0,
                                   atol=1e-5, err_msg=k)
    np.testing.assert_allclose(got["case0/xyz_gradient_accum"],
                               s1.xyz_gradient_accum.cpu().numpy(), rtol=0,
                               atol=1e-5)
    for k, v in got.items():
        assert np.array_equal(ranks[1][k], v, equal_nan=True), k
