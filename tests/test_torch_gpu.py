"""Card-only tests of the port's CUDA kernels (marker `gpu`).

Each holds one kernel to its plain PyTorch version on the card, at the
plain version's own contract: stack, expand and interleave equal bit for
bit; the blend within 2e-5 on rgb and T and 2e-4 on depth, tidx equal where
the top weight beats the runner-up by more than 1e-6 relative (the same
tolerances as the CPU parity tests, though the two agree bit for bit on an
H100 in practice). Whether a card is present is decided inside the
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
from gaussianprediction_tpu_torch.ops import rasterize_kernels as TR

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
