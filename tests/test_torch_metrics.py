"""Parity of the port's metric suite (utils/image.py ssim, ms_ssim, psnr,
dssim; eval/metrics.py; eval/lpips.py) with the JAX package.

The image metrics are held to JAX's at rtol 1e-5 on random and related
image pairs, ms_ssim at 192x192 and at the odd 181x190 (the trailing row
and column dropped before each pooling). evaluate_pairs gives JAX's keys
and values (MS-SSIM None under 176 px, the LPIPS-note without weights);
evaluate_dirs reads PNGs and writes results.json, per_view.json and the
error maps; results_table equals JAX's string. LPIPS runs on the seeded
full-size VGG16/Alex weights of tests/test_eval.py::TestLPIPSGolden (about
69 MB, made in tmp_path): the committed goldens at rtol 2e-3, the JAX
function at rtol 1e-4, identical inputs 0.0; without weights it is None.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import (  # noqa: F401
    LPIPS_GOLDEN_ALEX, LPIPS_GOLDEN_VGG, lpips_golden_weights,
    one_torch_thread,
)

from gaussianprediction_tpu.eval import lpips as JL
from gaussianprediction_tpu.eval import metrics as JM
from gaussianprediction_tpu.utils import image as JI
from gaussianprediction_tpu_torch.eval import lpips as TL
from gaussianprediction_tpu_torch.eval import metrics as TM
from gaussianprediction_tpu_torch.utils import image as TI


def _pair(h, w, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    # a blurred, shifted copy with noise: SSIM well inside (0, 1)
    b = np.clip(0.5 * a + 0.5 * np.roll(a, 3, axis=1)
                + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("shape", [(192, 192), (181, 190), (48, 64)],
                         ids=["192", "181x190", "48x64"])
def test_image_metrics_match_jax(shape):
    a, b = _pair(*shape, seed=shape[0])
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    for name in ("ssim", "psnr", "dssim", "l1_loss", "l2_loss"):
        ours = float(getattr(TI, name)(ta, tb))
        ref = float(getattr(JI, name)(ja, jb))
        assert ours == pytest.approx(ref, rel=1e-5), name
    if min(shape) >= 176:
        ours = float(TI.ms_ssim(ta, tb))
        ref = float(JI.ms_ssim(ja, jb))
        assert 0.0 < ref < 1.0
        assert ours == pytest.approx(ref, rel=1e-5)
        assert float(TI.ms_ssim(ta, ta)) == pytest.approx(1.0, abs=1e-5)


def test_evaluate_pairs_matches_jax(monkeypatch):
    monkeypatch.delenv("GPT_LPIPS_WEIGHTS", raising=False)
    big = [_pair(192, 200, s) for s in (1, 2)]
    small = [_pair(48, 48, s) for s in (3, 4)]
    for pairs in (big, small):
        renders, gts = [p[0] for p in pairs], [p[1] for p in pairs]
        ref = JM.evaluate_pairs(renders, gts)
        ours = TM.evaluate_pairs(renders, gts, device="cpu")
        assert ours["mean"].keys() == ref["mean"].keys()
        assert ours["mean"]["LPIPS-note"] == ref["mean"]["LPIPS-note"]
        assert ours["per_view"].keys() == ref["per_view"].keys()
        for m, per in ref["per_view"].items():
            assert ours["per_view"][m].keys() == per.keys()
            for name, v in per.items():
                if v is None:
                    assert ours["per_view"][m][name] is None, (m, name)
                else:
                    assert ours["per_view"][m][name] == pytest.approx(
                        v, rel=1e-5), (m, name)
        assert (ours["mean"]["MS-SSIM"] is None) == (pairs is small)
    no_lpips = TM.evaluate_pairs(renders, gts, compute_lpips=False,
                                 device="cpu")
    assert "LPIPS-note" not in no_lpips["mean"]


def test_evaluate_dirs_and_results_table(tmp_path, monkeypatch):
    import imageio.v2 as imageio

    monkeypatch.delenv("GPT_LPIPS_WEIGHTS", raising=False)
    tables = {}
    for pkg, fn in (("jax", JM.evaluate_dirs), ("torch", None)):
        root = tmp_path / pkg
        rd, gd = root / "renders", root / "gt"
        rd.mkdir(parents=True)
        gd.mkdir()
        for i in range(2):
            a, b = _pair(40, 36, 10 + i)
            imageio.imwrite(str(rd / f"{i:05d}.png"),
                            (a * 255).astype(np.uint8))
            imageio.imwrite(str(gd / f"{i:05d}.png"),
                            (b * 255).astype(np.uint8))
        imageio.imwrite(str(rd / "depth_00000.png"),
                        np.zeros((40, 36, 3), np.uint8))
        if fn is None:
            res = TM.evaluate_dirs(str(rd), str(gd), device="cpu")
        else:
            res = fn(str(rd), str(gd))
        tables[pkg] = res
        for f in ("results.json", "per_view.json"):
            assert os.path.exists(root / f)
        assert len(os.listdir(root / "deltas")) == 2
    ours, ref = tables["torch"], tables["jax"]
    assert ours["per_view"]["PSNR"].keys() == {"00000.png", "00001.png"}
    for m in ("PSNR", "SSIM", "D-SSIM"):
        assert ours["mean"][m] == pytest.approx(ref["mean"][m], rel=1e-5)
    with open(tmp_path / "torch" / "results.json") as f:
        assert json.load(f).keys() == ref["mean"].keys()
    dirs = {"a": str(tmp_path / "jax"), "b": str(tmp_path / "torch")}
    assert TM.results_table(dirs) == JM.results_table(dirs)


def test_error_maps_without_imageio(tmp_path, monkeypatch):
    """Where imageio is absent (the card's machine), write_error_maps writes
    the .png maps through data/image_io.write_png; they decode to the
    |render - gt| x 255 bytes the imageio path writes."""
    import sys

    from gaussianprediction_tpu_torch.data.image_io import load_image

    a, b = _pair(40, 36, 12)
    want = (np.clip(np.abs(a - b), 0.0, 1.0) * 255).astype(np.uint8)
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    TM.write_error_maps([a, a], [b, a], str(tmp_path / "deltas"))
    assert sorted(os.listdir(tmp_path / "deltas")) == ["00000.png",
                                                       "00001.png"]
    got = load_image(str(tmp_path / "deltas" / "00000.png"))
    np.testing.assert_array_equal(np.round(got * 255).astype(np.uint8),
                                  want)


@pytest.fixture(scope="module")
def lpips_weights(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("lpips") / "lpips_det.npz")
    a, b = lpips_golden_weights(path)
    return path, a, b


def test_lpips_matches_goldens_and_jax(lpips_weights, monkeypatch):
    path, a, b = lpips_weights
    monkeypatch.setenv("GPT_LPIPS_WEIGHTS", path)
    fn = TL.try_load_lpips("cpu")
    lv, la = fn(a, b)
    np.testing.assert_allclose(lv, LPIPS_GOLDEN_VGG, rtol=2e-3)
    np.testing.assert_allclose(la, LPIPS_GOLDEN_ALEX, rtol=2e-3)
    assert fn(a, a) == (0.0, 0.0)
    jv, ja = JL.try_load_lpips()(a, b)
    np.testing.assert_allclose(lv, jv, rtol=1e-4)
    np.testing.assert_allclose(la, ja, rtol=1e-4)
    # evaluate_pairs carries the values and drops the note
    res = TM.evaluate_pairs([a], [b], device="cpu")
    assert res["per_view"]["LPIPS-vgg"]["00000.png"] == lv
    assert res["mean"]["LPIPS-alex"] == la and "LPIPS-note" not in \
        res["mean"]


def test_lpips_without_weights_is_none(monkeypatch, tmp_path):
    monkeypatch.delenv("GPT_LPIPS_WEIGHTS", raising=False)
    assert TL.try_load_lpips("cpu") is None
    monkeypatch.setenv("GPT_LPIPS_WEIGHTS", str(tmp_path / "missing.npz"))
    assert TL.try_load_lpips("cpu") is None
