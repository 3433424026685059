"""Parity of the port's stage-2 transition tools with the JAX package:
train/loop.py:distill_weight_init (for each weight encoder),
train/diag.py:transition_diagnostics, and the quality tool
(gaussianprediction_tpu_torch/tools/quality_proxy.py) against
tools/quality_proxy.py's recipe, plus its --cpu-tiny run in process.

A `test`-preset model of 16 blobs of points (capacity 512, 4 levels, d=2
w=32 deform MLP) is made by the JAX package's create_from_pcd with a
motion feature per blob, and its keypoints set by the JAX
set_super_keypoints; each encoder's weight model is the port's numpy draw,
its tables scaled so the encoder reaches the logits.

Tolerances, and why:
  - distill_weight_init, 5 steps: each step's loss within 1e-4 relative;
    each leaf of the weight model within max(1e-3, 4x the port's own f32
    error against f64) of its largest magnitude: Adam's eps 1e-15 turns
    the first steps into ±lr sign steps, so a gradient that is roundoff
    (or near 0) moves by a whole lr in either package (the rule the GCN
    tests hold its Adam to);
  - transition_diagnostics: each scalar within 1e-4 relative, n_kpts
    equal, the views' PSNRs within 1e-2 dB (render roundoff);
  - build_proxy_cfg: every field equal.
"""
import importlib.util
import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import n, one_torch_thread  # noqa: F401

from gaussianprediction_tpu import config as jcfg
from gaussianprediction_tpu.models import gaussians as jgauss
from gaussianprediction_tpu.train import diag as jdiag
from gaussianprediction_tpu.train import loop as jloop
from gaussianprediction_tpu.utils.camera import Camera as JCamera
from gaussianprediction_tpu_torch import config as tcfg
from gaussianprediction_tpu_torch.convert import state_from_params
from gaussianprediction_tpu_torch.data.scene import (
    Scene, synthetic_scene_info,
)
from gaussianprediction_tpu_torch.models.gaussians import weight_model
from gaussianprediction_tpu_torch.ops import hashgrid_kernels as HK
from gaussianprediction_tpu_torch.tools import quality_proxy as TQ
from gaussianprediction_tpu_torch.train import diag as tdiag
from gaussianprediction_tpu_torch.train import loop as tloop
from gaussianprediction_tpu_torch.train import optimizer as topt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_PTS = 400
STEPS = 5
STATS = ("xyz_gradient_accum", "xyz_gradient_accum_max", "denom",
         "max_radii2D", "xyz_motion_accum_max", "motion_denom")


def _cfgs(enc="hashgrid"):
    jc, tc = jcfg.get_preset("test"), tcfg.get_preset("test")
    for c in (jc, tc):
        c.model.weight_encoder = enc
        c.model.norm_rotation = True
    return jc, tc


@pytest.fixture(scope="module")
def base():
    """The JAX stage-1 model of 16 blobs with its keypoints, as numpy."""
    jc, _ = _cfgs()
    rng = np.random.default_rng(0)
    centers = rng.uniform(-0.8, 0.8, (16, 3))
    pts = (np.repeat(centers, N_PTS // 16, 0)
           + rng.normal(0, 0.03, (N_PTS, 3))).astype(np.float32)
    cols = rng.uniform(0, 1, (N_PTS, 3)).astype(np.float32)
    js = jax.jit(lambda k: jgauss.create_from_pcd(k, jc, pts, cols))(
        jax.random.PRNGKey(0))
    C = js.capacity
    feat = np.zeros((C, jc.model.feature_dim), np.float32)
    feat[:N_PTS] = (np.repeat(rng.normal(0, 0.3, (16, feat.shape[1])),
                              N_PTS // 16, 0)
                    + rng.normal(0, 0.01, (N_PTS, feat.shape[1])))
    params = dict(js.params, motion_feature=jnp.asarray(feat))
    js = jax.jit(lambda s, k: jloop.set_super_keypoints(s, jc, k))(
        js.replace(params=params), jax.random.PRNGKey(9))
    return jax.tree.map(np.asarray, js)


def _with_encoder(js, enc: str):
    """(JAX state, port state) of the model with `enc`'s weight model."""
    _, tc = _cfgs(enc)
    tables, wmlp = weight_model(tc, np.random.default_rng(4))
    params = {k: v for k, v in js.params.items() if k != "hash_tables"}
    params["weight_mlp"] = wmlp
    if tables is not None:
        params["hash_tables"] = {k: (v * 1e3).astype(np.float32)
                                 for k, v in tables.items()}
    stats = {k: getattr(js, k) for k in STATS}
    jstate = jgauss.GaussianState(
        params=jax.tree.map(jnp.asarray, params),
        alive=jnp.asarray(js.alive), kpt_alive=jnp.asarray(js.kpt_alive),
        **{k: jnp.asarray(v) for k, v in stats.items()})
    tstate = state_from_params(params, js.alive, js.kpt_alive,
                               device="cpu", stats=stats)
    return jstate, tstate


def _to64(state):
    p = topt.tree_map(lambda x: x.double() if x.is_floating_point() else x,
                      state.params)
    return state.replace(params=p)


@pytest.mark.parametrize("enc", ["hashgrid", "brick", "fourier"])
def test_distill_weight_init_matches_jax(base, enc, monkeypatch):
    jc, tc = _cfgs(enc)
    jstate, tstate = _with_encoder(base, enc)
    js2, jlosses = jax.jit(lambda s: jloop.distill_weight_init(
        s, jc, STEPS))(jstate)
    ts2, tlosses = tloop.distill_weight_init(tstate, tc, STEPS)
    assert tlosses.shape == (STEPS,) and tlosses.dtype == torch.float32
    np.testing.assert_allclose(n(tlosses), np.asarray(jlosses), rtol=1e-4)
    # the port in f64 (the table gradient's plain version takes any
    # dtype): the CPU's own f32 error
    monkeypatch.setattr(HK, "scatter_add_sorted",
                        HK.scatter_add_sorted_plain)
    t64, _ = tloop.distill_weight_init(_to64(tstate), tc, STEPS)
    names = ["weight_mlp"] + (["hash_tables"] if enc != "fourier" else [])
    assert sorted(k for k in ts2.params if k in ("weight_mlp",
                                                 "hash_tables")) == \
        sorted(names)
    for k in names:
        ours = topt.tree_leaves(ts2.params[k])
        ref = jax.tree.leaves(js2.params[k])
        f64 = topt.tree_leaves(t64.params[k])
        before = topt.tree_leaves(tstate.params[k])
        assert len(ours) == len(ref) == len(f64)
        for a, b, c, d in zip(ours, ref, f64, before):
            a, b, c = n(a), np.asarray(b), n(c)
            scale = np.abs(b).max()
            own = np.abs(a - c).max() / max(np.abs(c).max(), 1e-30)
            tol = max(1e-3, 4 * own) * scale
            assert np.abs(a - b).max() <= tol, (k, own)
            assert not np.array_equal(a, n(d))     # the leaf was trained
    # everything else is untouched
    for k in ts2.params:
        if k not in names:
            for a, b in zip(topt.tree_leaves(ts2.params[k]),
                            topt.tree_leaves(tstate.params[k])):
                assert torch.equal(a, b), k


def _jax_scene(info):
    """The port's scene's test views as the JAX package's Cameras."""
    def cam(c):
        return JCamera(uid=c.uid, R=c.R, T=c.T, fovx=c.fovx, fovy=c.fovy,
                       image=c.image, image_name=c.image_name,
                       width=c.width, height=c.height, time=c.time)

    return SimpleNamespace(test_cameras=[cam(c) for c in info.test_cameras])


def test_transition_diagnostics_matches_jax(base):
    jc, tc = _cfgs("hashgrid")
    jstate, tstate = _with_encoder(base, "hashgrid")
    info = synthetic_scene_info(n_points=80, n_cams=4, n_test=1, width=32,
                                height=32, dynamic=True, device="cpu")
    jtr = SimpleNamespace(cfg=jc, state=jstate, scene=_jax_scene(info),
                          width=32, height=32, bg=np.zeros(3, np.float32),
                          interpret=True)
    ref = jdiag.transition_diagnostics(jtr, n_times=3, n_views=1)
    tr = tloop.Trainer(tc, Scene(info), device="cpu", quiet=True)
    tr.state = tstate
    ours = tdiag.transition_diagnostics(tr, n_times=3, n_views=1)
    assert list(ours) == list(ref)
    for k, v in ref.items():
        if k == "n_kpts":
            assert ours[k] == v == 16
        elif k == "views":
            assert len(ours[k]) == len(v) == 1
            for a, b in zip(ours[k], v):
                assert a["time"] == b["time"]
                for m in ("psnr_stage1", "psnr_blend", "psnr_blend_noise"):
                    assert abs(a[m] - b[m]) <= 1e-2, m
        elif k == "per_time":
            for a, b in zip(ours[k], v):
                assert list(a) == list(b)
                for m in b:
                    assert a[m] == pytest.approx(b[m], rel=1e-4), m
        else:
            assert ours[k] == pytest.approx(v, rel=1e-4), k
    # the noisy blend differs from the noise-free one: the noise is drawn
    assert ours["err_blend_noise"] != ours["err_blend"]


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_quality_proxy", os.path.join(REPO, "tools", "quality_proxy.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("distill", [0, 500])
@pytest.mark.parametrize("arm", ["stage1", "hashgrid", "fourier", "brick"])
def test_build_proxy_cfg_matches_jax_tool(arm, distill):
    jt = _jax_tool()
    for S, n_pts, tiny in ((6000, 2000, False), (300, 200, True)):
        ours = TQ.build_proxy_cfg(arm, S, n_pts, cpu_tiny=tiny,
                                  distill_steps=distill)
        ref = jt.build_proxy_cfg(arm, S, n_pts, cpu_tiny=tiny,
                                 distill_steps=distill)
        assert json.loads(ours.to_json()) == json.loads(ref.to_json())
    assert (TQ.STAGE1_FLOOR, TQ.REL_MARGIN_DB, TQ.PSNR_ASPIRATIONAL) == \
        (jt.STAGE1_FLOOR, jt.REL_MARGIN_DB, jt.PSNR_ASPIRATIONAL)
    arms = {"stage1": {"test_psnr": 26.1}, arm + "+x": {"test_psnr": 25.4}}
    ref_arms = json.loads(json.dumps(arms))
    TQ.grade_arms(arms)
    jt.grade_arms(ref_arms)
    assert arms == ref_arms


def test_quality_tool_cpu_tiny(tmp_path, monkeypatch):
    monkeypatch.setenv("GPT_FORCE_CPU", "1")
    out = tmp_path / "q"
    res = TQ.main(["--cpu-tiny", "--out", str(out), "--arms", "hashgrid",
                   "--seeds", "2", "--distill", "3"])
    with open(out / "QUALITY.json") as f:
        q = json.load(f)
    assert q == json.loads(json.dumps(res))
    assert list(q) == ["protocol", "arms", "summary"]
    assert sorted(q["arms"]) == ["hashgrid", "hashgrid+distill",
                                 "hashgrid+seed1"]
    h = q["arms"]["hashgrid"]
    assert h["pre_transition"]["iter"] == 15
    assert (out / "hashgrid" / "chkpnt15.npz").exists()
    for e in q["arms"].values():
        assert np.isfinite(e["test_psnr"]) and e["n_kpts"] >= 50
        assert set(e["transition_diag"]) >= {"err_blend", "views",
                                             "per_time"}
        assert set(e["ms_per_iter"]) == {"2", "3"} or "0" in e["ms_per_iter"]
    assert q["arms"]["hashgrid+distill"]["distill_init_steps"] == 3
    s = q["summary"]
    assert s["card"] == "cpu" and s["n_seeds"] == 2
    assert s["stage1_bar_db"] == 25.574
