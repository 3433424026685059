"""Parity of the torch port's utility modules with the JAX package.

Same numpy inputs through both. Tolerances: pure selections, integer
outputs, copies and numpy code are held equal; f32 arithmetic is held to
1e-5 absolute (both evaluate the same formula in the same order, but
XLA's and PyTorch's sin/cos/exp/matmul differ in the last ulps), and the
deform MLP's output to 2e-5 (a 4-layer, 256-wide f32 stack). The last
test walks the port's sources and fails on any import of the JAX side.
"""
import ast
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import (  # noqa: F401
    jax_state, n, one_torch_thread, stage1_params, t,
)

from gaussianprediction_tpu import config as jcfg
from gaussianprediction_tpu.data import synthetic as jsyn
from gaussianprediction_tpu.models import deform as jdeform
from gaussianprediction_tpu.models import gaussians as jgauss
from gaussianprediction_tpu.ops import hashgrid as jhash
from gaussianprediction_tpu.ops import projection as jproj
from gaussianprediction_tpu.ops import knn as jknn
from gaussianprediction_tpu.train import optimizer as jopt
from gaussianprediction_tpu.utils import image as jimage
from gaussianprediction_tpu.utils import math as jmath
from gaussianprediction_tpu.utils import schedules as jsched
from gaussianprediction_tpu.utils import sh as jsh
from gaussianprediction_tpu_torch import config as tcfg
from gaussianprediction_tpu_torch.convert import state_from_params
from gaussianprediction_tpu_torch.data import synthetic as tsyn
from gaussianprediction_tpu_torch.device import resolve_device
from gaussianprediction_tpu_torch.models import deform as tdeform
from gaussianprediction_tpu_torch.models import gaussians as tgauss
from gaussianprediction_tpu_torch.ops import knn as tknn
from gaussianprediction_tpu_torch.ops import mlp as tmlp
from gaussianprediction_tpu_torch.ops import projection as tproj
from gaussianprediction_tpu_torch.train import optimizer as topt
from gaussianprediction_tpu_torch.utils import image as timage
from gaussianprediction_tpu_torch.utils import math as tmath
from gaussianprediction_tpu_torch.utils import schedules as tsched
from gaussianprediction_tpu_torch.utils import sh as tsh

RNG = np.random.default_rng(0)
ATOL = 1e-5

ROOT = pathlib.Path(__file__).resolve().parents[1]


def rnd(*shape, scale=1.0):
    return (RNG.normal(size=shape) * scale).astype(np.float32)


@pytest.mark.parametrize("name", ["quat_mul", "quat_to_rotmat",
                                  "covariance_from_scaling_rotation",
                                  "sharp_sigmoid", "step_opacity_fn"])
def test_math(name):
    q1, q2 = rnd(64, 4), rnd(64, 4)
    s = np.exp(rnd(64, 3, scale=0.5))
    u = RNG.uniform(0.05, 0.95, (64, 1)).astype(np.float32)
    args = {
        "quat_mul": (q1, q2),
        "quat_to_rotmat": (q1,),
        "covariance_from_scaling_rotation": (s, q1),
        "sharp_sigmoid": (q1, 0.1),
        "step_opacity_fn": (u, q1[:, :1], 0.1),
    }[name]
    j = getattr(jmath, name)(*[jnp.asarray(a) if isinstance(a, np.ndarray)
                               else a for a in args])
    p = getattr(tmath, name)(*[t(a) if isinstance(a, np.ndarray) else a
                               for a in args])
    np.testing.assert_allclose(n(p), n(j), atol=ATOL, rtol=1e-5)


@pytest.mark.parametrize("freqs", [6, 10])
def test_positional_encoding(freqs):
    x = rnd(50, 3)
    np.testing.assert_allclose(
        n(tmath.positional_encoding(t(x), freqs)),
        n(jmath.positional_encoding(jnp.asarray(x), freqs)), atol=ATOL)


def test_cov6_to_mat():
    c = rnd(20, 6)
    np.testing.assert_array_equal(n(tmath.cov6_to_mat(t(c))),
                                  n(jmath.cov6_to_mat(jnp.asarray(c))))


@pytest.mark.parametrize("step", [0, 1, 2500, 9999, 10_000, 20_000])
def test_linear_anneal(step):
    assert float(tsched.linear_anneal(step, 0.1, 10_000)) == \
        float(jsched.linear_anneal(step, 0.1, 10_000))


@pytest.mark.parametrize("group", ["xyz", "df_mlp", "s_xyz", "weight_mlp",
                                   "motion_feature", "f_rest", "rotation"])
def test_expon_lr_group_lr(group):
    # f32 exp/log/sin of XLA and PyTorch agree to a few ulps
    cfg_j, cfg_t = jcfg.get_preset("dnerf"), tcfg.get_preset("dnerf")
    for step in (-1, 0, 1, 777, 20_000, 40_000, 70_000):
        a = float(topt.group_lr(group, cfg_t, 1.7, step))
        b = float(jopt.group_lr(group, cfg_j, 1.7, jnp.int32(step)))
        assert a == pytest.approx(b, rel=2e-6, abs=0), (group, step)
    assert float(tsched.expon_lr(5, 0.0, 0.0)) == 0.0


@pytest.mark.parametrize("fn", ["l1_loss", "psnr", "ssim", "dssim",
                                "dssim_l1_loss"])
def test_image_losses(fn):
    # the SSIM blur is two f32 banded matmuls in both packages
    a = RNG.uniform(0, 1, (37, 45, 3)).astype(np.float32)
    b = np.clip(a + rnd(37, 45, 3, scale=0.1), 0, 1)
    ours = float(getattr(timage, fn)(t(a), t(b)))
    ref = float(getattr(jimage, fn)(jnp.asarray(a), jnp.asarray(b)))
    assert ours == pytest.approx(ref, rel=1e-5, abs=1e-6)


def test_mean_knn_sq_dist():
    # same formula, ||q||^2 + ||p||^2 - 2 q.p, whose cancellation makes
    # its f32 roundoff a few ulps of ||p||^2 (the dot products sum in
    # another order): atol 4 * 2^-24 * max ||p||^2
    p = rnd(700, 3)
    valid = RNG.random(700) > 0.2
    ours = n(tknn.mean_knn_sq_dist(t(p), 3, valid=t(valid), block=128))
    ref = n(jknn.mean_knn_sq_dist(jnp.asarray(p), 3,
                                  valid=jnp.asarray(valid), block=128))
    atol = 4 * 2.0 ** -24 * float((p * p).sum(-1).max())
    np.testing.assert_allclose(ours[valid], ref[valid], rtol=1e-5, atol=atol)
    assert np.isinf(ours[~valid]).all() and np.isinf(ref[~valid]).all()
    d, i = tknn.knn(t(p), t(p), 4, point_valid=t(valid))
    assert valid[n(i)].all()


@pytest.mark.parametrize("stage", [1, 2])
def test_adam_step(stage):
    # the same f32 update formula; sqrt/pow agree to an ulp
    cfg_j, cfg_t = jcfg.get_preset("dnerf"), tcfg.get_preset("dnerf")
    params = {"xyz": rnd(30, 3), "opacity": rnd(30, 1),
              "df_mlp": [{"w": rnd(4, 5), "b": rnd(5)}],
              "super_xyz": rnd(6, 3)}
    grads = {k: jax.tree.map(lambda x: rnd(*x.shape), v)
             for k, v in params.items()}
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init_adam(jp)
    tp = jax.tree.map(t, params)
    ts = topt.init_adam(tp)
    tg = jax.tree.map(t, grads)
    for it in (100, 101, 102):
        jp, js = jopt.adam_step(jp, jax.tree.map(jnp.asarray, grads), js,
                                cfg_j, stage, 1.3, jnp.int32(it))
        tp, ts = topt.adam_step(tp, tg, ts, cfg_t, stage, 1.3, it)
    assert int(ts["step"]) == int(js["step"]) == 3
    for tree_t, tree_j in ((tp, jp), (ts["m"], js["m"]), (ts["v"], js["v"])):
        for a, b in zip(topt.tree_leaves(tree_t), jax.tree.leaves(tree_j)):
            np.testing.assert_allclose(n(a), n(b), rtol=1e-6, atol=1e-7)
    moved = stage == 1
    assert topt.stage_start(cfg_t, stage) == jopt.stage_start(cfg_j, stage)
    assert (not np.array_equal(n(tp["xyz"]), params["xyz"])) == moved
    assert (not np.array_equal(n(tp["super_xyz"]), params["super_xyz"])) \
        == (not moved)


@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_sh_to_rgb_clamped(deg):
    sh = rnd(128, 3, 16, scale=0.5)
    d = rnd(128, 3)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    jr, jc = jsh.sh_to_rgb_clamped(deg, jnp.asarray(sh), jnp.asarray(d))
    tr, tc = tsh.sh_to_rgb_clamped(deg, t(sh), t(d))
    np.testing.assert_allclose(n(tr), n(jr), atol=ATOL)
    # the clamp mask may only differ where the value is within roundoff
    near = np.abs(n(jsh.eval_sh(deg, jnp.asarray(sh), jnp.asarray(d))) + 0.5)
    assert ((n(tc) == n(jc)) | (near < ATOL)).all()


@pytest.mark.parametrize("preset", ["dnerf", "test"])
def test_config_presets_equal(preset):
    assert dataclasses.asdict(tcfg.get_preset(preset)) == \
        dataclasses.asdict(jcfg.get_preset(preset))


def test_camera_and_synthetic_equal():
    jc = jsyn.orbit_camera(0.7, width=96, height=80, time=0.3, uid=2)
    tc = tsyn.orbit_camera(0.7, width=96, height=80, time=0.3, uid=2)
    jd = jc.to_device_dict()
    td = tc.to_device_dict("cpu")
    assert set(jd) == set(td)
    for k in jd:
        assert td[k].dtype == torch.float32
        np.testing.assert_array_equal(n(td[k]), np.asarray(jd[k], np.float32))
    jg = jsyn.random_gaussians(100, seed=3)
    tg = tsyn.random_gaussians(100, seed=3)
    for k in jg:
        np.testing.assert_array_equal(tg[k], jg[k])


def test_entry_points_need_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tsyn.orbit_camera(0.1).to_device_dict()
    assert resolve_device("cpu").type == "cpu"


def test_activations_and_shs():
    p = {"features_dc": rnd(30, 1, 3), "features_rest": rnd(30, 15, 3)}
    q = rnd(30, 4)
    np.testing.assert_array_equal(
        n(tgauss.get_shs({k: t(v) for k, v in p.items()})),
        n(jgauss.get_shs({k: jnp.asarray(v) for k, v in p.items()})))
    np.testing.assert_allclose(n(tgauss.rotation_act(t(q))),
                               n(jgauss.rotation_act(jnp.asarray(q))),
                               atol=1e-6)
    np.testing.assert_allclose(n(tgauss.scaling_act(t(q))),
                               n(jgauss.scaling_act(jnp.asarray(q))),
                               rtol=1e-6)
    np.testing.assert_allclose(n(tgauss.opacity_act(t(q))),
                               n(jgauss.opacity_act(jnp.asarray(q))),
                               atol=1e-6)
    cfg = tcfg.get_preset("dnerf")
    assert tgauss.deform_input_dims(cfg) == \
        jgauss.deform_input_dims(jcfg.get_preset("dnerf"))


def test_mlp_apply_and_init():
    sizes = [104, 256, 256, 7]
    layers = jhash.init_mlp(jax.random.PRNGKey(1), sizes)
    x = rnd(64, 104)
    tl = [{k: t(v) for k, v in layer.items()} for layer in layers]
    np.testing.assert_allclose(n(tmlp.mlp_apply(tl, t(x))),
                               n(jhash.mlp_apply(layers, jnp.asarray(x))),
                               atol=2e-5)
    ours = tmlp.init_mlp(np.random.default_rng(0), sizes)
    for layer, fan_in, fan_out in zip(ours, sizes[:-1], sizes[1:]):
        assert layer["w"].shape == (fan_in, fan_out)
        assert layer["w"].dtype == np.float32
        assert np.abs(layer["w"]).max() <= 1.0 / np.sqrt(fan_in)


@pytest.mark.parametrize("iteration,noise", [(20_000, False), (2_000, True)],
                         ids=["sigma0", "predrawn_noise"])
def test_deform_stage1_and_warmup(iteration, noise):
    jc = jcfg.get_preset("dnerf")
    tc = tcfg.get_preset("dnerf")
    params, alive = stage1_params(tc, 300, seed=4)
    js = jax_state(params, alive)
    ts = state_from_params(params, alive, device="cpu")
    eps = rnd(300, 3) if noise else None
    tt = 0.37
    jo = jdeform.deform_stage1(
        js.params, jc, js, jnp.float32(tt), jnp.int32(iteration),
        jax.random.PRNGKey(0),
        noise=None if eps is None else jnp.asarray(eps))
    to = tdeform.deform_stage1(
        ts.params, tc, ts, torch.tensor(tt), iteration, None,
        noise=None if eps is None else t(eps))
    for f in ("xyz", "rotation", "scaling", "opacity", "delta_xyz"):
        np.testing.assert_allclose(n(getattr(to, f)), n(getattr(jo, f)),
                                   atol=2e-5, err_msg=f)
    jw = jdeform.deform_warmup(js.params, jc)
    tw = tdeform.deform_warmup(ts.params, tc)
    for f in ("xyz", "rotation", "scaling", "opacity"):
        np.testing.assert_allclose(n(getattr(tw, f)), n(getattr(jw, f)),
                                   atol=1e-6, err_msg=f)


@pytest.mark.parametrize("tight", [True, False])
def test_projection(tight):
    from torch_port_util import scene

    g = scene(2000, seed=5)
    cam = jsyn.orbit_camera(0.4, width=128, height=112)
    jd = cam.to_device_dict()
    td = tsyn.orbit_camera(0.4, width=128, height=112).to_device_dict("cpu")
    q = g["rotation"] / np.linalg.norm(g["rotation"], axis=-1, keepdims=True)
    alive = np.ones(2000, bool)
    alive[::97] = False
    jp = jproj.project_from_params(
        jnp.asarray(g["xyz"]), jnp.asarray(g["scaling"]), jnp.asarray(q), jd,
        128, 112, alive=jnp.asarray(alive),
        opacity=jnp.asarray(g["opacity"]) if tight else None)
    tp = tproj.project_from_params(
        t(g["xyz"]), t(g["scaling"]), t(q), td, 128, 112, alive=t(alive),
        opacity=t(g["opacity"]) if tight else None)
    for f in ("radius", "tiles_min", "tiles_max", "visible"):
        np.testing.assert_array_equal(n(getattr(tp, f)), n(getattr(jp, f)),
                                      err_msg=f)
    np.testing.assert_allclose(n(tp.mean2d), n(jp.mean2d), atol=1e-4)
    np.testing.assert_allclose(n(tp.depth), n(jp.depth), atol=ATOL)
    np.testing.assert_allclose(n(tp.conic), n(jp.conic), rtol=1e-4,
                               atol=ATOL)


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_never_imports_jax():
    files = sorted((ROOT / "gaussianprediction_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    bad = []
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "flax", "gaussianprediction_tpu"):
                bad.append(f"{f.relative_to(ROOT)}: {mod}")
    assert not bad, bad
