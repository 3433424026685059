"""The port's tile bands, process group and mesh, in process: parity of
probe_slot_need(tile_band=...) and render(tile_band=...) with the JAX
package, the mesh layout against the JAX make_mesh, and the sharded step
(parallel/shard.py) at world size 1 on a one-rank `gloo` group (the
several-rank steps are tests/test_torch_sharded.py's).

- probe_slot_need over every band of a 64x64 view, for 1-4 bands over its
  4 tile rows (3 bands of 2 rows put the last one wholly below the image)
  and with a 3-tile cap (rects capped, then clipped, as the JAX package
  counts them): equal to the JAX count.
- render(tile_band=...) for every band of 3 and 4 bands, through the fast
  stream and the classic binning: within the render tests' f32 bounds of
  JAX's band (render and alpha 2e-5, depth 2e-4), n_dropped and
  n_instances equal, radii and visibility global (the whole view's).
  Within the port, the bands of 1-4 band splits stitch to the whole render
  bit for bit. That holds where no rect is capped, since a band caps its
  clamped rect (the JAX order), so the views here hold no rect over the
  1024-tile cap (asserted). A band wholly below the image renders the
  background with nothing dropped, and a Gaussian whose rect misses a band
  owns no instance there: its gradient from the band is exactly 0.
- maybe_initialize_distributed: no group without the environment; with
  GPT_DIST=1 a one-rank gloo group through env:// (the fixture); nccl
  without a card raises.
- make_mesh's rank layout equals the JAX mesh's device layout; a mesh
  larger than the group, and a Trainer whose n_devices is not the group's
  size or n_data's multiple, raise.
- The sharded step on a 1 x 1 mesh against make_train_step at stages 0, 1
  and 2: loss, gradients, statistics and parameters equal bit for bit (one
  band holds the frame, and the step takes the single step's loss). At
  stage 2 under densify_from_teaching it keeps no teacher statistics,
  as the JAX sharded step keeps none (ROADMAP.md, "Found in the
  reference"), where the single step updates them.
"""
import os
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import n, one_torch_thread, scene  # noqa: F401

from gaussianprediction_tpu.data.synthetic import orbit_camera
from gaussianprediction_tpu.ops.instance_stream import (
    probe_slot_need as jprobe,
)
from gaussianprediction_tpu.ops.rasterize import render as jrender
from gaussianprediction_tpu.parallel.mesh import make_mesh as jmake_mesh
from gaussianprediction_tpu_torch import config as tcfg
from gaussianprediction_tpu_torch.data.synthetic import (
    orbit_camera as torbit,
)
from gaussianprediction_tpu_torch.models.gaussians import create_from_pcd
from gaussianprediction_tpu_torch.ops.instance_stream import (
    probe_slot_need,
)
from gaussianprediction_tpu_torch.ops.rasterize import render
from gaussianprediction_tpu_torch.parallel import distributed as pdist
from gaussianprediction_tpu_torch.parallel.mesh import make_mesh, mesh_ranks
from gaussianprediction_tpu_torch.parallel.shard import (
    band_geometry, make_sharded_train_step,
)
from gaussianprediction_tpu_torch.train import optimizer as topt
from gaussianprediction_tpu_torch.train import step as tstep
from gaussianprediction_tpu_torch.train.loop import (
    Trainer, set_super_keypoints,
)

W = H = 64


@pytest.fixture(scope="module")
def gauss():
    """128 Gaussians (activated) and their SH of degree 1."""
    g = scene(128, seed=0, scale_range=(-3.2, -2.0))
    rng = np.random.default_rng(3)
    g["shs"] = (0.3 * rng.normal(size=(128, 3, 4))).astype(np.float32)
    return g


def _args(g, lib):
    keys = ("xyz", "scaling", "rotation", "opacity", "shs")
    if lib == "jax":
        return [jnp.asarray(g[k]) for k in keys]
    return [torch.tensor(g[k]) for k in keys]


def _bands(n_tile):
    band, _ = band_geometry(H, n_tile)
    return [(k * band, band) for k in range(n_tile)]


@pytest.mark.parametrize("max_tiles", [1024, 3])
@pytest.mark.parametrize("n_tile", [1, 2, 3, 4])
def test_probe_bands_match_jax(gauss, n_tile, max_tiles):
    cam = orbit_camera(0.4, width=W, height=H)
    tcam = torbit(0.4, width=W, height=H).to_device_dict("cpu")
    ja, ta = _args(gauss, "jax")[:4], _args(gauss, "torch")[:4]
    for band in _bands(n_tile):
        ref = int(jprobe(*ja, cam.to_device_dict(), W, H,
                         max_tiles=max_tiles, tile_band=band))
        got = int(probe_slot_need(*ta, tcam, W, H, max_tiles=max_tiles,
                                  tile_band=band))
        assert got == ref, band
    if n_tile == 3:        # the last band lies below the image: singletons
        assert got == 128


@pytest.fixture(scope="module")
def jax_bands(gauss):
    """JAX's band renders of 3 and 4 bands, fast and classic: one jit per
    band height and path."""
    cam = orbit_camera(0.4, width=W, height=H).to_device_dict()
    args = _args(gauss, "jax")
    out = {}
    for fast in (True, False):
        for n_tile in (3, 4):
            band = _bands(n_tile)[0][1]
            f = jax.jit(lambda ty0, fast=fast, band=band: jrender(
                *args, cam, W, H, jnp.zeros(3), sh_degree=1,
                interpret=True, tile_band=(ty0, band), fast_binning=fast,
                capacity_multiplier=24))
            out[fast, n_tile] = [
                jax.tree.map(np.asarray, {k: v for k, v in f(
                    jnp.int32(ty0)).items() if k != "proj"})
                for ty0, _ in _bands(n_tile)]
    return out


def _port_render(gauss, fast=True, band=None, requires_grad=False):
    tcam = torbit(0.4, width=W, height=H).to_device_dict("cpu")
    args = _args(gauss, "torch")
    if requires_grad:
        args[0].requires_grad_(True)
    out = render(*args, tcam, W, H, torch.zeros(3), sh_degree=1,
                 tile_band=band, fast_binning=fast, capacity_multiplier=24)
    return out, args


@pytest.mark.parametrize("fast", [True, False], ids=["fast", "classic"])
@pytest.mark.parametrize("n_tile", [3, 4])
def test_band_render_matches_jax(gauss, jax_bands, fast, n_tile):
    whole, _ = _port_render(gauss, fast)
    for ref, band in zip(jax_bands[fast, n_tile], _bands(n_tile)):
        got, _ = _port_render(gauss, fast, band)
        assert got["render"].shape == (band[1] * 16, W, 3)
        for k, tol in (("render", 2e-5), ("alpha", 2e-5), ("depth", 2e-4)):
            np.testing.assert_allclose(n(got[k]), ref[k], rtol=0, atol=tol,
                                       err_msg=f"{k} {band}")
        for k in ("n_dropped", "n_instances", "radii", "visibility_filter"):
            np.testing.assert_array_equal(n(got[k]), ref[k], err_msg=k)
        assert int(got["n_dropped"]) == 0
        # radii and visibility are the whole view's
        assert torch.equal(got["radii"], whole["radii"])
        assert torch.equal(got["visibility_filter"],
                           whole["visibility_filter"])


@pytest.mark.parametrize("fast", [True, False], ids=["fast", "classic"])
@pytest.mark.parametrize("n_tile", [1, 2, 3, 4])
def test_bands_stitch_bit_for_bit(gauss, fast, n_tile):
    whole, _ = _port_render(gauss, fast)
    proj = whole["proj"]
    # no rect capped: the bands' clamp-then-cap equals the whole view's
    area = (proj.tiles_max - proj.tiles_min).clamp(min=0).prod(-1)
    assert int(area.max()) <= 1024
    parts = [_port_render(gauss, fast, band)[0] for band in _bands(n_tile)]
    for k in ("render", "depth", "alpha", "tidx"):
        stitched = torch.cat([p[k] for p in parts])[:H]
        assert torch.equal(stitched, whole[k]), k


def test_band_below_the_image_and_its_gradients(gauss):
    band = _bands(3)[2]                    # rows 4-5 of a 4-row grid
    out, _ = _port_render(gauss, True, band)
    assert int(out["n_dropped"]) == 0
    assert torch.equal(out["render"], torch.zeros_like(out["render"]))
    assert float(out["alpha"].abs().max()) == 0.0
    # a Gaussian whose rect misses the band owns no instance there
    for band in _bands(4):
        out, args = _port_render(gauss, True, band, requires_grad=True)
        w = torch.rand(out["render"].shape,
                       generator=torch.Generator().manual_seed(band[0]))
        (out["render"] * w).sum().backward()
        proj = out["proj"]
        miss = (proj.tiles_max[:, 1] <= band[0]) | \
            (proj.tiles_min[:, 1] >= band[0] + band[1]) | ~proj.visible
        assert int(miss.sum()) > 0 and int((~miss).sum()) > 0
        assert float(args[0].grad[miss].abs().max()) == 0.0
        assert float(args[0].grad[~miss].abs().max()) > 0.0


@pytest.mark.parametrize("n_data,n_tile", [(1, 4), (2, 2), (4, 1), (2, 4)])
def test_mesh_layout_matches_jax(n_data, n_tile):
    jm = jmake_mesh(n_data=n_data, n_tile=n_tile,
                    devices=jax.devices("cpu")[:n_data * n_tile])
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    ids = ids - ids.min()
    tiles, datas = mesh_ranks(n_data, n_tile, range(n_data * n_tile))
    assert tiles == ids.tolist()
    assert datas == ids.T.tolist()
    assert dict(jm.shape) == {"data": n_data, "tile": n_tile}


def test_distributed_needs_the_environment(monkeypatch):
    for k in ("GPT_DIST", "WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(k, raising=False)
    assert not pdist.opted_in()
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert not pdist.opted_in()          # torchrun sets MASTER_ADDR too
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    assert pdist.opted_in()
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert pdist.rank_device("cpu") == torch.device("cpu")
    assert pdist.rank_device() == torch.device("cuda", 3)
    if not torch.cuda.is_available():
        monkeypatch.setattr(torch.distributed, "is_initialized",
                            lambda: False)
        with pytest.raises(RuntimeError, match="CUDA devices"):
            pdist.maybe_initialize_distributed(verbose=False)


@pytest.fixture(scope="module")
def group():
    """A one-rank gloo group, joined through maybe_initialize_distributed
    from GPT_DIST=1 and env:// variables; destroyed after the module."""
    import torch.distributed as dist

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    env = {"GPT_DIST": "1", "RANK": "0", "LOCAL_RANK": "0",
           "WORLD_SIZE": "1", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(port)}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        assert pdist.maybe_initialize_distributed(verbose=False,
                                                  device="cpu") is False
        assert dist.is_initialized() and dist.get_backend() == "gloo"
        yield dist
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def test_mesh_and_trainer_checks(group):
    mesh = make_mesh(1, 1)
    assert (mesh.n_data, mesh.n_tile, mesh.data_index, mesh.tile_index,
            mesh.rank) == (1, 1, 0, 0, 0)
    assert mesh.shape == {"data": 1, "tile": 1}
    with pytest.raises(ValueError, match="needs 2 ranks"):
        make_mesh(2, 1)
    from gaussianprediction_tpu_torch.data.scene import (
        Scene, synthetic_scene_info,
    )

    info = synthetic_scene_info(n_points=16, n_cams=2, n_test=0, width=16,
                                height=16, device="cpu")
    cfg = tcfg.get_preset("test")
    with pytest.raises(RuntimeError, match="torchrun --standalone"):
        Trainer(cfg, Scene(info), device="cpu", n_devices=2)
    with pytest.raises(ValueError, match="multiple of n_data"):
        Trainer(cfg, Scene(info), device="cpu", n_devices=4, n_data=3)


def _stage_state(cfg, stage):
    rng = np.random.default_rng(11)
    pts = rng.uniform(-0.6, 0.6, (200, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (200, 3)).astype(np.float32)
    gen = torch.Generator().manual_seed(4)
    st = create_from_pcd(cfg, pts, cols, generator=gen, device="cpu")
    p = dict(st.params)
    p["motion_feature"] = torch.tensor(rng.normal(
        0, 0.3, p["motion_feature"].shape).astype(np.float32))
    st = st.replace(params=p)
    if stage >= 2:
        st = set_super_keypoints(st, cfg, gen)
    return st


@pytest.mark.parametrize("stage,it", [(0, 5), (1, 30), (2, 90)])
def test_one_rank_step_matches_single_step(group, stage, it):
    cfg = tcfg.get_preset("test")
    cfg.train.use_time_decay = True
    cfg.train.densify_from_teaching = True
    mesh = make_mesh(1, 1)
    cam = torbit(0.7, width=W, height=H, time=0.4).to_device_dict("cpu")
    gt = torch.tensor(np.random.default_rng(2).uniform(
        0, 1, (H, W, 3)).astype(np.float32))
    bg = torch.tensor([0.1, 0.2, 0.3])
    gen = torch.Generator().manual_seed(9)
    base = _stage_state(cfg, stage)
    rows = base.params["xyz" if stage < 2 else "super_xyz"]
    noise = None if stage == 0 else torch.randn(rows.shape, generator=gen)
    tn = torch.randn((), generator=gen)
    single = tstep.make_train_step(cfg, stage, W, H, 1.3, 1, 20, bg)
    s1, _, m1 = single(base, topt.init_adam(base.params), cam, gt,
                       torch.tensor(0.4), it, noise=noise, time_noise=tn)
    base = _stage_state(cfg, stage)
    step, n_data = make_sharded_train_step(
        cfg, stage, W, H, 1.3, 1, 20, bg, mesh,
        capacity_multiplier=cfg.model.capacity_multiplier)
    assert n_data == 1
    s2, _, m2 = step(base, topt.init_adam(base.params), [cam], [gt],
                     [torch.tensor(0.4)], it, noise=noise, time_noises=[tn])
    assert int(m2["n_dropped"]) == 0
    assert torch.equal(m2["loss"], m1["loss"])
    for k in m1["grads"]:
        for a, b in zip(topt.tree_leaves(m2["grads"][k]),
                        topt.tree_leaves(m1["grads"][k])):
            assert torch.equal(a, b), k
    for k in ("denom", "max_radii2D", "xyz_gradient_accum",
              "xyz_gradient_accum_max"):
        assert torch.equal(getattr(s2, k), getattr(s1, k)), k
    for a, b in zip(topt.tree_leaves(s2.params), topt.tree_leaves(s1.params)):
        assert torch.equal(a, b)
    if stage == 2:
        # the single step grows the teacher statistics, the sharded one
        # keeps them (the JAX sharded step's divergence, copied)
        assert float(s1.motion_denom.max()) == 1.0
        assert float(s1.xyz_motion_accum_max.max()) > 0.0
        assert float(s2.motion_denom.abs().max()) == 0.0
        assert float(s2.xyz_motion_accum_max.abs().max()) == 0.0
