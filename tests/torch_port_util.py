"""Helpers shared by the torch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages as
numpy arrays: JAX runs on the CPU (Pallas in interpret mode, as
tests/conftest.py sets up), the port on device="cpu".
"""
from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

CPU = torch.device("cpu")
CHILD = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "torch_dist_child.py")


@pytest.fixture
def cuda_device():
    """The card, for tests marked `gpu`; decided here, at run time, never
    at import (xdist workers must collect the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the card with `python -m "
                    "pytest --noconftest tests/test_torch_gpu.py -m gpu`")
    return torch.device("cuda")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run the importing module's torch CPU ops on one thread, restoring
    the count after it. The suite runs several workers on few cores and
    torch starts one thread per core in each: oversubscribed, its many
    small ops wait on each other many times longer than they compute.
    Autouse only in modules that import it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def t(x, device=CPU):
    """numpy/jax array -> torch tensor (copy)."""
    return torch.as_tensor(np.array(x), device=device)


def n(x):
    """torch tensor or jax array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def scene(num=2000, seed=0, scale_range=(-5.0, -3.0), opacity_boost=0.0):
    """Random Gaussians (activated scale and opacity) as numpy arrays."""
    from gaussianprediction_tpu.data.synthetic import random_gaussians

    g = random_gaussians(num, seed=seed, scale_range=scale_range)
    op = 1.0 / (1.0 + np.exp(-(g["opacity_logit"][:, 0] + opacity_boost)))
    return dict(
        xyz=g["xyz"], scaling=np.exp(g["log_scales"]).astype(np.float32),
        rotation=g["rotation"], opacity=op.astype(np.float32),
        colors=g["colors"],
    )


def stage1_params(cfg, num: int, seed: int):
    """A JAX-layout params dict (numpy) of a stage-0/1 model: random
    Gaussians, SH of cfg's degree and a numpy-initialised deform MLP."""
    from gaussianprediction_tpu.data.synthetic import random_gaussians
    from gaussianprediction_tpu_torch.models.gaussians import (
        deform_mlp_sizes,
    )
    from gaussianprediction_tpu_torch.ops.mlp import init_mlp
    from gaussianprediction_tpu_torch.utils.sh import rgb_to_sh

    g = random_gaussians(num, seed=seed, scale_range=(-5.0, -3.0))
    rng = np.random.default_rng(seed + 1)
    k_rest = (cfg.model.sh_degree + 1) ** 2 - 1
    params = {
        "xyz": g["xyz"],
        "features_dc": rgb_to_sh(g["colors"])[:, None, :],
        "features_rest": (0.1 * rng.normal(size=(num, k_rest, 3))).astype(
            np.float32),
        "scaling": g["log_scales"],
        "rotation": g["rotation"],
        "opacity": g["opacity_logit"],
        "motion_feature": (1e-3 * (2.0 * rng.random(
            (num, cfg.model.feature_dim)) - 1.0)).astype(np.float32),
        "df_mlp": init_mlp(rng, deform_mlp_sizes(cfg)),
    }
    alive = np.ones(num, bool)
    alive[-7:] = False          # a few dead capacity rows
    return params, alive


def jax_state(params, alive):
    """The JAX package's GaussianState around a numpy params dict."""
    import jax
    import jax.numpy as jnp

    from gaussianprediction_tpu.models.gaussians import GaussianState

    C = alive.shape[0]
    zeros = lambda dt=jnp.float32: jnp.zeros((C,), dt)  # noqa: E731
    return GaussianState(
        params=jax.tree.map(jnp.asarray, params),
        alive=jnp.asarray(alive),
        kpt_alive=jnp.zeros((4,), bool),
        xyz_gradient_accum=zeros(), xyz_gradient_accum_max=zeros(),
        denom=zeros(), max_radii2D=zeros(jnp.int32),
        xyz_motion_accum_max=zeros(), motion_denom=zeros(),
    )


def crafted_stream(counts, grid_x, seed, sigma=(0.5, 4.0),
                   opacity=(0.02, 0.9), far=0.0, tail=77):
    """A blend input made directly, without a scene: tile t's segment holds
    counts[t] instances (segments consecutive, tiles in order, `tail`
    unused slots after the last), each a random Gaussian footprint of
    scale `sigma` pixels and opacity `opacity` centred in or near its
    tile; a share `far` of them sits 1000 pixels away (read, never
    blended) and 5% are invalid. Returns (inst [16, P] float32,
    tile_start, tile_end [T] int32) as numpy arrays."""
    rng = np.random.default_rng(seed)
    counts = np.asarray(counts, np.int64)
    ends = np.cumsum(counts)
    n = int(ends[-1]) if counts.size else 0
    tile = np.repeat(np.arange(counts.size), counts)
    inst = np.zeros((16, n + tail), np.float32)
    pos = rng.uniform(-4.0, 20.0, (2, n))
    pos[:, rng.random(n) < far] += 1000.0
    inst[0, :n] = (tile % grid_x) * 16 + pos[0]
    inst[1, :n] = (tile // grid_x) * 16 + pos[1]
    s1, s2 = rng.uniform(*sigma, (2, n))
    th = rng.uniform(0.0, np.pi, n)
    c, s = np.cos(th), np.sin(th)
    # conic = the inverse of R diag(s1^2, s2^2) R^T
    i1, i2 = 1.0 / s1 ** 2, 1.0 / s2 ** 2
    inst[2, :n] = c * c * i1 + s * s * i2
    inst[3, :n] = c * s * (i1 - i2)
    inst[4, :n] = s * s * i1 + c * c * i2
    inst[5, :n] = rng.uniform(*opacity, n)
    inst[6:9, :n] = rng.uniform(0.0, 1.0, (3, n))
    inst[9, :n] = rng.uniform(1.0, 5.0, n)
    inst[10, :n] = rng.permutation(n)
    inst[11, :n] = rng.random(n) > 0.05
    return (inst, (ends - counts).astype(np.int32), ends.astype(np.int32))


def adversarial_stream(seed=0, grid_x=2, grid_y=2):
    """A blend input that tests the forward kernels' warp cull
    (ops/rasterize_kernels.py:warp_keep) at its edges: each tile's segment
    holds crafted_stream's random instances, then
    - thin and round rotated footprints whose support ellipse
      Q <= 2 ln(255 op) ends within 1e-3 px of a warp edge (columns 0, 7,
      8, 15 and rows 0, 3, 4, 7, 8, 11, 12, 15 of the tile, the edges of
      the warps' 8 x 4 patches, and rows 1 and 2 inside them),
      on either side, its extreme point in line with a pixel centre;
    - op one f32 ulp either side of (float)(1/255), and op 0.99 and 1.0,
      centred on a pixel;
    - conics with det = 0 and det < 0, huge ca and cc (1e30), NaN and inf
      in the channels the cull reads, invalid instances, and means 1000 px
      outside the tile.
    Colours stay finite, so no NaN reaches a blended output. Returns
    (inst [16, P] float32, tile_start, tile_end [T] int32, grid_x,
    grid_y), numpy arrays and ints."""
    rng = np.random.default_rng(seed)
    T = grid_x * grid_y
    a_min = float(np.float32(1.0 / 255.0))
    base, _, _ = crafted_stream([300] * T, grid_x, seed, tail=0)
    segs = []
    for t in range(T):
        ox, oy = (t % grid_x) * 16, (t // grid_x) * 16
        cols = [base[:, t * 300:(t + 1) * 300]]
        extra = []

        def add(mx, my, ca, cb, cc, op, valid=1.0):
            c = np.zeros(16, np.float64)
            c[:6] = mx, my, ca, cb, cc, op
            c[6:9] = rng.uniform(0.0, 1.0, 3)
            c[9] = rng.uniform(1.0, 5.0)
            c[11] = valid
            extra.append(c)

        for s1, s2 in ((12.0, 0.6), (4.0, 0.7), (1.0, 1.0)):
            for axis, edges in ((0, (0, 7, 8, 15)),
                                (1, (0, 1, 2, 3, 4, 7, 8, 11, 12, 15))):
                for e in edges:
                    for side in (1.0, -1.0):
                        for delta in (1e-3, 1e-4, 0.0, -1e-4, -1e-3):
                            th = rng.uniform(0.0, np.pi)
                            op = rng.choice([0.02, 0.5, 0.999])
                            c, s = np.cos(th), np.sin(th)
                            i1, i2 = 1.0 / s1 ** 2, 1.0 / s2 ** 2
                            ca = np.float32(c * c * i1 + s * s * i2)
                            cb = np.float32(c * s * (i1 - i2))
                            cc = np.float32(s * s * i1 + c * c * i2)
                            ca, cb, cc = float(ca), float(cb), float(cc)
                            det = ca * cc - cb * cb
                            R = np.sqrt(2.0 * np.log(op / a_min))
                            # the extreme point of the support along the
                            # axis, from the mean, and its other coordinate
                            if axis == 0:
                                ext = R * np.sqrt(cc / det)
                                other = -R * cb / np.sqrt(cc * det)
                            else:
                                ext = R * np.sqrt(ca / det)
                                other = -R * cb / np.sqrt(ca * det)
                            edge = (ox, oy)[axis] + e
                            across = (oy, ox)[axis] + rng.integers(0, 16)
                            m_ax = edge + side * (delta - ext)
                            m_other = across - side * other
                            mx, my = (m_ax, m_other) if axis == 0 else \
                                (m_other, m_ax)
                            add(mx, my, ca, cb, cc, op)
        px, py = ox + rng.integers(0, 16, 2)
        below = float(np.nextafter(np.float32(a_min), np.float32(0.0)))
        above = float(np.nextafter(np.float32(a_min), np.float32(1.0)))
        for op in (below, a_min, above, 0.99, 1.0):
            add(px, py, 0.3, 0.05, 0.4, op)
        add(px + 0.5, py, 1.0, 1.0, 1.0, 0.8)          # det = 0
        add(px, py + 0.5, 0.2, 1.0, 0.3, 0.8)          # det < 0
        add(px, py, 1e30, 0.0, 1e30, 0.8)
        add(px + 0.25, py, 1e30, 1e29, 1e30, 0.8)
        for k in range(6):
            ch = [px + 0.3, py, 0.5, 0.1, 0.5, 0.8]
            ch[k] = (np.nan, np.inf, -np.inf)[k % 3]
            add(*ch)
        add(px, py, 0.5, 0.0, 0.5, 0.8, valid=0.0)
        add(px, py, 0.5, 0.0, 0.5, 0.8, valid=np.nan)
        add(ox - 1000.0, oy + 8.0, 0.5, 0.0, 0.5, 0.9)
        add(ox + 8.0, oy + 1000.0, 0.01, 0.0, 0.01, 0.9)
        ex = np.stack(extra, axis=1).astype(np.float32)
        ex[10] = np.arange(ex.shape[1]) + 1000 * (t + 1)
        cols.append(ex)
        seg = np.concatenate(cols, axis=1)
        segs.append(seg[:, rng.permutation(seg.shape[1])])
    counts = np.array([s.shape[1] for s in segs])
    ends = np.cumsum(counts)
    inst = np.ascontiguousarray(np.concatenate(segs, axis=1))
    return (inst, (ends - counts).astype(np.int32), ends.astype(np.int32),
            grid_x, grid_y)


# the committed LPIPS goldens of tests/test_eval.py::TestLPIPSGolden
LPIPS_GOLDEN_VGG = 0.02952139638364315
LPIPS_GOLDEN_ALEX = 0.019956454634666443


def lpips_golden_weights(path):
    """Write the seeded full-size VGG16/Alex LPIPS weights of
    tests/test_eval.py::TestLPIPSGolden (default_rng(20260820), about
    69 MB) to `path`; returns its fixed input pair (a, b), [64, 80, 3]."""
    from gaussianprediction_tpu_torch.eval.lpips import (
        ALEX_CFG, VGG_CFG, VGG_TAPS,
    )

    rng = np.random.default_rng(20260820)
    params = {}
    cin = 3
    vgg_out = [c for c in VGG_CFG if c != "M"]
    for i, cout in enumerate(vgg_out):
        params[f"vgg/conv{i}/w"] = rng.normal(
            scale=0.05, size=(3, 3, cin, cout)).astype(np.float32)
        params[f"vgg/conv{i}/b"] = rng.normal(
            scale=0.05, size=(cout,)).astype(np.float32)
        cin = cout
    for k, c in enumerate([vgg_out[i] for i in VGG_TAPS]):
        params[f"vgg/lin{k}"] = np.abs(rng.normal(
            scale=0.1, size=(c,)).astype(np.float32))
    cin = 3
    for k_i, (cout, k, s, p) in enumerate(ALEX_CFG):
        params[f"alex/conv{k_i}/w"] = rng.normal(
            scale=0.05, size=(k, k, cin, cout)).astype(np.float32)
        params[f"alex/conv{k_i}/b"] = rng.normal(
            scale=0.05, size=(cout,)).astype(np.float32)
        cin = cout
    for k_i, (cout, *_r) in enumerate(ALEX_CFG):
        params[f"alex/lin{k_i}"] = np.abs(rng.normal(
            scale=0.1, size=(cout,)).astype(np.float32))
    np.savez(path, **params)
    a = (np.indices((64, 80)).sum(0)[..., None] % 17 / 16.0
         * np.array([1.0, 0.7, 0.4])).astype(np.float32)
    b = np.clip(a + 0.15 * np.sin(np.arange(64 * 80 * 3).reshape(64, 80, 3)
                                  * 0.37), 0, 1).astype(np.float32)
    return a, b


# ---- spawned torch.distributed ranks (tests/torch_dist_child.py) -------
def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def spawn(spec, folder, world: int, timeout: float = 240.0, argv=None,
          extra_env=None, one_gpu: bool = False):
    """Run `world` rank processes (tests/torch_dist_child.py on `spec`, or
    `argv`) and return what they printed; a child that fails or outlives
    `timeout` fails the test (every child is killed first). one_gpu: every
    rank's LOCAL_RANK is 0 (several ranks on one card)."""
    folder = str(folder)
    os.makedirs(folder, exist_ok=True)
    if argv is None:
        path = os.path.join(folder, "spec.json")
        with open(path, "w") as f:
            json.dump(spec, f)
        argv = [[sys.executable, CHILD, path]] * world
    port = free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ)
        env.pop("GPT_DIST", None)
        env.update({"RANK": str(rank),
                    "LOCAL_RANK": "0" if one_gpu else str(rank),
                    "WORLD_SIZE": str(world), "MASTER_ADDR": "127.0.0.1",
                    "MASTER_PORT": str(port), "OMP_NUM_THREADS": "1"})
        env.update(extra_env or {})
        procs.append(subprocess.Popen(
            argv[rank], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=env, cwd=folder))
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append((p.returncode, out))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"a rank outlived its {timeout} s timeout")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (rc, out) in enumerate(outs):
        assert rc == 0, f"rank {rank} failed:\n{out[-4000:]}"
    return [out for _, out in outs]


def load_ranks(folder, world: int):
    res = []
    for r in range(world):
        with np.load(os.path.join(str(folder), f"rank{r}.npz")) as f:
            res.append({k: f[k] for k in f.files})
    return res
