"""Helpers shared by the torch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages as
numpy arrays: JAX runs on the CPU (Pallas in interpret mode, as
tests/conftest.py sets up), the port on device="cpu".
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

CPU = torch.device("cpu")


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
