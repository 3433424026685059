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
