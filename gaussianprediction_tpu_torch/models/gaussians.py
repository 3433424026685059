"""Gaussian model state and activations.

Torch twin of gaussianprediction_tpu/models/gaussians.py. The state keeps
the JAX package's capacity padding: `params` holds [C, ...] tensors (and
the deform MLP as a list of {"w", "b"} layers) and `alive` marks the live
rows. Conventions are the reference's: scaling stored as log (exp
activation), opacity as logit (sigmoid), rotation unnormalized wxyz,
SH split into dc/rest. create_from_pcd needs KNN and waits for the
training port; convert.py builds states from arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from gaussianprediction_tpu_torch.config import Config


@dataclasses.dataclass
class GaussianState:
    params: Dict[str, Any]
    alive: torch.Tensor                      # [C] bool
    kpt_alive: Optional[torch.Tensor] = None  # [Ck] bool (stages 2/3)

    @property
    def capacity(self) -> int:
        return self.params["xyz"].shape[0]

    @property
    def device(self) -> torch.device:
        return self.params["xyz"].device


def scaling_act(s):
    return torch.exp(s)


def opacity_act(o):
    return torch.sigmoid(o)


def rotation_act(q):
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True),
                           min=1e-12)


def get_shs(params):
    """[C, 3, B] SH coefficients from the dc/rest split (coefficient axis
    last, as eval_sh takes them)."""
    feats = torch.cat([params["features_dc"], params["features_rest"]], dim=1)
    return feats.transpose(1, 2)


def deform_input_dims(cfg: Config):
    time_dim = 2 * cfg.opt.time_freq
    xyz_dim = 6 * cfg.opt.xyz_freq
    return time_dim, xyz_dim


def deform_mlp_sizes(cfg: Config):
    """Layer widths of the deform MLP: [time+xyz+feature] + [w]*d + [7|8]."""
    time_dim, xyz_dim = deform_input_dims(cfg)
    delta_dim = 8 if cfg.model.step_opacity else 7
    return ([time_dim + xyz_dim + cfg.model.feature_dim]
            + [cfg.model.w] * cfg.model.d + [delta_dim])
