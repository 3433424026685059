"""Graph-convolutional motion-extrapolation network (GCN_xyzr).

Torch twin of gaussianprediction_tpu/models/gcn.py: `GraphConv` is a
learned-adjacency graph convolution `att @ (x @ W) + b` over keypoint-
channel nodes; `GCBlock` stacks two of them with batch norm, tanh and a
residual; `GCN` is the input projection, `num_stage` blocks and a 2-layer
MLP head (or a graph convolution under `no_mapping`); `GCNxyzr` runs one
GCN over the 3·K xyz nodes and one over the 4·K rotation nodes, the
rotation output L2-normalised over the channel axis.

Nodes are channel-major (`x.reshape(B, C·K, F)`), and `att` is indexed in
that order. Parameters keep the JAX package's names and layouts (`weight`
[in, out], the head's `w` [in, out]), so convert.py:gcn_from_arrays and
gcn_to_arrays move checkpoints between the two packages without a
transpose.

The batch norm is written out rather than taken from nn.BatchNorm1d: it
normalises the flattened [B, nodes·feat] with the biased variance and
updates the running variance with B / max(B - 1, 1), so that one window
(B = 1, which train_gcn reaches when there is a single window) trains as
in the JAX package, where nn.BatchNorm1d raises. Training mode is the
module's own (`model.train()` / `model.eval()`). Initialisation draws
U(±1/sqrt(out_f)) from a CPU torch.Generator, so one seed gives one model
on every device; dropout draws its masks from the generator passed to
forward, and at p = 0 (the recipes' default) draws nothing.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

BN_MOMENTUM = 0.1
BN_EPS = 1e-5


def _uniform(shape, stdv: float, generator: torch.Generator, device):
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return nn.Parameter(((2.0 * u - 1.0) * stdv).to(device))


class GraphConv(nn.Module):
    """att @ (x @ weight) + bias; x [B, nodes, in_f] -> [B, nodes, out_f]."""

    def __init__(self, in_f: int, out_f: int, node_n: int,
                 generator: torch.Generator, device=None):
        super().__init__()
        stdv = 1.0 / math.sqrt(out_f)
        self.weight = _uniform((in_f, out_f), stdv, generator, device)
        self.att = _uniform((node_n, node_n), stdv, generator, device)
        self.bias = _uniform((out_f,), stdv, generator, device)

    def forward(self, x):
        return torch.matmul(self.att, torch.matmul(x, self.weight)) \
            + self.bias


class BatchNorm(nn.Module):
    """Batch norm over the flattened [B, nodes·feat]: batch statistics and
    a running-statistics update in training, the running statistics in
    eval."""

    def __init__(self, n: int, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(n, device=device))
        self.bias = nn.Parameter(torch.zeros(n, device=device))
        self.register_buffer("mean", torch.zeros(n, device=device))
        self.register_buffer("var", torch.ones(n, device=device))

    def forward(self, x):
        B, n, f = x.shape
        flat = x.reshape(B, n * f)
        if self.training:
            mean = torch.mean(flat, dim=0)
            var = torch.var(flat, dim=0, unbiased=False)
            with torch.no_grad():
                self.mean.copy_((1 - BN_MOMENTUM) * self.mean
                                + BN_MOMENTUM * mean)
                self.var.copy_((1 - BN_MOMENTUM) * self.var
                               + BN_MOMENTUM * var * B / max(B - 1, 1))
        else:
            mean, var = self.mean, self.var
        out = (flat - mean) / torch.sqrt(var + BN_EPS) * self.scale \
            + self.bias
        return out.reshape(B, n, f)


class Dense(nn.Module):
    """x @ w + b with w [in_f, out_f] (the JAX package's head layout)."""

    def __init__(self, in_f: int, out_f: int, generator: torch.Generator,
                 device=None):
        super().__init__()
        lim = 1.0 / math.sqrt(in_f)
        self.w = _uniform((in_f, out_f), lim, generator, device)
        self.b = _uniform((out_f,), lim, generator, device)

    def forward(self, x):
        return torch.matmul(x, self.w) + self.b


def _dropout(x, p: float, training: bool,
             generator: Optional[torch.Generator]):
    """Inverted dropout; the identity at p == 0 or in eval (no draw)."""
    if not training or p <= 0.0:
        return x
    if generator is None:
        raise ValueError("dropout > 0 needs a generator")
    keep = 1.0 - p
    u = torch.rand(x.shape, generator=generator, device=generator.device)
    mask = u.to(x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


class GCBlock(nn.Module):
    def __init__(self, hidden_f: int, node_n: int,
                 generator: torch.Generator, device=None):
        super().__init__()
        self.gc1 = GraphConv(hidden_f, hidden_f, node_n, generator, device)
        self.gc2 = GraphConv(hidden_f, hidden_f, node_n, generator, device)
        self.bn1 = BatchNorm(node_n * hidden_f, device)
        self.bn2 = BatchNorm(node_n * hidden_f, device)

    def forward(self, y, p_dropout: float = 0.0, generator=None):
        z = _dropout(torch.tanh(self.bn1(self.gc1(y))), p_dropout,
                     self.training, generator)
        z = _dropout(torch.tanh(self.bn2(self.gc2(z))), p_dropout,
                     self.training, generator)
        return y + z


class GCN(nn.Module):
    """x [B, nodes, input_f] -> [B, nodes, output_f]. Dropout follows the
    input projection's tanh and each block's tanhs; none after the head."""

    def __init__(self, input_f: int, hidden_f: int, output_f: int,
                 num_stage: int, node_n: int, no_mapping: bool = False,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if generator is None:
            raise ValueError("GCN initialisation needs a torch.Generator")
        self.gc1 = GraphConv(input_f, hidden_f, node_n, generator, device)
        self.bn1 = BatchNorm(node_n * hidden_f, device)
        self.blocks = nn.ModuleList(
            GCBlock(hidden_f, node_n, generator, device)
            for _ in range(num_stage))
        if no_mapping:
            self.out_gc = GraphConv(hidden_f, output_f, node_n, generator,
                                    device)
        else:
            self.out_mlp = nn.ModuleList([
                Dense(hidden_f, hidden_f, generator, device),
                Dense(hidden_f, output_f, generator, device)])

    def forward(self, x, p_dropout: float = 0.0, generator=None):
        y = _dropout(torch.tanh(self.bn1(self.gc1(x))), p_dropout,
                     self.training, generator)
        for blk in self.blocks:
            y = blk(y, p_dropout, generator)
        if hasattr(self, "out_gc"):
            return self.out_gc(y)
        return self.out_mlp[1](torch.relu(self.out_mlp[0](y)))


class GCNxyzr(nn.Module):
    """One GCN over the 3·K xyz nodes and one over the 4·K rotation nodes:
    (x [B, 3, K, F_in], r [B, 4, K, F_in]) -> (x' [B, 3, K, F_out],
    r' normalised over the channel axis)."""

    def __init__(self, input_f: int, hidden_f: int, output_f: int,
                 num_stage: int, node_n: int, no_mapping: bool = False,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.xyz = GCN(input_f, hidden_f, output_f, num_stage, node_n * 3,
                       no_mapping, generator, device)
        self.rot = GCN(input_f, hidden_f, output_f, num_stage, node_n * 4,
                       no_mapping, generator, device)

    def forward(self, x, r, p_dropout: float = 0.0,
                generator: Optional[torch.Generator] = None):
        B, C, N, F = x.shape
        xo = self.xyz(x.reshape(B, C * N, F), p_dropout, generator)
        ro = self.rot(r.reshape(B, 4 * N, F), p_dropout, generator)
        xo = xo.reshape(B, C, N, -1)
        ro = ro.reshape(B, 4, N, -1)
        ro = ro / torch.clamp(torch.linalg.norm(ro, dim=1, keepdim=True),
                              min=1e-12)
        return xo, ro
