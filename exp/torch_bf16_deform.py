"""The port's quality protocol with the deform MLP's products at the
TPU's default matmul precision: a probe of why the port's protocol arms
sit above the JAX run of QUALITY_r05.json.

The JAX package's deform and weight MLPs (ops/hashgrid.py:mlp_apply) call
jnp.dot at default precision, which the TPU runs as one bf16 pass: both
operands rounded to bf16, the products summed in f32, in the forward and
in both products of the backward. This script makes the products of the
MLPs that models/deform.py applies (the deform MLP; from stage 2 on the
blend-weight MLP too, as in the JAX package) round their operands to
bf16, then runs gaussianprediction_tpu_torch/tools/quality_proxy.py with
the remaining arguments. --mode tpu (the default) rounds as the TPU does:
x and W in the forward, the output gradient and the saved operands in
both backward products, every sum and every result in f32. --mode casts
rounds x and W through autograd's casts, which also round the gradients
of x and W to bf16 after their f32 sums (more rounding than the TPU's).
The package itself is not changed: the patch lives in this process only.

Usage (on the card; the port's f32 run of the same arms is
QUALITY_torch.json):
  python exp/torch_bf16_deform.py [--mode tpu|casts] \\
      --out build/quality_bf16 --arms stage1 hashgrid
"""
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from gaussianprediction_tpu_torch.models import deform  # noqa: E402
from gaussianprediction_tpu_torch.tools import quality_proxy  # noqa: E402


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


class _TpuMatmul(torch.autograd.Function):
    """x @ w with bf16 operands and f32 sums, forward and backward."""

    @staticmethod
    def forward(ctx, x, w):
        xb, wb = _bf16(x), _bf16(w)
        ctx.save_for_backward(xb, wb)
        return xb @ wb

    @staticmethod
    def backward(ctx, g):
        xb, wb = ctx.saved_tensors
        gb = _bf16(g)
        return gb @ wb.T, xb.T @ gb


def _mlp(product):
    def mlp_apply(layers, x):
        """ops/mlp.py:mlp_apply with each product's operands in bf16."""
        for i, layer in enumerate(layers):
            x = product(x, layer["w"]) + layer["b"]
            if i < len(layers) - 1:
                x = torch.relu(x)
        return x
    return mlp_apply


PRODUCTS = {"tpu": _TpuMatmul.apply,
            "casts": lambda x, w: _bf16(x) @ _bf16(w)}


if __name__ == "__main__":
    argv = sys.argv[1:]
    mode = "tpu"
    if argv[:1] == ["--mode"]:
        mode, argv = argv[1], argv[2:]
    deform.mlp_apply = _mlp(PRODUCTS[mode])
    print(f"deform MLP products: operands rounded to bf16 (--mode {mode})",
          flush=True)
    quality_proxy.main(argv)
