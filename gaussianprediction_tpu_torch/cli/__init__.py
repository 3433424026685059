"""The port's command-line entry points, twins of the JAX package's
train.py, eval.py, train_gcn.py and show.py:

    python -m gaussianprediction_tpu_torch.cli.train -s <scene> -m <model>
    python -m gaussianprediction_tpu_torch.cli.eval -m <model>
    python -m gaussianprediction_tpu_torch.cli.train_gcn -m <model>
    python -m gaussianprediction_tpu_torch.cli.show -r <results root>

Each also runs in process as main(argv). They run on the card; the JAX
CLIs' switch GPT_FORCE_CPU=1, read once in main, runs them on the CPU.
Without it and without a card they raise.
"""
from __future__ import annotations

import os


def device_from_env():
    """The CLIs' device: the CPU under GPT_FORCE_CPU=1, else CUDA (which
    raises where there is no card)."""
    from gaussianprediction_tpu_torch.device import resolve_device

    return resolve_device(
        "cpu" if os.environ.get("GPT_FORCE_CPU", "0") == "1" else None)


def checkpoint_path(model_path: str, iteration=None) -> str:
    """<model_path>/chkpnt<iteration>.npz, the newest one when iteration
    is None."""
    if iteration is None:
        cks = [f for f in os.listdir(model_path)
               if f.startswith("chkpnt") and f.endswith(".npz")]
        if not cks:
            raise FileNotFoundError(f"no checkpoints in {model_path}")
        iteration = max(int(f[6:-4]) for f in cks)
    return os.path.join(model_path, f"chkpnt{iteration}.npz")
