"""Process-group bring-up: the twin of the JAX package's
parallel/distributed.py on torch.distributed.

One process drives one GPU. The group forms only when the environment
opts in, so a single-process run never waits on a rendezvous:

  GPT_DIST=1                opt in (the JAX package's switch), or the
                            environment torchrun sets: WORLD_SIZE > 1
                            with MASTER_ADDR
  MASTER_ADDR, MASTER_PORT  rank 0's address (JAX_COORDINATOR_ADDRESS)
  WORLD_SIZE                the number of processes (JAX_NUM_PROCESSES)
  RANK                      this process's rank (JAX_PROCESS_ID)
  LOCAL_RANK                this process's GPU on its host

The group initializes through env://, as torchrun expects:

  torchrun --standalone --nproc_per_node N \\
      -m gaussianprediction_tpu_torch.cli.train ... --n_devices N

Every CLI entry point that can train on several GPUs calls
maybe_initialize_distributed() before it touches a device.
"""
from __future__ import annotations

import os

import torch

LAUNCH = ("torchrun --standalone --nproc_per_node N -m "
          "gaussianprediction_tpu_torch.cli.train ... --n_devices N")


def opted_in() -> bool:
    """GPT_DIST=1, or torchrun's WORLD_SIZE > 1 with MASTER_ADDR."""
    return (os.environ.get("GPT_DIST", "0") == "1"
            or (int(os.environ.get("WORLD_SIZE", "1")) > 1
                and "MASTER_ADDR" in os.environ))


def rank_device(device=None) -> torch.device:
    """This rank's device: cuda:LOCAL_RANK for a CUDA `device` (None means
    CUDA), the CPU for the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return dev
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))


def maybe_initialize_distributed(verbose: bool = True, device=None,
                                 backend=None) -> bool:
    """Join the process group iff the environment opts in (the module
    docstring). `device` (None means CUDA) picks the backend: nccl for
    CUDA, gloo for the CPU; `backend` overrides it. Under nccl each rank
    binds cuda:LOCAL_RANK, and a rank without that card raises. Returns
    True if the run is multi-process after the call. A group that is
    already initialized is kept."""
    import torch.distributed as dist

    if not dist.is_initialized():
        if not opted_in():
            return False
        dev = rank_device(device)
        backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
        if dev.type == "cuda":
            if not torch.cuda.is_available() or \
                    dev.index >= torch.cuda.device_count():
                raise RuntimeError(
                    f"rank {os.environ.get('RANK')} needs {dev}, but this "
                    f"machine has {torch.cuda.device_count()} CUDA devices")
            torch.cuda.set_device(dev)
        elif backend == "nccl":
            raise RuntimeError("the nccl backend needs a CUDA device")
        dist.init_process_group(backend=backend, init_method="env://")
        if verbose:
            print(f"[distributed] rank {dist.get_rank()}/"
                  f"{dist.get_world_size()} ({dist.get_backend()}) on {dev}",
                  flush=True)
    return dist.get_world_size() > 1


_PROBE = r"""
import datetime, torch, torch.distributed as dist
dist.init_process_group("gloo", init_method="env://",
                        timeout=datetime.timedelta(seconds=60))
r, n = dist.get_rank(), dist.get_world_size()
x = torch.full((1000,), float(r + 1), device="cuda")
parts = [torch.empty_like(x) for _ in range(n)]
dist.all_gather(parts, x)
assert [float(p[0]) for p in parts] == [float(k + 1) for k in range(n)]
dist.all_reduce(x)
assert float(x[0]) == n * (n + 1) / 2
m = torch.tensor([r], dtype=torch.int32, device="cuda")
dist.all_reduce(m, op=dist.ReduceOp.MAX)
assert int(m) == n - 1
dist.barrier()
dist.destroy_process_group()
print("GLOO_CUDA_OK")
"""


def probe_gloo_cuda(world: int = 2, timeout: float = 120.0):
    """Whether gloo's all_gather, sum and max all-reduce take CUDA tensors:
    `world` local processes on cuda:0 try them. Returns (ok, what the
    ranks printed). The way to run several ranks on a machine with one
    GPU, where nccl refuses two ranks on one card."""
    import socket
    import subprocess
    import sys

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                   LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _PROBE], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, env=env))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        outs.append(f"a rank outlived the probe's {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    ok = len(outs) == world and all(p.returncode == 0 for p in procs) \
        and all("GLOO_CUDA_OK" in o for o in outs)
    return ok, "\n".join(outs)
