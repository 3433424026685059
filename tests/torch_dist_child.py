"""Rank process of the spawned torch.distributed tests
(tests/test_torch_sharded.py). It imports only the port (the card's
machine has no JAX), joins the process group that its environment
describes (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT, LOCAL_RANK) through
parallel/distributed.py, runs the job of a JSON spec and writes
rank<r>.npz beside it:

  {"job": "steps", ...}    sharded steps from the inputs of an .npz (the
                           state, the Adam state, the targets), one case a
                           mesh; ranks [0, 1] of a 2 x 1 case also run
                           make_train_step_batched on rank 0;
  {"job": "trainer", ...}  a Trainer on a synthetic scene: single steps to
                           `first`, then sharded steps to `last`.

Run: python tests/torch_dist_child.py <spec.json>   (with that environment)
"""
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from gaussianprediction_tpu_torch import config as tcfg  # noqa: E402
from gaussianprediction_tpu_torch.convert import (  # noqa: E402
    flatten, opt_state_from_arrays, state_from_params, unflatten,
)
from gaussianprediction_tpu_torch.parallel.distributed import (  # noqa: E402
    maybe_initialize_distributed,
)

STATS = ("xyz_gradient_accum", "xyz_gradient_accum_max", "denom",
         "max_radii2D", "xyz_motion_accum_max", "motion_denom")


def preset(spec):
    cfg = tcfg.get_preset(spec.get("preset", "test"))
    for sect, items in spec.get("cfg", {}).items():
        for k, v in items.items():
            setattr(getattr(cfg, sect), k, v)
    return cfg


def under(arrays, prefix):
    return {k[len(prefix):]: v for k, v in arrays.items()
            if k.startswith(prefix)}


def state_dump(state, opt_state, prefix=""):
    out = {f"{prefix}params/{k}": v
           for k, v in flatten(state.params).items()}
    out.update({f"{prefix}opt/{k}": v
                for k, v in flatten(opt_state).items()})
    for k in STATS:
        out[f"{prefix}{k}"] = getattr(state, k).cpu().numpy()
    out[f"{prefix}alive"] = state.alive.cpu().numpy()
    if state.kpt_alive is not None:
        out[f"{prefix}kpt_alive"] = state.kpt_alive.cpu().numpy()
    return out


def job_steps(spec, dev):
    from gaussianprediction_tpu_torch.data.synthetic import orbit_camera
    from gaussianprediction_tpu_torch.parallel.mesh import make_mesh
    from gaussianprediction_tpu_torch.parallel.shard import (
        make_sharded_train_step,
    )
    from gaussianprediction_tpu_torch.train.step import (
        make_train_step_batched,
    )

    W, H = spec["width"], spec["height"]
    out = {}
    for i, case in enumerate(spec["cases"]):
        with np.load(case["inputs"]) as f:
            arrays = {k: f[k] for k in f.files}
        cfg = preset(case)
        mesh = make_mesh(case["n_data"], case["n_tile"], case.get("ranks"))
        if mesh is None:
            continue

        def start():
            state = state_from_params(
                unflatten(under(arrays, "params/")), arrays["alive"],
                arrays.get("kpt_alive"), device=dev,
                stats={k: arrays[k] for k in STATS if k in arrays})
            return state, opt_state_from_arrays(
                unflatten(under(arrays, "opt/")), device=dev)

        cams = [orbit_camera(a, width=W, height=H, time=tm).to_device_dict(
            dev) for a, tm in zip(case["angles"], case["times"])]
        gts = [torch.as_tensor(g, device=dev) for g in arrays["gts"]]
        times = [torch.tensor(tm, dtype=torch.float32, device=dev)
                 for tm in case["times"]]
        bg = torch.as_tensor(np.asarray(case["bg"], np.float32), device=dev)
        step, _ = make_sharded_train_step(
            cfg, case["stage"], W, H, case["extent"], case["sh_degree"],
            case["total_frame"], bg, mesh,
            capacity_multiplier=case["capacity_multiplier"])
        state, opt = start()
        s2, o2, m = step(state, opt, cams, gts, times, case["iteration"])
        pre = f"case{i}/"
        out.update(state_dump(s2, o2, pre))
        out.update({f"{pre}grads/{k}": v
                    for k, v in flatten(m["grads"]).items()})
        for k in ("loss", "l1", "psnr", "n_dropped"):
            out[pre + k] = m[k].cpu().numpy()
        if case.get("batched_ref") and mesh.rank == 0:
            # the same two cameras accumulated on one device, Adam at the
            # same iteration (members at iteration - 1 and iteration)
            bstep = make_train_step_batched(
                cfg, case["stage"], W, H, case["extent"],
                case["sh_degree"], case["total_frame"], bg, mesh.n_data)
            state, opt = start()
            s3, o3, m3 = bstep(state, opt, cams, gts, times,
                               case["iteration"] - mesh.n_data + 1)
            out.update(state_dump(s3, o3, pre + "batched/"))
            out.update({f"{pre}batched/grads/{k}": v
                        for k, v in flatten(m3["grads"]).items()})
            out[pre + "batched/loss"] = m3["loss"].cpu().numpy()
    return out


def job_trainer(spec, dev):
    from gaussianprediction_tpu_torch.data.scene import (
        Scene, synthetic_scene_info,
    )
    from gaussianprediction_tpu_torch.train.loop import Trainer

    out = {}
    for i, case in enumerate(spec["cases"]):
        cfg = preset(case)
        info = synthetic_scene_info(device=dev, **case["scene"])
        tr = Trainer(cfg, Scene(info, seed=case["scene_seed"]), device=dev,
                     quiet=True, log_every=1, n_devices=case["n_devices"],
                     n_data=case["n_data"])
        for it in range(1, case["first"]):
            tr.train_one(it)
        losses = [float(tr.train_one_sharded(it)["loss"])
                  for it in range(case["first"], case["last"] + 1)]
        pre = f"case{i}/"
        out[pre + "losses"] = np.asarray(losses)
        out[pre + "counts"] = np.asarray([int(tr.state.n_alive()),
                                          int(tr.state.n_kpts())])
        out.update(state_dump(tr.state, tr.opt_state, pre))
    return out


def main():
    with open(sys.argv[1]) as f:
        spec = json.load(f)
    torch.set_num_threads(1)
    dev = torch.device(spec.get("device", "cpu"))
    assert maybe_initialize_distributed(verbose=False, device=dev,
                                        backend=spec.get("backend"))
    import torch.distributed as dist

    out = {"job_steps": job_steps, "job_trainer": job_trainer}[
        "job_" + spec["job"]](spec, dev)
    rank = dist.get_rank()
    np.savez(os.path.join(os.path.dirname(sys.argv[1]),
                          f"rank{rank}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()
    print(f"RANK_OK {rank}", flush=True)


if __name__ == "__main__":
    main()
