"""Keypoint trajectory extraction and the GCN's sliding-window dataset.

Torch twin of gaussianprediction_tpu/motion/dataset.py: evaluate the
trained stage-2/3 model's keypoint motion at every train and test
timestamp, recording each alive keypoint's position `super_xyz + Δxyz`
and rotation delta, then cut input_size -> output_size sliding windows
(the test split prepends the last input_size training frames).

The keypoint-noise anneal of stages 2/3 may still be running at the
checkpoint's iteration. The JAX package then hands every timestamp the
same PRNGKey(0), so every timestamp sees one and the same draw; the port
draws that N(0, 1) [Ck, 3] once, from a CPU generator seeded 0 (so the
card and the CPU see the same draw), and passes it to every timestamp.
Past the anneal the draw is scaled by 0.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from gaussianprediction_tpu_torch.config import Config
from gaussianprediction_tpu_torch.models import deform as D
from gaussianprediction_tpu_torch.models.gaussians import GaussianState


class Windows(NamedTuple):
    xyz_inputs: np.ndarray        # [W, input, K, 3]
    xyz_gt: np.ndarray            # [W, output, K, 3]
    rot_inputs: np.ndarray        # [W, input, K, 4]
    rot_gt: np.ndarray            # [W, output, K, 4]


class TrajectoryData(NamedTuple):
    kpts_xyz_train: np.ndarray    # [T_train, K, 3] keypoint positions
    kpts_r_train: np.ndarray      # [T_train, K, 4] rotation deltas
    kpts_xyz_test: np.ndarray
    kpts_r_test: np.ndarray
    train_times: List[float]
    test_times: List[float]
    n_kpts: int


@torch.no_grad()
def extract_trajectories(state: GaussianState, cfg: Config, train_times,
                         test_times, iteration: int,
                         noise: Optional[torch.Tensor] = None
                         ) -> TrajectoryData:
    """The keypoints' stage-2/3 motion (models/deform.py:keypoint_motion,
    the part of deform_stage23 they need) per timestamp on the state's
    device, keeping the alive keypoint prefix (keypoints are never pruned,
    so the alive slots form a prefix). `noise` ([Ck, 3], N(0, 1) before the
    anneal) is the draw every timestamp shares; by default it is drawn
    from a CPU generator seeded 0."""
    dev = state.device
    n_kpts = int(state.n_kpts())
    if noise is None:
        noise = torch.randn(state.params["super_xyz"].shape,
                            generator=torch.Generator().manual_seed(0))
    noise = noise.to(dev)

    def run(times):
        xs, rs = [], []
        for t in times:
            dxyz, dq, _ = D.keypoint_motion(
                state.params, cfg, state,
                torch.tensor(t, dtype=torch.float32, device=dev), iteration,
                noise=noise)
            xs.append((state.params["super_xyz"] + dxyz)[:n_kpts])
            rs.append(dq[:n_kpts])
        if not xs:
            return (np.zeros((0, n_kpts, 3), np.float32),
                    np.zeros((0, n_kpts, 4), np.float32))
        return (torch.stack(xs).cpu().numpy(),
                torch.stack(rs).cpu().numpy())

    xyz_tr, r_tr = run(train_times)
    xyz_te, r_te = run(test_times)
    return TrajectoryData(
        kpts_xyz_train=xyz_tr, kpts_r_train=r_tr,
        kpts_xyz_test=xyz_te, kpts_r_test=r_te,
        train_times=list(train_times), test_times=list(test_times),
        n_kpts=n_kpts,
    )


def build_windows(traj: TrajectoryData, input_size: int, output_size: int,
                  split: str) -> Windows:
    """Sliding windows: every start on the training frames (stride 1); on
    the test frames, after the last input_size training frames, a window
    every output_size frames."""
    if split == "train":
        xyz, rot = traj.kpts_xyz_train, traj.kpts_r_train
        n = len(xyz) - input_size - output_size
        idx_starts = range(max(n, 0))
    else:
        xyz = np.concatenate(
            [traj.kpts_xyz_train[-input_size:], traj.kpts_xyz_test], axis=0)
        rot = np.concatenate(
            [traj.kpts_r_train[-input_size:], traj.kpts_r_test], axis=0)
        idx_starts = range(0, len(traj.kpts_xyz_test), output_size)
    xi, xg, ri, rg = [], [], [], []
    for i in idx_starts:
        if i + input_size + output_size > len(xyz):
            break
        xi.append(xyz[i:i + input_size])
        xg.append(xyz[i + input_size:i + input_size + output_size])
        ri.append(rot[i:i + input_size])
        rg.append(rot[i + input_size:i + input_size + output_size])
    if not xi:
        K = traj.n_kpts
        return Windows(
            np.zeros((0, input_size, K, 3), np.float32),
            np.zeros((0, output_size, K, 3), np.float32),
            np.zeros((0, input_size, K, 4), np.float32),
            np.zeros((0, output_size, K, 4), np.float32),
        )
    return Windows(np.stack(xi), np.stack(xg), np.stack(ri), np.stack(rg))


def times_from_scene(scene_info, max_time: float):
    """Split the cameras' timestamps at max_time: (train, test), each
    sorted by time. Works for any loader that stamps Camera.time."""
    train_times, test_times = [], []
    all_cams = list(scene_info.train_cameras) + list(scene_info.test_cameras)
    for cam in sorted(all_cams, key=lambda c: c.time):
        (train_times if cam.time < max_time else test_times).append(
            float(cam.time))
    return train_times, test_times
