"""Debug visualizations: feature PCA, blend weights, keypoint trajectories.

Torch-port copy of gaussianprediction_tpu/eval/visualize.py (numpy only),
the twins of the reference's utils/visualizer_utils.py:
- pca_vis            (:57-82)  — PCA-project per-Gaussian features to RGB
                                 and export a colored point cloud;
- feature_vis        (:44-55)  — 1-D feature colormap variant;
- weights_vis        (:95-104, draw_weights) — one keypoint's blend weight
                                 over all Gaussians as color;
- trajectory_vis     (:106-136, draw_trajectory) — keypoint trajectories
                                 over frames as a colored point cloud.

The reference depends on sklearn/trimesh/open3d and pops interactive
windows; here PCA is a plain SVD, and every artifact is written as a
binary PLY (utils/ply.store_point_cloud) viewable in any point-cloud
viewer. Inputs are numpy arrays (a tensor goes through .cpu().numpy()).
"""
from __future__ import annotations

import numpy as np

from gaussianprediction_tpu_torch.utils.ply import store_point_cloud


def _jet(x: np.ndarray) -> np.ndarray:
    """Minimal jet colormap on [0,1] -> RGB in [0,1] (matplotlib-free)."""
    x = np.clip(np.asarray(x, np.float64), 0.0, 1.0)
    r = np.clip(1.5 - np.abs(4.0 * x - 3.0), 0.0, 1.0)
    g = np.clip(1.5 - np.abs(4.0 * x - 2.0), 0.0, 1.0)
    b = np.clip(1.5 - np.abs(4.0 * x - 1.0), 0.0, 1.0)
    return np.stack([r, g, b], axis=-1).astype(np.float32)


def pca_features(features: np.ndarray, dim: int = 3):
    """PCA-project features to `dim` channels, normalized by the 1/99th
    percentiles (visualizer_utils.PCA_vis:58-76) via plain SVD."""
    f = np.asarray(features, np.float64)
    mean = f.mean(0)
    centered = f - mean
    # top-`dim` principal axes (rows of Vt)
    _, _, vt = np.linalg.svd(centered, full_matrices=False)
    proj = centered @ vt[:dim].T
    q1, q99 = np.percentile(proj, [1, 99])
    proj = (proj - q1) / max(q99 - q1, 1e-12)
    return np.clip(proj, 0.0, 1.0).astype(np.float32)


def pca_vis(xyz, features, output_path: str, dim: int = 3):
    """Colored point cloud of per-Gaussian features after PCA->RGB."""
    rgb = pca_features(features, dim=dim)
    if rgb.shape[1] < 3:
        rgb = np.repeat(rgb[:, :1], 3, axis=1)
    store_point_cloud(output_path, np.asarray(xyz, np.float32),
                      rgb[:, :3] * 255.0)
    return rgb


def feature_vis(xyz, features, output_path: str):
    """1-D PCA + jet colormap (visualizer_utils.feature_vis:44-55)."""
    c1 = pca_features(features, dim=1)[:, 0]
    store_point_cloud(output_path, np.asarray(xyz, np.float32),
                      _jet(c1) * 255.0)


def weights_vis(xyz, weights_xyz, nn_idx, kpt_index: int, output_path: str):
    """Color every Gaussian by its blend weight toward keypoint
    `kpt_index` (draw_weights twin; the repo's KNN-sparse weights are
    densified for the single queried column)."""
    xyz = np.asarray(xyz, np.float32)
    w = np.zeros(xyz.shape[0], np.float32)
    hit = np.asarray(nn_idx) == kpt_index              # [N, K]
    w = np.where(hit.any(1), (np.asarray(weights_xyz) * hit).sum(1), 0.0)
    store_point_cloud(output_path, xyz,
                      _jet(w / max(w.max(), 1e-12)) * 255.0)


def trajectory_vis(trajectories, output_path: str, seed: int = 0,
                   endpoints: bool = True):
    """Keypoint trajectories [F, K, 3] as one colored cloud: each
    keypoint's path gets a stable random color; first/last frames black
    (draw_trajectory twin, written as PLY instead of an open3d window)."""
    tr = np.asarray(trajectories, np.float32)          # [F, K, 3]
    F, K, _ = tr.shape
    colors = np.random.default_rng(seed).uniform(0, 1, (K, 3)).astype(
        np.float32
    )
    pts = tr.reshape(F * K, 3)
    cols = np.tile(colors, (F, 1))
    if endpoints:
        black = np.zeros((2 * K, 3), np.float32)
        pts = np.concatenate([pts, tr[0], tr[-1]], axis=0)
        cols = np.concatenate([cols, black], axis=0)
    store_point_cloud(output_path, pts, cols * 255.0)
