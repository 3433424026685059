"""The multi-GPU training step: tile bands and data groups over a
('data', 'tile') mesh of ranks. Torch twin of the JAX package's
parallel/shard.py:make_sharded_train_step.

Every rank holds the whole (replicated) state and
  1. deforms the Gaussians: its 1 / n_tile of the rows when shard_deform
     is on and the capacity divides, the slices all-gathered over 'tile'
     (xyz, rotation, scaling, opacity: 11 floats a Gaussian);
  2. renders only its band of tile rows for its data group's camera
     (ops/rasterize.py render(tile_band=...));
  3. all-gathers the bands over 'tile' into the frame and takes the loss
     terms over its band's rows only (SSIM's 11-tap window reads a 5-row
     halo from the zero-padded frame, which reproduces the whole frame's
     'same' zero padding), the partial sums summed over 'tile' (with one
     band, n_tile = 1, the single step's loss of the whole frame, so a
     1 x 1 mesh repeats make_train_step bit for bit);
  4. sums the loss over 'data', as the reference sums a batch's losses.

The JAX step differentiates through shard_map, whose gather transposes
to a scatter of band cotangents and whose replicated inputs transpose to
a sum over the mesh. Here the communication is written out, so that each
rank backpropagates only its own share of the loss and every gradient is
summed exactly once:
  - the frame's cotangent of this rank's band-local loss terms (halo rows
    included) is summed over 'tile', and each rank takes its band's rows:
    a halo row's cotangent returns to the band that rendered it;
  - the band's render backpropagates that cotangent; the motion-feature
    regularizer is added once a data group, on tile index 0;
  - under the sharded deform the deformed rows' cotangent is summed over
    'tile' and each rank backpropagates its own slice through the deform;
  - the parameter gradients and the screen-space carrier's gradient are
    summed once over the whole mesh, in one all-reduce.
Every all-reduce leaves the same values on every rank, and the
statistics and Adam then run on every rank on identical inputs, so the
replicas stay bit-identical.

As the JAX sharded step, this step keeps no teacher statistics
(xyz_motion_accum_max, motion_denom), which the single step updates in
stages 2/3 under densify_from_teaching (ROADMAP.md, "Found in the
reference").
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from gaussianprediction_tpu_torch.config import Config
from gaussianprediction_tpu_torch.models import deform as D
from gaussianprediction_tpu_torch.models.gaussians import (
    STATS, GaussianState, get_shs,
)
from gaussianprediction_tpu_torch.ops import rasterize
from gaussianprediction_tpu_torch.ops.projection import TILE
from gaussianprediction_tpu_torch.parallel.mesh import Mesh
from gaussianprediction_tpu_torch.train import optimizer as opt_mod
from gaussianprediction_tpu_torch.train.step import (
    _randn, _step_parts, deform_for_stage, device_scalars, scalar_columns,
    step_scalars, time_with_noise, trainable_params,
)
from gaussianprediction_tpu_torch.utils.image import (
    _ssim_maps, dssim_l1_loss, l1_loss, psnr,
)

# params with a leading per-Gaussian capacity axis: the rows a tile rank
# deforms under the sharded deform
PER_GAUSSIAN = ("xyz", "features_dc", "features_rest", "scaling",
                "rotation", "opacity", "motion_feature", "opacity_thres")
HALO = 5          # SSIM window 11 // 2


def band_geometry(height: int, n_tile: int):
    """(tile rows a band, the band-padded frame height in pixels)."""
    grid_y = (height + TILE - 1) // TILE
    band = -(-grid_y // n_tile)
    return band, band * n_tile * TILE


def band_multiplier(capacity_multiplier: float, height: int, n_tile: int,
                    band_capacity_slack: float = 2.0) -> float:
    """The instance capacity multiplier of one band, as the JAX step sizes
    it: the band's share of the tile rows times the slack, at least 2 (one
    band: the multiplier itself)."""
    if n_tile <= 1:
        return float(capacity_multiplier)
    grid_y = (height + TILE - 1) // TILE
    band, _ = band_geometry(height, n_tile)
    return max(2.0, capacity_multiplier * (band / grid_y)
               * band_capacity_slack)


def _all_gather_rows(x, group, n: int):
    """The tensors of the group's ranks, concatenated along dim 0."""
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=0)


def _deform_noise(stage: int, state: GaussianState, sigma: float,
                  generator):
    """The deform's N(0,1) draw at full size ([C, 3] in stage 1, the
    keypoints' [Ck, 3] in stages 2/3), where its anneal `sigma` is not
    0."""
    if stage == 0 or sigma == 0.0:
        return None
    rows = state.params["xyz" if stage == 1 else "super_xyz"]
    return _randn(rows.shape, generator, rows.device)


def make_sharded_train_step(cfg: Config, stage: int, width: int,
                            height: int, spatial_scale: float,
                            sh_degree: int, total_frame: int, bg,
                            mesh: Mesh, capacity_multiplier: float = 24,
                            band_capacity_slack: float = 2.0,
                            shard_deform: bool = True):
    """The training step of one stage over `mesh`; returns (step, n_data).

    step(state, opt_state, cams, gts, times, iteration, generator=None,
         active_deg=None, noise=None, time_noises=None)
      -> (state, opt_state, metrics)

    Every rank of the mesh calls it with the same arguments: the n_data
    cameras, [H, W, 3] targets and 0-d times of the data groups (a rank
    reads its own group's; another group's target may be None), the
    replicated state, and the same draws. noise is the deform's N(0,1)
    draw at full size (as make_train_step takes it; each rank slices its
    rows), time_noises one 0-d draw per data group; either is drawn from
    `generator` when None (time noises first, in group order), so ranks
    whose generators agree draw alike. metrics: loss (summed over
    'data'), l1 and psnr (their means over 'data'), n_dropped (the
    largest of the mesh), grads (the summed gradients)."""
    n_tile, n_data = mesh.n_tile, mesh.n_data
    band, pad_h = band_geometry(height, n_tile)
    mult_band = band_multiplier(capacity_multiplier, height, n_tile,
                                band_capacity_slack)
    ty0 = mesh.tile_index * band
    bh, y0px = band * TILE, ty0 * TILE
    opt_stage = max(stage, 1)
    groups = opt_mod.active_groups(cfg, opt_stage)
    _, finish = _step_parts(cfg, stage, width, height, spatial_scale,
                            sh_degree, bg)
    lam = cfg.opt.lambda_dssim
    denom = float(height * width * 3)
    cols = scalar_columns(cfg, stage)
    c_sigma, c_anneal = cols.index("sigma"), cols.index("time_anneal")

    def deform(params, state, t, iteration, noise, sigma):
        """(deformed xyz, rotation, scaling, opacity as the render reads
        them, the outputs to backpropagate, their slice or None)."""
        C = state.capacity
        if not (shard_deform and n_tile > 1 and C % n_tile == 0):
            out = deform_for_stage(params, cfg, state, t, iteration, None,
                                   stage, noise=noise, sigma=sigma)
            return (out.xyz, out.rotation, out.scaling, out.opacity), \
                None, None
        cs = C // n_tile
        sl = slice(mesh.tile_index * cs, (mesh.tile_index + 1) * cs)
        p_sl = {k: (v[sl] if k in PER_GAUSSIAN else v)
                for k, v in params.items()}
        st_sl = state.replace(params=p_sl, alive=state.alive[sl],
                              **{k: getattr(state, k)[sl] for k in STATS})
        out = deform_for_stage(
            p_sl, cfg, st_sl, t, iteration, None, stage,
            noise=noise[sl] if stage == 1 and noise is not None else noise,
            sigma=sigma)
        outs = (out.xyz, out.rotation, out.scaling, out.opacity)
        widths = [o.reshape(cs, -1).shape[1] for o in outs]
        with torch.no_grad():
            rows = torch.cat([o.detach().reshape(cs, -1) for o in outs], 1)
            full = _all_gather_rows(rows, mesh.tile_group, n_tile)
        leaves = [x.reshape((C,) + o.shape[1:]).clone().requires_grad_(True)
                  for x, o in zip(torch.split(full, widths, dim=1), outs)]
        return tuple(leaves), outs, sl

    def step(state: GaussianState, opt_state, cams, gts, times,
             iteration: int, generator: Optional[torch.Generator] = None,
             active_deg=None, noise=None, time_noises=None):
        if not (len(cams) == len(gts) == len(times) == n_data):
            raise ValueError(f"{n_data} cameras, targets and times, one a "
                             "data group")
        time_noises = time_noises or [None] * n_data
        # the iteration's row of step_scalars, on the host and the device
        host = step_scalars(cfg, stage, spatial_scale, [iteration])[0]
        row = device_scalars(host[None], state.device)[0]
        ts = [time_with_noise(cfg, times[j], generator, total_frame,
                              row[c_anneal], noise=time_noises[j])
              for j in range(n_data)]
        if noise is None:
            noise = _deform_noise(stage, state, float(host[c_sigma]),
                                  generator)
        d = mesh.data_index
        cam, gt, t = cams[d], gts[d], ts[d]
        C = state.capacity
        trainable, params = trainable_params(state, groups)
        leaves = [x for k in trainable
                  for x in opt_mod.tree_leaves(params[k])]
        dummy = torch.zeros((C, 2), dtype=torch.float32,
                            device=state.device, requires_grad=True)

        (xyz, rot, scl, op), d_outs, sl = deform(params, state, t,
                                                 iteration, noise,
                                                 row[c_sigma])
        shs = get_shs(params)
        if active_deg is not None:
            kidx = torch.arange(shs.shape[-1], device=shs.device)
            shs = torch.where(kidx[None, None, :] < (active_deg + 1) ** 2,
                              shs, torch.zeros_like(shs))
        pkg = rasterize.render(
            xyz, scl, rot, op, shs, cam, width, height, bg,
            sh_degree=sh_degree, alive=state.alive,
            capacity_multiplier=mult_band, tile_band=(ty0, band),
            need_tidx=False, means2d_dummy=dummy)
        band_img = pkg["render"]                       # [bh, W, 3]

        # the band-local loss terms on the gathered, zero-padded frame
        with torch.no_grad():
            frame = _all_gather_rows(band_img.detach(), mesh.tile_group,
                                     n_tile)
        frame.requires_grad_(True)
        full = frame[:height]
        if n_tile == 1:
            # one band holds the frame: the single step's loss, term for
            # term (no halo, no tile sum)
            photo = dssim_l1_loss(full, gt, lam)
            dframe, = torch.autograd.grad(photo, frame)
            dband = dframe
            l1_mean, photo = l1_loss(full.detach(), gt), photo.detach()
        else:
            pad = (0, 0, 0, 0, HALO, HALO + pad_h - height)
            sl_f = F.pad(full, pad)[y0px:y0px + bh + 2 * HALO]
            sl_g = F.pad(gt, pad)[y0px:y0px + bh + 2 * HALO]
            ssim_map, _ = _ssim_maps(sl_f, sl_g, 11, 1.5, valid=False)
            rows = torch.arange(bh, device=frame.device) + y0px
            rmask = (rows < height).to(torch.float32)[:, None, None]
            ssim_sum = torch.sum(ssim_map[HALO:HALO + bh] * rmask)
            l1_sum = torch.sum(torch.abs(sl_f[HALO:HALO + bh]
                                         - sl_g[HALO:HALO + bh]) * rmask)
            part = (1.0 - lam) * l1_sum / denom - lam * ssim_sum / denom
            dframe, = torch.autograd.grad(part, frame)
            tile_buf = torch.cat([dframe.reshape(-1),
                                  torch.stack([l1_sum, ssim_sum]).detach()])
            dist.all_reduce(tile_buf, group=mesh.tile_group)
            dband = tile_buf[:-2].reshape(frame.shape)[y0px:y0px + bh]
            l1_mean = tile_buf[-2] / denom
            photo = (1.0 - lam) * l1_mean + lam * (1.0 - tile_buf[-1] / denom)

        # backward: this rank's band, the regularizer once a data group
        reg = D.motion_feature_reg(params, stage)
        outs, gouts = [band_img], [dband]
        if mesh.tile_index == 0 and reg.requires_grad:
            outs.append(reg)
            gouts.append(torch.ones_like(reg))
        wrt = leaves + [dummy] + ([] if sl is None else [xyz, rot, scl, op])
        got = torch.autograd.grad(outs, wrt, gouts, allow_unused=True)
        got = [torch.zeros_like(x) if g is None else g
               for x, g in zip(wrt, got)]
        if sl is not None:
            # the deformed rows' cotangent, summed over 'tile', back
            # through this rank's slice of the deform
            d_full = got[len(leaves) + 1:]
            buf = torch.cat([g.reshape(-1) for g in d_full])
            dist.all_reduce(buf, group=mesh.tile_group)
            pieces = torch.split(buf, [g.numel() for g in d_full])
            pairs = [(o, p.reshape(g.shape)[sl])
                     for o, p, g in zip(d_outs, pieces, d_full)
                     if o.requires_grad]
            back = torch.autograd.grad([o for o, _ in pairs],
                                       leaves, [g for _, g in pairs],
                                       allow_unused=True)
            got = [g if b is None else g + b
                   for g, b in zip(got[:len(leaves)], back)] + \
                [got[len(leaves)]]
        got = got[:len(leaves) + 1]
        flat = torch.cat([g.reshape(-1) for g in got])
        dist.all_reduce(flat, group=mesh.group)
        got = [p.reshape(x.shape) for p, x in zip(
            torch.split(flat, [x.numel() for x in leaves + [dummy]]),
            leaves + [dummy])]
        it = iter(got)
        grads = {k: opt_mod.tree_map(lambda _: next(it), params[k])
                 for k in trainable}
        vs_grads = next(it)

        # metrics and statistics over 'data' (and n_dropped over the mesh)
        with torch.no_grad():
            loss_d = photo + reg.detach()
            mets = torch.stack([loss_d, l1_mean, psnr(full.detach(), gt)])
            dist.all_reduce(mets, group=mesh.data_group)
            ints = torch.cat([pkg["radii"].to(torch.int32),
                              pkg["visibility_filter"].to(torch.int32)])
            dist.all_reduce(ints, op=dist.ReduceOp.MAX,
                            group=mesh.data_group)
            n_dropped = pkg["n_dropped"].reshape(1).to(torch.int32)
            dist.all_reduce(n_dropped, op=dist.ReduceOp.MAX,
                            group=mesh.group)
        state, opt_state = finish(state, opt_state, grads, vs_grads,
                                  ints[:C], ints[C:] > 0, row, t, None)
        metrics = {"loss": mets[0], "l1": mets[1] / n_data,
                   "psnr": mets[2] / n_data, "n_dropped": n_dropped[0],
                   "grads": grads}
        return state, opt_state, metrics

    return step, n_data
