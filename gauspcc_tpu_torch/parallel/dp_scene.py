"""Data-parallel scene training, a camera per rank a step (counterpart of
gauspcc_tpu/parallel/dp_scene.py: `stack_cameras` :25,
`make_dp_scene_step` :33).

Each rank renders and differentiates its own camera against the
replicated model through the single step's own body
(`models/hac/train.py` `step_gradients`), the gradients are mean-reduced
over the group, and one per-group Adam update, identical on every rank,
follows. The step's increments of the four densification statistics are
sum-reduced and added to the replicated totals, so the host's anchor
adjustment sees every rank's cameras. (Reducing the totals instead would
multiply every earlier step's statistics by the world size.)

The step follows the port's single step, not JAX's DP step, which departs
from JAX's own single step in four ways: its `offset_gradient_accum`
norm lacks the NDC scale (W/2, H/2) that `densify_grad_threshold` is
tuned for (`dp_scene.py:62` against `train.py:181-183`), it has no
non-finite filter, its background is always black, and it has no family
`grad_mask`. So a one-rank DP step is the single step's code, and on a
square frame the port's `offset_gradient_accum` is W/2 times JAX's DP
value.

`rank_main` is the rank program `dist.launch` runs: one DP step on the
inputs of a `dist.write_inputs` file's "scene" section.
"""

from __future__ import annotations

import numpy as np
import torch

from gauspcc_tpu_torch.models.hac import model as hac
from gauspcc_tpu_torch.models.hac import render as hac_render
from gauspcc_tpu_torch.models.hac import train as hac_train
from gauspcc_tpu_torch.parallel import dist as pdist
from gauspcc_tpu_torch.render import raster


def stack_cameras(cams: list) -> hac_render.CameraArrays:
    """Per-rank cameras (CameraArrays with images) stacked on a leading
    rank axis; rank r takes row r."""
    return hac_render.CameraArrays(
        viewmatrix=torch.stack([c.viewmatrix for c in cams]),
        camera_center=torch.stack([c.camera_center for c in cams]),
        image=torch.stack([c.image for c in cams]))


def make_dp_scene_step(cfg, rcfg: raster.RasterConfig, optimizer, opt,
                       loss_fn=None, grad_mask=None,
                       white_background: bool = False):
    """step(params, rest, opt_state, stats, cams, phase=0, noise=None,
    generator=None) -> (params, opt_state, stats, metrics), on every rank
    of the default process group.

    `cams`: stack_cameras of one camera per rank; `noise`: None, or the
    phase's quantization noise with a leading rank axis (rank r takes row
    r); else each rank draws from its own `generator` (`dist.
    rank_generator(seed, rank, device)`). The first call broadcasts the
    trainable leaves from rank 0. Leaves, moments and statistics are
    updated in place, as the single step's. metrics: loss, l1, psnr and
    bit_per_param mean-reduced, the non-finite count of the reduced
    gradients, and those gradients ("grads")."""
    replicated = [False]

    def step(params, rest, opt_state, stats, cams, phase: int = 0, noise=None,
             generator=None):
        rank = torch.distributed.get_rank()
        leaves = hac_train.param_leaves(params)
        if not replicated[0]:
            pdist.broadcast_(leaves)
            replicated[0] = True
        cam = hac_render.CameraArrays(*(t[rank] for t in cams))
        if noise is not None:
            noise = tuple(n[rank] for n in noise)
        g = hac_train.step_gradients(
            cfg, rcfg, opt, params, rest, cam, phase, noise, generator,
            loss_fn=loss_fn, grad_mask=grad_mask,
            white_background=white_background)
        scalars = {k: g.aux[k].detach().clone()
                   for k in ("l1", "psnr", "bit_per_param")}
        scalars["loss"] = g.loss.clone()
        pdist.all_reduce_mean_({**g.grads, **scalars})
        opt_state, nonfinite = hac_train.apply_gradients(
            optimizer, g.grads, opt_state, leaves)
        pdist.all_reduce_sum_(g.increments)
        hac_train.add_stats_(stats, g.increments)
        return params, opt_state, stats, {**scalars,
                                          "nonfinite_grads": nonfinite,
                                          "grads": g.grads}

    return step


# ---------------------------------------------------------------------------
# the rank program
# ---------------------------------------------------------------------------

def scene_inputs(state, cfg, family: str, cams: list, rcfg, opt,
                 spatial_lr_scale: float, phase: int, *, noise=None,
                 opt_state=None, stats=None, white_background=False,
                 seed: int = 0):
    """The "scene" section for `dist.write_inputs`: a state of `family`
    (registry name) with config `cfg`, one camera a rank (CameraArrays
    with images), the raster and optimizer configs; optionally the phase's
    noise per rank (a tuple of [world, ...] arrays), the moments and the
    statistics to start from (else zeros)."""
    from gauspcc_tpu_torch.utils.checkpoint import flatten

    arrays = {f"state/{k}": v for k, v in flatten(state).items()}
    stacked = stack_cameras(cams)
    arrays.update(viewmatrix=stacked.viewmatrix.cpu().numpy(),
                  camera_center=stacked.camera_center.cpu().numpy(),
                  image=stacked.image.cpu().numpy())
    for i, n in enumerate(noise or ()):
        arrays[f"noise{i}"] = np.asarray(n.cpu() if torch.is_tensor(n) else n)
    count = 0
    if opt_state is not None:
        for m in ("mu", "nu"):
            arrays.update(pdist.to_numpy(opt_state[m], f"{m}/"))
        count = int(opt_state["count"])
    if stats is not None:
        arrays.update(pdist.to_numpy(stats, "stat/"))
    meta = {"family": family, "cfg": cfg._asdict(), "rcfg": rcfg._asdict(),
            "opt": vars(opt), "spatial_lr_scale": spatial_lr_scale,
            "phase": phase, "count": count,
            "white_background": white_background, "seed": seed}
    return arrays, meta


def rank_main(rank: int, world: int, device, in_path: str, out_dir: str):
    """Take one DP step on the "scene" section on this rank and write its
    leaves, gradients, moments, statistics, metrics and K1 launches to
    `dist.output_path(out_dir, "scene", rank)`."""
    from gauspcc_tpu_torch import convert
    from gauspcc_tpu_torch.models import registry
    from gauspcc_tpu_torch.render import tile_blend

    arrays, meta = pdist.read_inputs(in_path, "scene")
    family = registry.get_family(meta["family"])
    cfg = family.make_config(**{k: tuple(v) if isinstance(v, list) else v
                                for k, v in meta["cfg"].items()})
    state = convert.state_from_numpy(
        {k[len("state/"):]: v for k, v in arrays.items()
         if k.startswith("state/")}, cfg, device)
    params, rest = hac.split_state(state)
    leaves = hac_train.param_leaves(params)
    opt = hac_train.OptConfig(**meta["opt"])
    optimizer = hac_train.make_optimizer(opt, meta["spatial_lr_scale"])
    opt_state = optimizer.init(leaves)
    if "mu/" + next(iter(leaves)) in arrays:
        for m in ("mu", "nu"):
            opt_state[m] = {k: torch.from_numpy(arrays[f"{m}/{k}"]).to(device)
                            for k in leaves}
        opt_state["count"] = meta["count"]
    stats = hac_train.zero_stats(rest["valid"].shape[0], cfg.n_offsets, device)
    for k in stats:
        if f"stat/{k}" in arrays:
            stats[k] = torch.from_numpy(arrays[f"stat/{k}"]).to(device)
    cams = hac_render.CameraArrays(
        *(torch.from_numpy(arrays[k]).to(device)
          for k in ("viewmatrix", "camera_center", "image")))
    noise = None
    if "noise0" in arrays:
        noise = tuple(torch.from_numpy(arrays[f"noise{i}"]).to(device)
                      for i in range(3))
    gen = pdist.rank_generator(meta["seed"], rank, device)
    step = make_dp_scene_step(
        cfg, raster.RasterConfig(**meta["rcfg"]), optimizer, opt,
        loss_fn=family.training_loss, grad_mask=family.grad_mask,
        white_background=meta["white_background"])
    fwd0, bwd0 = tile_blend.launches, tile_blend.backward_launches
    params, opt_state, stats, metrics = step(
        params, rest, opt_state, stats, cams, phase=meta["phase"], noise=noise,
        generator=gen)
    out = {**pdist.to_numpy(leaves, "leaf/"),
           **pdist.to_numpy(metrics["grads"], "grad/"),
           **pdist.to_numpy(opt_state["mu"], "mu/"),
           **pdist.to_numpy(opt_state["nu"], "nu/"),
           **pdist.to_numpy(stats, "stat/"),
           **{k: float(metrics[k]) for k in ("loss", "l1", "psnr",
                                              "bit_per_param")},
           "nonfinite_grads": int(metrics["nonfinite_grads"]),
           "count": opt_state["count"],
           "launches": tile_blend.launches - fwd0,
           "backward_launches": tile_blend.backward_launches - bwd0}
    np.savez(pdist.output_path(out_dir, "scene", rank), **out)
