"""HAC scene pipeline: train a scene, render the held-out views and score
them against ground truth (counterpart of gauspcc_tpu/models/hac/pipeline.py:
_raster_cfg :34, select_eval_d :75, select_eval_k :94, adapt_caps :121,
train_scene :150, render_sets :414, evaluate :447).

LPIPS is not computed (no VGG weights are available), and no PNG is
written: the renders come back as tensors. `train_scene` has no
checkpoint, resume, GUI, heartbeat or divergence canary, and runs no codec
at its end.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from gauspcc_tpu_torch.device import resolve
from gauspcc_tpu_torch.models.hac import model as hac
from gauspcc_tpu_torch.models.hac import render as hac_render
from gauspcc_tpu_torch.models.hac import train as hac_train
from gauspcc_tpu_torch.render import raster
from gauspcc_tpu_torch.utils import image as img_lib


def _raster_cfg(cam, max_k: int = 256, max_d: int = 32) -> raster.RasterConfig:
    return raster.RasterConfig(
        height=cam.height, width=cam.width,
        tanfovx=cam.tanfovx, tanfovy=cam.tanfovy,
        max_gaussians_per_tile=max_k, max_tiles_per_gaussian=max_d)


def _device(state) -> torch.device:
    return state["anchors"]["anchor"].device


@torch.no_grad()
def select_eval_d(state, cfg: hac.HACConfig, cameras, cap: int = 128) -> int:
    """Smallest power-of-two D (from 4, at most `cap`) that covers the
    largest tile footprint over all views: below the cap it renders exactly
    as an unbounded D, and it only shrinks the binning sort."""
    worst = 0
    for cam in cameras:
        rcfg = _raster_cfg(cam)
        ca = hac_render.CameraArrays.from_camera(cam, _device(state))
        visible = hac_render.prefilter_voxel(state, cfg, ca, rcfg)
        ng, _ = hac.generate_neural_gaussians(state, cfg, ca.camera_center,
                                              visible)
        fp = raster.max_tile_footprint(ng.xyz, ng.scaling, ng.rot,
                                       ca.viewmatrix, rcfg, valid=ng.valid)
        worst = max(worst, int(fp))
    d = 4
    while d < min(worst, cap):
        d *= 2
    return d


@torch.no_grad()
def select_eval_k(state, cfg: hac.HACConfig, cam, decoded: bool = False,
                  start_k: int = 256, max_k: int = 4096,
                  tol_db: float = 45.0) -> int:
    """Smallest per-tile cap K whose render matches the 2K render to at
    least tol_db PSNR, doubling from start_k (the reference blends
    unbounded lists; the far tail sits behind ever smaller transmittance)."""
    dev = _device(state)
    ca = hac_render.CameraArrays.from_camera(cam, dev)
    bg = torch.zeros(3, device=dev)
    k = start_k
    img_k = hac_render.render_image(state, cfg, ca, _raster_cfg(cam, k), bg,
                                    decoded=decoded)
    while k < max_k:
        img_2k = hac_render.render_image(state, cfg, ca, _raster_cfg(cam, 2 * k),
                                         bg, decoded=decoded)
        if float(img_lib.psnr(img_k, img_2k)) >= tol_db:
            return k
        k *= 2
        img_k = img_2k
    return k


@torch.no_grad()
def adapt_caps(state, cfg: hac.HACConfig, rc: raster.RasterConfig, cam,
               log=print, max_d: int = 256, max_k: int = 1024):
    """Grow the bounded-work raster caps when the scene outgrows them:
    double D when over 5% of the visible Gaussians overflow it, K when over
    2% of the occupied tiles do (training against an over-truncated forward
    collapsed earlier soaks). `cam`: CameraArrays. Returns (rc, grew)."""
    visible = hac_render.prefilter_voxel(state, cfg, cam, rc)
    ng, _ = hac.generate_neural_gaussians(state, cfg, cam.camera_center, visible)
    sat = raster.tile_saturation(ng.xyz, ng.scaling, ng.rot, cam.viewmatrix,
                                 rc, valid=ng.valid)
    over_d, over_k, max_cnt = (float(sat[k]) for k in (
        "frac_gauss_over_d", "frac_tiles_over_k", "max_tile_count"))
    grew = False
    if over_d > 0.05 and rc.max_tiles_per_gaussian < max_d:
        rc = rc._replace(max_tiles_per_gaussian=rc.max_tiles_per_gaussian * 2)
        grew = True
    if over_k > 0.02 and rc.max_gaussians_per_tile < max_k:
        rc = rc._replace(max_gaussians_per_tile=rc.max_gaussians_per_tile * 2)
        grew = True
    if grew:
        log(f"raster caps -> D={rc.max_tiles_per_gaussian} "
            f"K={rc.max_gaussians_per_tile} (over_d {over_d:.3f}, "
            f"over_k {over_k:.3f}, max_tile {max_cnt:.0f})")
    return rc, grew


CAP_ADAPT_EVERY = 500  # steps between checks of the raster caps


def train_scene(scene, cfg: hac.HACConfig, opt: hac_train.OptConfig, *,
                seed: int = 0, log_every: int = 200,
                white_background: bool = False,
                phase_of_step: Callable[[int], int] = hac_train.phase_of_step,
                log=print, device="cuda"):
    """Train one scene; returns (state, results).

    The loop of the JAX package's train_scene: cameras in the order of
    rng.permutation, the raster caps adapted every CAP_ADAPT_EVERY steps,
    the anchor bound refitted on entering phase 2, densification every
    `update_interval` steps between update_from and update_until.
    `phase_of_step` maps a step to its schedule stage (a compressed one for
    short runs, cli/soak.py). results: "history" (per step: step, phase,
    loss, l1, psnr, bit_per_param, non-finite gradients, copied to the host
    once at the end), "densify" (per densification: step and adjust_anchor's
    info), "caps" (per cap change: step, D, K), "rcfg", "opt_state",
    "stats"."""
    dev = resolve(device)
    optimizer = hac_train.make_optimizer(opt, scene.cameras_extent)
    cams = scene.train_cameras
    rcfg = _raster_cfg(cams[0])
    cam_arrays = [hac_render.CameraArrays.from_camera(c, dev, with_image=True)
                  for c in cams]

    points = hac.voxelize_points(scene.points, cfg.voxel_size, seed)
    state = hac.update_anchor_bound(hac.init_state(
        cfg, points, np.random.default_rng(seed), device=dev))
    log(f"anchors at init: {points.shape[0]}")
    params, rest = hac.split_state(state)
    opt_state = optimizer.init(hac_train.param_leaves(params))
    stats = hac_train.zero_stats(rest["valid"].shape[0], cfg.n_offsets, dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(cam_arrays)).tolist()

    def mk_step(rc):
        return hac_train.make_train_step(cfg, rc, optimizer, opt,
                                         white_background=white_background)

    step_fn = mk_step(rcfg)
    history, densify, caps = [], [], []
    t0 = time.perf_counter()
    for it in range(1, opt.iterations + 1):
        if it == 1 or it % CAP_ADAPT_EVERY == 0:
            rcfg, grew = adapt_caps(hac.merge_state(params, rest), cfg, rcfg,
                                    cam_arrays[0], log=log)
            if grew:
                step_fn = mk_step(rcfg)
                caps.append((it, rcfg.max_tiles_per_gaussian,
                             rcfg.max_gaussians_per_tile))
        if not order:
            order = rng.permutation(len(cam_arrays)).tolist()
        cam = cam_arrays[order.pop()]
        phase = phase_of_step(it)
        if phase >= 2 and phase_of_step(it - 1) < 2:
            # refit the context's bounding box to the densified anchors
            # before the rate phase
            params, rest = hac.split_state(hac.update_anchor_bound(
                hac.merge_state(params, rest)))
        params, opt_state, stats, metrics = step_fn(
            params, rest, opt_state, stats, cam, phase=phase, generator=gen)
        history.append(torch.stack([
            metrics["loss"], metrics["l1"], metrics["psnr"],
            metrics["bit_per_param"],
            metrics["nonfinite_grads"].to(torch.float32)]))
        if log_every and it % log_every == 0:
            log(f"iter {it} (phase {phase}): loss {float(metrics['loss']):.4f} "
                f"psnr {float(metrics['psnr']):.2f} "
                f"bit/param {float(metrics['bit_per_param']):.4f} "
                f"({(time.perf_counter() - t0) / it * 1e3:.1f} ms/it)")
        if (opt.start_stat < it < opt.update_until and it > opt.update_from
                and it % opt.update_interval == 0 and not 3000 <= it < 4000):
            state, stats, opt_state, info = hac_train.adjust_anchor(
                hac.merge_state(params, rest), stats, opt_state, cfg, opt, rng)
            params, rest = hac.split_state(state)
            densify.append((it, info))
            log(f"iter {it}: anchors {info['n_anchors']} "
                f"(+{info['n_added']}/-{info['n_pruned']})")
    per_step = torch.stack(history).cpu().numpy() if history else np.zeros((0, 5))
    steps = np.arange(1, len(history) + 1)
    results = {
        "history": {
            "step": steps,
            "phase": np.array([phase_of_step(int(i)) for i in steps]),
            "loss": per_step[:, 0], "l1": per_step[:, 1], "psnr": per_step[:, 2],
            "bit_per_param": per_step[:, 3], "nonfinite_grads": per_step[:, 4],
        },
        "densify": densify, "caps": caps, "rcfg": rcfg,
        "opt_state": opt_state, "stats": stats,
    }
    return hac.merge_state(params, rest), results


class _ViewTimer:
    """Milliseconds of one render: CUDA events on the GPU, the host clock
    on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def __enter__(self):
        if self.cuda:
            self.e0 = torch.cuda.Event(enable_timing=True)
            self.e1 = torch.cuda.Event(enable_timing=True)
            self.e0.record()
        else:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            self.e1.record()
            self.e1.synchronize()
            self.ms = self.e0.elapsed_time(self.e1)
        else:
            self.ms = (time.perf_counter() - self.t0) * 1e3


@torch.no_grad()
def render_sets(state, cfg: hac.HACConfig, cameras,
                white_background: bool = False, max_k: int = 256,
                max_d: int = 32):
    """Render all views. Returns (renders [3, H, W] each, ms per view).

    Each shape bucket gets one untimed warm-up render first, so the times
    are steady-state renders."""
    dev = _device(state)
    bg = torch.ones(3, device=dev) if white_background else torch.zeros(3, device=dev)
    renders, ms = [], []
    warmed: set = set()
    for cam in cameras:
        rcfg = _raster_cfg(cam, max_k, max_d)
        ca = hac_render.CameraArrays.from_camera(cam, dev)
        if rcfg not in warmed:
            hac_render.render_image(state, cfg, ca, rcfg, bg)
            warmed.add(rcfg)
        with _ViewTimer(dev) as t:
            img = hac_render.render_image(state, cfg, ca, rcfg, bg)
        renders.append(img)
        ms.append(t.ms)
    return renders, ms


@torch.no_grad()
def evaluate(state, cfg: hac.HACConfig, cameras, max_k: int = 1024,
             white_background: bool = False, auto_k: bool = False) -> dict:
    """PSNR/SSIM of the STE-quantised renders against the cameras'
    ground-truth images.

    K is the per-tile cap (the r5 soak evaluated at 1024), or with `auto_k`
    the smallest visually lossless one on the first camera
    (`select_eval_k`); D comes from `select_eval_d`, capped at 128."""
    if auto_k and cameras:
        max_k = select_eval_k(state, cfg, cameras[0])
    max_d = select_eval_d(state, cfg, cameras)
    renders, ms = render_sets(state, cfg, cameras, white_background,
                              max_k=max_k, max_d=max_d)
    per_view = {}
    for i, (cam, img) in enumerate(zip(cameras, renders)):
        entry = {"ms": ms[i]}
        if cam.image is not None:
            gt = torch.from_numpy(cam.image).to(img.device)
            entry["psnr"] = float(img_lib.psnr(img, gt))
            entry["ssim"] = float(img_lib.ssim(img, gt))
        per_view[f"{i:05d}"] = entry
    scored = [v for v in per_view.values() if "psnr" in v]
    return {
        "psnr": float(np.mean([v["psnr"] for v in scored])) if scored else None,
        "ssim": float(np.mean([v["ssim"] for v in scored])) if scored else None,
        "eval_k": max_k,
        "eval_d": max_d,
        "fps": len(ms) / max(sum(ms) / 1e3, 1e-9),
        "per_view": per_view,
        "renders": renders,
    }
