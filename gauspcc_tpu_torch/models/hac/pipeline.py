"""HAC eval: render the held-out views and score them against ground truth
(counterpart of gauspcc_tpu/models/hac/pipeline.py: _raster_cfg :34,
select_eval_d :75, render_sets :414, evaluate :447).

LPIPS is not computed (no VGG weights are available), and no PNG is
written: the renders come back as tensors.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from gauspcc_tpu_torch.models.hac import model as hac
from gauspcc_tpu_torch.models.hac import render as hac_render
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
        ng = hac.generate_neural_gaussians(state, cfg, ca.camera_center,
                                           visible)
        fp = raster.max_tile_footprint(ng.xyz, ng.scaling, ng.rot,
                                       ca.viewmatrix, rcfg, valid=ng.valid)
        worst = max(worst, int(fp))
    d = 4
    while d < min(worst, cap):
        d *= 2
    return d


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
             white_background: bool = False) -> dict:
    """PSNR/SSIM of the STE-quantised renders against the cameras'
    ground-truth images.

    K is the per-tile cap (the r5 soak evaluated at 1024); D comes from
    `select_eval_d`, capped at 128."""
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
