"""HAC rendering glue (counterpart of gauspcc_tpu/models/hac/render.py):
prefilter, neural Gaussians, tile rasterization, and the training objective."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gauspcc_tpu_torch.core import entropy
from gauspcc_tpu_torch.device import resolve
from gauspcc_tpu_torch.models.hac import model as hac
from gauspcc_tpu_torch.render import raster
from gauspcc_tpu_torch.utils import image as img_lib
from gauspcc_tpu_torch.utils import profiling


class CameraArrays(NamedTuple):
    """Device-side camera (host Camera -> tensors once per view)."""

    viewmatrix: torch.Tensor  # [4,4] W2V^T
    camera_center: torch.Tensor  # [3]
    image: torch.Tensor | None = None  # [3, H, W] ground truth (training)

    @staticmethod
    def from_camera(cam, device="cuda", with_image: bool = False) -> "CameraArrays":
        """The camera on `device`; with its ground-truth image (zeros if it
        has none) when `with_image`, as training needs it."""
        dev = resolve(device)
        image = None
        if with_image:
            img = cam.image if cam.image is not None else np.zeros(
                (3, cam.height, cam.width), np.float32)
            image = torch.from_numpy(np.ascontiguousarray(img)).to(dev)
        return CameraArrays(
            viewmatrix=torch.from_numpy(cam.world_view_transform).to(dev),
            camera_center=torch.from_numpy(cam.camera_center).to(dev),
            image=image)


@profiling.span("hac.prefilter")
def prefilter_voxel(state, cfg: hac.HACConfig, cam: CameraArrays,
                    rcfg: raster.RasterConfig, decoded: bool = False):
    """Anchor visibility mask [cap]."""
    with torch.no_grad():
        return raster.visible_filter(
            hac.get_anchor(state, cfg, decoded),
            hac.get_scaling(state, decoded)[:, :3],
            state["anchors"]["rotation"],
            cam.viewmatrix, rcfg, valid=state["valid"])


def render_view(state, cfg: hac.HACConfig, cam: CameraArrays,
                rcfg: raster.RasterConfig, bg_color: torch.Tensor, *,
                training: bool = False, phase: int = 0, noise=None,
                generator: torch.Generator | None = None,
                decoded: bool = False, means2d_extra=None) -> dict:
    visible = prefilter_voxel(state, cfg, cam, rcfg, decoded)
    with profiling.span("hac.neural"):
        ng, rate = hac.generate_neural_gaussians(
            state, cfg, cam.camera_center, visible, training=training,
            phase=phase, noise=noise, generator=generator, decoded=decoded)
    return draw(ng, rate, visible, cam, rcfg, bg_color, means2d_extra)


def draw(ng: hac.NeuralGaussians, rate, visible: torch.Tensor,
         cam: CameraArrays, rcfg: raster.RasterConfig, bg_color: torch.Tensor,
         means2d_extra=None) -> dict:
    """Rasterize the neural Gaussians `ng` into render_view's dict (every
    family's renders end here)."""
    img, radii = raster.rasterize(
        means3d=ng.xyz, colors=ng.color, opacities=ng.opacity,
        scales=ng.scaling, rotations=ng.rot, viewmatrix=cam.viewmatrix,
        bg_color=bg_color, cfg=rcfg, valid=ng.valid,
        means2d_extra=means2d_extra)
    return {"render": img, "radii": radii, "gaussians": ng,
            "visible_anchor": visible, "rate": rate}


@torch.no_grad()
@profiling.span("hac.view")
def render_image(state, cfg: hac.HACConfig, cam: CameraArrays,
                 rcfg: raster.RasterConfig, bg_color: torch.Tensor, *,
                 decoded: bool = False) -> torch.Tensor:
    """Eval render: [3, H, W] image only."""
    return render_view(state, cfg, cam, rcfg, bg_color, decoded=decoded)["render"]


def training_loss(params, rest, cfg: hac.HACConfig, cam: CameraArrays,
                  rcfg: raster.RasterConfig, bg_color, phase: int, noise,
                  means2d_extra, lmbda: float, lambda_dssim: float = 0.2, *,
                  generator: torch.Generator | None = None):
    """The full HAC objective (the reference's train.py:190-202) for one
    view: (1 - lambda_dssim) L1 + lambda_dssim (1 - SSIM) + 0.01 times the
    scaling regularizer; in phase 2 also lmbda (bits per parameter + the
    hash tables' bits over the parameter count) and 5e-4 mean(sigmoid(mask)).
    `noise`: the phase's uniform draws (see generate_neural_gaussians), or
    None to draw them from `generator`. Returns (loss, aux)."""
    state = hac.merge_state(params, rest)
    out = render_view(state, cfg, cam, rcfg, bg_color, training=True,
                      phase=phase, noise=noise, generator=generator,
                      means2d_extra=means2d_extra)
    with profiling.span("hac.objective"):
        return objective(state, cfg, cam.image, out, lmbda, lambda_dssim)


def objective(state, cfg, gt: torch.Tensor, out: dict, lmbda: float,
              lambda_dssim: float = 0.2):
    """The loss and aux of a training render `out` (render_view's dict)
    against the ground truth `gt`: the image terms, and with the render's
    rate terms lmbda (bits per parameter + the hash tables' bits over the
    parameter count) + 5e-4 mean(sigmoid(mask)); shared by the families
    whose objective is HAC's with their own rate terms (HAC++)."""
    loss, aux = image_objective(gt, out, lambda_dssim)
    rate = out["rate"]
    if rate is not None:
        flat = hac.encoding_params_flat(state)
        _, bit_hash = entropy.binary_size_bits((flat + 1.0) / 2.0)
        n_valid = torch.clamp_min(state["valid"].to(torch.float32).sum(), 1.0)
        denom = n_valid * (cfg.feat_dim + 6 + 3 * cfg.n_offsets)
        loss = loss + lmbda * (rate["bit_per_param"] + bit_hash / denom)
        loss = loss + 5e-4 * torch.sigmoid(state["anchors"]["mask"]).mean()
        aux["bit_per_param"] = rate["bit_per_param"]
    return loss, aux


def image_objective(gt: torch.Tensor, out: dict, lambda_dssim: float = 0.2):
    """The image terms of a training render `out` against `gt`: (1 -
    lambda_dssim) L1 + lambda_dssim (1 - SSIM) + 0.01 times the scaling
    regularizer; and the aux, with bit_per_param 0 (every family adds its
    own rate terms to both)."""
    img = out["render"]
    l1 = img_lib.l1_loss(img, gt)
    ssim_v = img_lib.ssim(img, gt)
    ng = out["gaussians"]
    vmask = ng.valid.to(torch.float32)
    # the product written out: torch's prod backward tests for zeros on the
    # host, a sync on every step
    volume = ng.scaling[:, 0] * ng.scaling[:, 1] * ng.scaling[:, 2]
    scaling_reg = (volume * vmask).sum() / torch.clamp_min(vmask.sum(), 1.0)

    loss = (1.0 - lambda_dssim) * l1 + lambda_dssim * (1.0 - ssim_v)
    loss = loss + 0.01 * scaling_reg
    aux = {
        "l1": l1,
        "ssim": ssim_v,
        "psnr": img_lib.psnr(img, gt),
        "radii": out["radii"],
        "visible_anchor": out["visible_anchor"],
        "neural_opacity": ng.neural_opacity,
        "g_valid": ng.valid,
        "bit_per_param": torch.zeros((), device=img.device),
    }
    return loss, aux
