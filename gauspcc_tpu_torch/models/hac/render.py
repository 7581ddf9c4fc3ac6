"""HAC rendering glue, eval path (counterpart of gauspcc_tpu/models/hac/render.py):
prefilter, neural Gaussians, tile rasterization."""

from __future__ import annotations

from typing import NamedTuple

import torch

from gauspcc_tpu_torch.device import resolve
from gauspcc_tpu_torch.models.hac import model as hac
from gauspcc_tpu_torch.render import raster


class CameraArrays(NamedTuple):
    """Device-side camera (host Camera -> tensors once per view)."""

    viewmatrix: torch.Tensor  # [4,4] W2V^T
    camera_center: torch.Tensor  # [3]

    @staticmethod
    def from_camera(cam, device="cuda") -> "CameraArrays":
        dev = resolve(device)
        return CameraArrays(
            viewmatrix=torch.from_numpy(cam.world_view_transform).to(dev),
            camera_center=torch.from_numpy(cam.camera_center).to(dev))


def prefilter_voxel(state, cfg: hac.HACConfig, cam: CameraArrays,
                    rcfg: raster.RasterConfig, decoded: bool = False):
    """Anchor visibility mask [cap]."""
    return raster.visible_filter(
        hac.get_anchor(state, cfg, decoded),
        hac.get_scaling(state, decoded)[:, :3],
        state["anchors"]["rotation"],
        cam.viewmatrix, rcfg, valid=state["valid"])


def render_view(state, cfg: hac.HACConfig, cam: CameraArrays,
                rcfg: raster.RasterConfig, bg_color: torch.Tensor, *,
                decoded: bool = False) -> dict:
    visible = prefilter_voxel(state, cfg, cam, rcfg, decoded)
    ng = hac.generate_neural_gaussians(state, cfg, cam.camera_center, visible,
                                       decoded=decoded)
    img, radii = raster.rasterize(
        means3d=ng.xyz, colors=ng.color, opacities=ng.opacity,
        scales=ng.scaling, rotations=ng.rot, viewmatrix=cam.viewmatrix,
        bg_color=bg_color, cfg=rcfg, valid=ng.valid)
    return {"render": img, "radii": radii, "gaussians": ng,
            "visible_anchor": visible}


@torch.no_grad()
def render_image(state, cfg: hac.HACConfig, cam: CameraArrays,
                 rcfg: raster.RasterConfig, bg_color: torch.Tensor, *,
                 decoded: bool = False) -> torch.Tensor:
    """Eval render: [3, H, W] image only."""
    return render_view(state, cfg, cam, rcfg, bg_color, decoded=decoded)["render"]
