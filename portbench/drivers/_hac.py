"""What the `hac` drivers share: the seeded scene and state handed to the
program (gauspcc_tpu_torch) and, as copies, to the plain reference, and the
records a traced window keeps of the program's blends."""

from __future__ import annotations

import contextlib

import torch

from portbench.reference import hac as ref
from portbench.traffic import hac_scene


class Inputs:
    """The scene, the anchors and the leaves of one seed: the benchmark's
    own, handed to both sides."""

    def __init__(self, cell, seed: int, device, with_frames: bool):
        conf = cell.config
        self.shape = ref.HACShape.from_config(conf)
        sc = conf["scene"]
        self.white = bool(cell.traffic.get("white_background", True))
        self.geo = hac_scene.scene_geometry(seed, sc["resolution"], sc["n_gt"],
                                            sc["n_cams"], sc["n_seed_points"],
                                            sc["structure_seed"])
        self.device = torch.device(device)
        self.frames = (hac_scene.gt_frames(self.geo, self.device, self.white)
                       if with_frames else None)
        self.points = hac_scene.anchors(self.geo, self.shape.voxel_size, seed)
        self.leaves, self.rest = hac_scene.make_leaves(
            self.shape, self.points, seed, self.device)
        self.cap = self.rest["valid"].shape[0]

    def ref_camera(self, cam, frame=None) -> ref.Camera:
        return ref.Camera(torch.from_numpy(cam.viewmatrix).to(self.device),
                          torch.from_numpy(cam.camera_center).to(self.device),
                          frame)


def program_state(inp: Inputs, conf: dict):
    """The program's HAC state from the benchmark's leaves (copies), its
    context box fitted by the program as train_scene does on entering phase
    2, and its config."""
    from gauspcc_tpu_torch.models.hac import model as hac

    m = conf["model"]
    cfg = hac.HACConfig(
        feat_dim=m["feat_dim"], n_offsets=m["n_offsets"],
        voxel_size=m["voxel_size"],
        n_features_per_level=m["n_features_per_level"],
        log2_hashmap_size=m["log2_hashmap_size"],
        log2_hashmap_size_2d=m["log2_hashmap_size_2d"],
        resolutions_3d=tuple(m["resolutions_3d"]),
        resolutions_2d=tuple(m["resolutions_2d"]),
        q_feat=m["q_feat"], q_scaling=m["q_scaling"], q_offsets=m["q_offsets"])
    nets = hac.HACNets(cfg).to(inp.device)
    with torch.no_grad():
        for name, p in nets.named_parameters():
            p.copy_(inp.leaves["nets/" + name.replace(".", "/")])
    a = {f: inp.leaves[f"anchors/{f}"].clone()
         for f in ("offset", "mask", "anchor_feat", "scaling")}
    a.update(anchor=inp.rest["anchor"].clone(),
             rotation=inp.rest["rotation"].clone(),
             opacity=inp.rest["opacity"].clone())
    state = {"anchors": a, "valid": inp.rest["valid"].clone(), "nets": nets,
             "x_bound_min": torch.zeros((1, 3), device=inp.device),
             "x_bound_max": torch.ones((1, 3), device=inp.device)}
    return hac.update_anchor_bound(state), cfg


def program_camera(cam, device, frame=None):
    from gauspcc_tpu_torch.models.hac import render as hac_render

    return hac_render.CameraArrays(
        viewmatrix=torch.from_numpy(cam.viewmatrix).to(device),
        camera_center=torch.from_numpy(cam.camera_center).to(device),
        image=frame)


def program_raster(cam, max_k: int = 256, max_d: int = 32):
    from gauspcc_tpu_torch.render import raster

    return raster.RasterConfig(cam.hw, cam.hw, cam.tanfov, cam.tanfov,
                               max_tiles_per_gaussian=max_d,
                               max_gaussians_per_tile=max_k)


@contextlib.contextmanager
def record_blends(limit: int, records: dict):
    """Keep the inputs of the program's first `limit` forward blends (and
    the backward blends that follow them) and the anchors each render
    found visible, by holding references: no device work is added. The
    program's own functions run unchanged underneath."""
    from gauspcc_tpu_torch.models.hac import render as hac_render
    from gauspcc_tpu_torch.render import tile_blend

    fwd0, bwd0, vis0 = (tile_blend.blend_tiles, tile_blend.blend_tiles_backward,
                        hac_render.prefilter_voxel)
    records.setdefault("forward", [])
    records.setdefault("backward", [])
    records.setdefault("visible", [])

    def fwd(tile_start, pair_gauss, mean2d, conic, opacity, colors, bg, **kw):
        if len(records["forward"]) < limit:
            records["forward"].append((tile_start, pair_gauss, mean2d.detach(),
                                       conic.detach(), opacity.detach(), kw))
        return fwd0(tile_start, pair_gauss, mean2d, conic, opacity, colors, bg,
                    **kw)

    def bwd(tile_start, pair_gauss, mean2d, conic, opacity, *a, **kw):
        if len(records["backward"]) < len(records["forward"]) <= limit:
            records["backward"].append((tile_start, pair_gauss, mean2d,
                                        conic, opacity, kw))
        return bwd0(tile_start, pair_gauss, mean2d, conic, opacity, *a, **kw)

    def vis(*a, **kw):
        out = vis0(*a, **kw)
        if len(records["visible"]) < limit:
            records["visible"].append(out)
        return out

    tile_blend.blend_tiles, tile_blend.blend_tiles_backward = fwd, bwd
    hac_render.prefilter_voxel = vis
    try:
        yield records
    finally:
        tile_blend.blend_tiles, tile_blend.blend_tiles_backward = fwd0, bwd0
        hac_render.prefilter_voxel = vis0
