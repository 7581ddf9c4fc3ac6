"""Procedural soak scene (own copy of gauspcc_tpu/cli/soak.py:37-130,
"textured" kind): clustered coloured Gaussians rendered from orbit cameras
with the port's rasterizer as ground truth, plus seed points for the anchors.

The numpy RNG calls run in the same order as the JAX package's
build_scene, so one seed gives the same Gaussians, cameras and seed points
in both.
"""

from __future__ import annotations

import numpy as np
import torch

from gauspcc_tpu_torch.data.cameras import Camera
from gauspcc_tpu_torch.device import resolve
from gauspcc_tpu_torch.render import raster


class SyntheticScene:
    """train_cameras / test_cameras / points / cameras_extent."""

    def __init__(self, cams_train, cams_test, points, extent):
        self.train_cameras = cams_train
        self.test_cameras = cams_test
        self.points = points
        self.cameras_extent = extent


def _orbit_camera(uid, angle, hw, radius=4.0, height=0.6, fov=0.9):
    pos = np.array([radius * np.cos(angle), height, radius * np.sin(angle)])
    fwd = -pos / np.linalg.norm(pos)
    up0 = np.array([0.0, 1.0, 0.0])
    right = np.cross(up0, fwd)
    right /= np.linalg.norm(right)
    up = np.cross(fwd, right)
    r_w2v = np.stack([right, up, fwd])
    t = -r_w2v @ pos
    return Camera(uid=uid, R=r_w2v.T, T=t, fovx=fov, fovy=fov,
                  width=hw, height=hw)


@torch.no_grad()
def build_scene(rng: np.random.Generator, hw: int, n_gt: int, n_cams: int,
                n_seed: int, white_background: bool = True,
                device="cuda") -> SyntheticScene:
    dev = resolve(device)
    # clustered coloured Gaussian field: smooth colour plus mid-frequency
    # texture that only per-anchor features can carry
    n_clusters = max(8, n_gt // 150)
    centers = rng.random((n_clusters, 3)) * 1.6 - 0.8
    idx = rng.integers(0, n_clusters, n_gt)
    means = (centers[idx] + rng.normal(0, 0.12, (n_gt, 3))).astype(np.float32)
    lo_f = np.array([[2.1, 0.7, 1.3], [0.9, 2.4, 1.7], [1.5, 1.1, 2.6]])
    hi_f = np.array([[5.3, 7.1, 4.2], [6.7, 3.9, 5.8], [4.4, 6.1, 7.3]])
    phases = np.array([0.0, 2.1, 4.2])
    colors = (0.5 + 0.27 * np.sin(means @ lo_f.T + phases)
              + 0.18 * np.sin(means @ hi_f.T + 1.3 * phases + 0.7))
    colors = np.clip(colors, 0.0, 1.0).astype(np.float32)
    scales = (rng.random((n_gt, 3)) * 0.06 + 0.03).astype(np.float32)
    opac = (rng.random((n_gt, 1)) * 0.45 + 0.5).astype(np.float32)
    rots = np.tile([1.0, 0, 0, 0], (n_gt, 1)).astype(np.float32)

    gt = {name: torch.from_numpy(v).to(dev) for name, v in (
        ("means3d", means), ("colors", colors), ("opacities", opac),
        ("scales", scales), ("rotations", rots))}
    bg = torch.full((3,), 1.0 if white_background else 0.0, device=dev)
    cams = []
    for i, ang in enumerate(np.linspace(0, 2 * np.pi, n_cams, endpoint=False)):
        c = _orbit_camera(i, ang, hw, radius=3.5 + 0.6 * np.sin(3 * ang),
                          height=0.4 + 0.5 * np.cos(2 * ang))
        rcfg = raster.RasterConfig(hw, hw, c.tanfovx, c.tanfovy,
                                   max_gaussians_per_tile=256)
        img, _ = raster.rasterize(
            viewmatrix=torch.from_numpy(c.world_view_transform).to(dev),
            bg_color=bg, cfg=rcfg, **gt)
        c.image = img.cpu().numpy()
        cams.append(c)

    sel = rng.integers(0, n_gt, n_seed)
    seed_pts = means[sel] + rng.normal(0, 0.02, (n_seed, 3)).astype(np.float32)
    extent = float(np.linalg.norm(
        np.ptp(np.stack([c.camera_center for c in cams]), axis=0)) * 0.5)
    # interleaved holdout (llffhold = 8): every 8th orbit view is a test view
    hold = 8
    test = [c for i, c in enumerate(cams) if i % hold == 0]
    train = [c for i, c in enumerate(cams) if i % hold != 0]
    return SyntheticScene(train, test, seed_pts.astype(np.float32), extent)
