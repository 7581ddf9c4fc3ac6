"""Tile rasterizer for 3D Gaussian splats, eval path (counterpart of
gauspcc_tpu/render/raster.py).

  1. project: quaternion -> R, Sigma = R S S^T R^T, EWA Jacobian to a 2-D
     conic with a +0.3 px low-pass, 3-sigma radius, view culling.
  2. bin: every Gaussian emits up to D tile overlaps in a window centred
     on its projected mean, then one stable sort of packed (tile, depth)
     keys.
  3. blend: the first K entries of every tile through the CUDA tile-blend
     kernel (`tile_blend.py`), the port of the JAX package's Pallas branch.

The D-window and the K cap drop the far tail on purpose, exactly as the
JAX package does, so renders match it. The training blend (autodiff through
the XLA blend) comes with the training slice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gauspcc_tpu_torch.render import tile_blend

TILE = tile_blend.TILE


class RasterConfig(NamedTuple):
    height: int
    width: int
    tanfovx: float
    tanfovy: float
    max_tiles_per_gaussian: int = 32  # D
    max_gaussians_per_tile: int = 256  # K

    @property
    def tiles_x(self) -> int:
        return (self.width + TILE - 1) // TILE

    @property
    def tiles_y(self) -> int:
        return (self.height + TILE - 1) // TILE

    @property
    def n_tiles(self) -> int:
        return self.tiles_x * self.tiles_y


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """[N,4] (w,x,y,z) unnormalized -> [N,3,3] rotation matrices."""
    q = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + 1e-12)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(-1, 3, 3)


def covariance_3d(scales: torch.Tensor, rotations: torch.Tensor) -> torch.Tensor:
    """Sigma = R S S^T R^T, [N, 3, 3]."""
    m = quat_to_rotmat(rotations) * scales[:, None, :]
    return m @ m.transpose(1, 2)


class Projected(NamedTuple):
    mean2d: torch.Tensor  # [N, 2] pixel coords
    depth: torch.Tensor  # [N]
    conic: torch.Tensor  # [N, 3] inverse 2D covariance (a, b, c)
    radius: torch.Tensor  # [N] int32 pixel radius (0 = culled)


def project(means3d: torch.Tensor, scales: torch.Tensor,
            rotations: torch.Tensor, viewmatrix: torch.Tensor,
            cfg: RasterConfig, valid: torch.Tensor | None = None) -> Projected:
    n = means3d.shape[0]
    ones = torch.ones((n, 1), dtype=means3d.dtype, device=means3d.device)
    p_view = torch.cat([means3d, ones], -1) @ viewmatrix  # [N, 4]
    tz = p_view[:, 2]
    in_front = tz > 0.2

    # clamped perspective (reference computeCov2D frustum clamp of 1.3*tan)
    lim_x = 1.3 * cfg.tanfovx
    lim_y = 1.3 * cfg.tanfovy
    tx = torch.clamp(p_view[:, 0] / torch.clamp_min(tz, 1e-6), -lim_x, lim_x) * tz
    ty = torch.clamp(p_view[:, 1] / torch.clamp_min(tz, 1e-6), -lim_y, lim_y) * tz

    focal_x = cfg.width / (2.0 * cfg.tanfovx)
    focal_y = cfg.height / (2.0 * cfg.tanfovy)
    tz_s = torch.clamp_min(tz, 1e-6)

    zeros = torch.zeros_like(tz)
    j = torch.stack([
        focal_x / tz_s, zeros, -(focal_x * tx) / (tz_s * tz_s),
        zeros, focal_y / tz_s, -(focal_y * ty) / (tz_s * tz_s),
    ], -1).reshape(n, 2, 3)
    w = viewmatrix[:3, :3].T  # rotation part, view rows
    cov3d = covariance_3d(scales, rotations)
    t = j @ w.expand(n, 3, 3) @ cov3d @ w.T.expand(n, 3, 3) @ j.transpose(1, 2)
    cov_a = t[:, 0, 0] + 0.3
    cov_b = t[:, 0, 1]
    cov_c = t[:, 1, 1] + 0.3

    det = cov_a * cov_c - cov_b * cov_b
    det_ok = det > 0.0
    det_s = torch.where(det_ok, det, 1.0)
    conic = torch.stack([cov_c / det_s, -cov_b / det_s, cov_a / det_s], -1)

    mid = 0.5 * (cov_a + cov_c)
    lam = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lam))

    px = ((p_view[:, 0] / tz_s / cfg.tanfovx) + 1.0) * cfg.width * 0.5 - 0.5
    py = ((p_view[:, 1] / tz_s / cfg.tanfovy) + 1.0) * cfg.height * 0.5 - 0.5
    mean2d = torch.stack([px, py], -1)

    on_screen = ((px + radius > 0) & (px - radius < cfg.width)
                 & (py + radius > 0) & (py - radius < cfg.height))
    ok = in_front & det_ok & on_screen
    if valid is not None:
        ok = ok & valid
    radius = torch.where(ok, radius, 0.0).to(torch.int32)
    return Projected(mean2d=mean2d, depth=tz, conic=conic, radius=radius)


def _depth_key(depth: torch.Tensor) -> torch.Tensor:
    """Positive float depths -> monotone int32 keys (a bitcast)."""
    return torch.clamp_min(depth, 1e-6).contiguous().view(torch.int32)


def _tile_rect(proj: Projected, cfg: RasterConfig):
    """Clipped tile rectangle [x0, x1] x [y0, y1] of each footprint (floats)."""
    r = proj.radius.to(torch.float32)
    mx, my = proj.mean2d[:, 0], proj.mean2d[:, 1]
    x0 = torch.clamp(torch.floor((mx - r) / TILE), 0, cfg.tiles_x - 1)
    x1 = torch.clamp(torch.floor((mx + r) / TILE), 0, cfg.tiles_x - 1)
    y0 = torch.clamp(torch.floor((my - r) / TILE), 0, cfg.tiles_y - 1)
    y1 = torch.clamp(torch.floor((my + r) / TILE), 0, cfg.tiles_y - 1)
    return x0, x1, y0, y1


def _build_tile_lists(proj: Projected, cfg: RasterConfig):
    """Bounded duplication + sort. Returns (tile_start [T+1], pair_gauss
    [N*D] int32 sorted by (tile, depth), pair_tile [N*D])."""
    n = proj.mean2d.shape[0]
    d_max = cfg.max_tiles_per_gaussian
    dev = proj.mean2d.device
    i32 = torch.int32

    x0, x1, y0, y1 = _tile_rect(proj, cfg)
    nx = (x1 - x0 + 1).to(i32)
    ny = (y1 - y0 + 1).to(i32)
    alive = proj.radius > 0
    # Centred D-window (gauspcc_tpu/render/raster.py:179-204): a footprint
    # larger than D slots emits the window of tiles centred on the projected
    # mean; when the rect fits in D this is exactly the full rect.
    x0i, x1i, y0i, y1i = (v.to(i32) for v in (x0, x1, y0, y1))
    cx = torch.clamp(torch.floor(proj.mean2d[:, 0] / TILE), x0, x1).to(i32)
    cy = torch.clamp(torch.floor(proj.mean2d[:, 1] / TILE), y0, y1).to(i32)
    nx_w = torch.clamp_max(nx, d_max)
    rows_w = torch.minimum(ny, torch.clamp_min(
        d_max // torch.clamp_min(nx_w, 1), 1))
    x0w = torch.clamp(cx - (nx_w - 1) // 2, x0i, x1i - nx_w + 1)
    y0w = torch.clamp(cy - (rows_w - 1) // 2, y0i, y1i - rows_w + 1)
    slot = torch.arange(d_max, dtype=i32, device=dev)
    sx = slot[None, :] % torch.clamp_min(nx_w[:, None], 1)
    sy = slot[None, :] // torch.clamp_min(nx_w[:, None], 1)
    tile = (y0w[:, None] + sy) * cfg.tiles_x + x0w[:, None] + sx
    pair_ok = alive[:, None] & (slot[None, :] < nx_w[:, None] * rows_w[:, None])
    tile = torch.where(pair_ok, tile, cfg.n_tiles)  # overflow bucket at end

    # one int32 sort over packed keys: tile in the top bits, the top 18 bits
    # of the positive-float depth below; stable, so equal keys keep the
    # Gaussian order, as lax.sort_key_val does
    if cfg.n_tiles >= (1 << 13) - 1:
        raise ValueError("image too large for the packed tile key")
    pair_tile = tile.reshape(-1)
    pair_gauss = torch.arange(n, dtype=i32, device=dev)[:, None].expand(
        n, d_max).reshape(-1)
    depth18 = _depth_key(proj.depth) >> 13
    pair_depth = depth18[:, None].expand(n, d_max).reshape(-1)
    key = (pair_tile << 18) | pair_depth
    skey, order = torch.sort(key, stable=True)
    pg = pair_gauss[order]
    pt = skey >> 18
    tile_start = torch.searchsorted(
        pt, torch.arange(cfg.n_tiles + 1, dtype=i32, device=dev), out_int32=True)
    return tile_start, pg, pt


def rasterize(means3d: torch.Tensor, colors: torch.Tensor,
              opacities: torch.Tensor, scales: torch.Tensor,
              rotations: torch.Tensor, viewmatrix: torch.Tensor,
              bg_color: torch.Tensor, cfg: RasterConfig,
              valid: torch.Tensor | None = None):
    """Eval render. Returns (image [3, H, W], radii [N])."""
    proj = project(means3d, scales, rotations, viewmatrix, cfg, valid)
    tile_start, pair_gauss, _ = _build_tile_lists(proj, cfg)
    img = tile_blend.blend_tiles(
        tile_start, pair_gauss, proj.mean2d, proj.conic, opacities.reshape(-1),
        colors, bg_color, tiles_x=cfg.tiles_x, height=cfg.height,
        width=cfg.width, max_k=cfg.max_gaussians_per_tile)
    return img, proj.radius


def _footprints(proj: Projected, cfg: RasterConfig) -> torch.Tensor:
    """Per-Gaussian clipped tile-footprint counts [N] (0 for culled)."""
    x0, x1, y0, y1 = _tile_rect(proj, cfg)
    fp = ((x1 - x0 + 1) * (y1 - y0 + 1)).to(torch.int32)
    return torch.where(proj.radius > 0, fp, 0)


def max_tile_footprint(means3d, scales, rotations, viewmatrix,
                       cfg: RasterConfig, valid=None) -> torch.Tensor:
    """Largest clipped tile footprint of any visible Gaussian: any D at or
    above it renders exactly as an unbounded D."""
    proj = project(means3d, scales, rotations, viewmatrix, cfg, valid)
    return _footprints(proj, cfg).max()


def visible_filter(means3d, scales, rotations, viewmatrix, cfg: RasterConfig,
                   valid=None) -> torch.Tensor:
    """radii > 0 visibility mask (used by prefilter_voxel)."""
    return project(means3d, scales, rotations, viewmatrix, cfg, valid).radius > 0
