"""Plain tile rasterizer of 3D Gaussian splats: projection, tile lists and
the per-tile alpha blend, in float32 PyTorch operations.

Frozen copy of the port's plain path, so that the benchmark's yardstick
does not move with the program:

- `project`, `_build_tile_lists`, `tile_saturation`, `max_tile_footprint`:
  gauspcc_tpu_torch/render/raster.py:78-210 and :235-258, unchanged but for
  the names.
- `_alpha_chunks`, `blend`: gauspcc_tpu_torch/render/tile_blend.py:434-486
  (`blend_tiles_reference`, `_alpha_chunks`), the function the port's CUDA
  kernel computes: every entry of a tile up to K, no early stop, alpha
  clipped at 0.99 and dropped below 1/255, transmittance as an exclusive
  prefix sum of log(1 - alpha). Departure: the gradient is taken chunk by
  chunk (`_PlainBlend.backward` recomputes each chunk of tiles under
  autograd), so a 1024x1024 frame at K 1024 fits in memory; the arithmetic
  is autograd of the same chunk, so the gradient is the same function's.

Imports nothing of the program.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

TILE = 16
PIX = TILE * TILE
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_MIN = 1e-4
TILE_CHUNK = 64  # tiles per chunk: bounds the [C, 256, K] temporaries


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
    q = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + 1e-12)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(-1, 3, 3)


class Projected(NamedTuple):
    mean2d: torch.Tensor
    depth: torch.Tensor
    conic: torch.Tensor
    radius: torch.Tensor


def project(means3d, scales, rotations, viewmatrix, cfg: RasterConfig,
            valid=None) -> Projected:
    n = means3d.shape[0]
    ones = torch.ones((n, 1), dtype=means3d.dtype, device=means3d.device)
    p_view = torch.cat([means3d, ones], -1) @ viewmatrix
    tz = p_view[:, 2]
    in_front = tz > 0.2
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
    w = viewmatrix[:3, :3].T
    m = quat_to_rotmat(rotations) * scales[:, None, :]
    cov3d = m @ m.transpose(1, 2)
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


def _tile_rect(proj: Projected, cfg: RasterConfig):
    r = proj.radius.to(torch.float32)
    mx, my = proj.mean2d[:, 0], proj.mean2d[:, 1]
    x0 = torch.clamp(torch.floor((mx - r) / TILE), 0, cfg.tiles_x - 1)
    x1 = torch.clamp(torch.floor((mx + r) / TILE), 0, cfg.tiles_x - 1)
    y0 = torch.clamp(torch.floor((my - r) / TILE), 0, cfg.tiles_y - 1)
    y1 = torch.clamp(torch.floor((my + r) / TILE), 0, cfg.tiles_y - 1)
    return x0, x1, y0, y1


def build_tile_lists(proj: Projected, cfg: RasterConfig):
    """(tile_start [T + 1], pair_gauss [N * D]) sorted by (tile, depth),
    each footprint cut to the D-window centred on its mean."""
    n = proj.mean2d.shape[0]
    d_max = cfg.max_tiles_per_gaussian
    dev = proj.mean2d.device
    i32 = torch.int32
    x0, x1, y0, y1 = _tile_rect(proj, cfg)
    nx = (x1 - x0 + 1).to(i32)
    ny = (y1 - y0 + 1).to(i32)
    alive = proj.radius > 0
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
    tile = torch.where(pair_ok, tile, cfg.n_tiles)
    if cfg.n_tiles >= (1 << 13) - 1:
        raise ValueError("image too large for the packed tile key")
    pair_tile = tile.reshape(-1)
    pair_gauss = torch.arange(n, dtype=i32, device=dev)[:, None].expand(
        n, d_max).reshape(-1)
    depth18 = torch.clamp_min(proj.depth, 1e-6).contiguous().view(i32) >> 13
    pair_depth = depth18[:, None].expand(n, d_max).reshape(-1)
    key = (pair_tile << 18) | pair_depth
    skey, order = torch.sort(key, stable=True)
    pg = pair_gauss[order]
    pt = skey >> 18
    tile_start = torch.searchsorted(
        pt, torch.arange(cfg.n_tiles + 1, dtype=i32, device=dev), out_int32=True)
    return tile_start, pg


def _footprints(proj: Projected, cfg: RasterConfig) -> torch.Tensor:
    x0, x1, y0, y1 = _tile_rect(proj, cfg)
    fp = ((x1 - x0 + 1) * (y1 - y0 + 1)).to(torch.int32)
    return torch.where(proj.radius > 0, fp, 0)


def max_tile_footprint(means3d, scales, rotations, viewmatrix,
                       cfg: RasterConfig, valid=None) -> torch.Tensor:
    proj = project(means3d, scales, rotations, viewmatrix, cfg, valid)
    return _footprints(proj, cfg).max()


def tile_saturation(means3d, scales, rotations, viewmatrix,
                    cfg: RasterConfig, valid=None) -> dict:
    proj = project(means3d, scales, rotations, viewmatrix, cfg, valid)
    tile_start, _ = build_tile_lists(proj, cfg)
    counts = tile_start[1:] - tile_start[:-1]
    footprint = _footprints(proj, cfg)
    alive = proj.radius > 0
    n_alive = torch.clamp_min(alive.sum(), 1)
    occupied = torch.clamp_min((counts > 0).sum(), 1)
    return {
        "frac_tiles_over_k": (counts > cfg.max_gaussians_per_tile).sum() / occupied,
        "frac_gauss_over_d": (alive & (footprint > cfg.max_tiles_per_gaussian)
                              ).sum() / n_alive,
        "max_tile_count": counts.max(),
    }


def tile_gather(tile_start, pair_gauss, c0: int, c1: int, max_k: int):
    """(gidx [C, K] long, gmask [C, K] bool) of tiles c0..c1: the first
    min(count, K) entries of each tile's list."""
    dev = tile_start.device
    slot = torch.arange(max_k, device=dev)
    tids = torch.arange(c0, c1, device=dev)
    starts = tile_start[tids].long()
    take = torch.clamp_max(tile_start[tids + 1].long() - starts, max_k)
    gmask = slot[None, :] < take[:, None]
    n_pairs = pair_gauss.shape[0]
    if n_pairs:
        gidx = pair_gauss[torch.clamp(starts[:, None] + slot[None, :], 0,
                                      n_pairs - 1)].long()
    else:
        gidx = torch.zeros((c1 - c0, max_k), dtype=torch.long, device=dev)
        gmask = torch.zeros_like(gmask)
    return gidx, gmask


def alpha_terms(c0: int, c1: int, tiles_x: int, gmask, g_mean, g_conic, g_opa):
    """(alpha, t_before, log1ma), each [C, 256, K], of tiles c0..c1 from
    their gathered records; entries past a tile's count have alpha 0 and
    t_before 0."""
    dev = g_mean.device
    pix = torch.arange(PIX, device=dev)
    pxo = (pix % TILE).to(torch.float32)
    pyo = (pix // TILE).to(torch.float32)
    tids = torch.arange(c0, c1, device=dev)
    ppx = ((tids % tiles_x) * TILE).to(torch.float32)[:, None] + pxo[None, :]
    ppy = ((tids // tiles_x) * TILE).to(torch.float32)[:, None] + pyo[None, :]
    dx = ppx[:, :, None] - g_mean[:, None, :, 0]
    dy = ppy[:, :, None] - g_mean[:, None, :, 1]
    power = -0.5 * (g_conic[:, None, :, 0] * dx * dx
                    + g_conic[:, None, :, 2] * dy * dy
                    ) - g_conic[:, None, :, 1] * dx * dy
    alpha = torch.clamp_max(
        g_opa[:, None, :] * torch.exp(torch.clamp_max(power, 0.0)), ALPHA_MAX)
    alpha = torch.where(gmask[:, None, :] & (alpha >= ALPHA_MIN), alpha, 0.0)
    log1ma = torch.log1p(-alpha)
    t_before = torch.exp(torch.cumsum(F.pad(log1ma[..., :-1], (1, 0)), -1))
    t_before = torch.where(gmask[:, None, :], t_before, 0.0)
    return alpha, t_before, log1ma


def _chunk_rgb(c0, c1, tiles_x, gmask, g_mean, g_conic, g_opa, g_col, bg):
    alpha, t_before, log1ma = alpha_terms(c0, c1, tiles_x, gmask, g_mean,
                                          g_conic, g_opa)
    w = torch.where(t_before >= T_MIN, alpha * t_before, 0.0)
    rgb = torch.einsum("cpk,ckr->cpr", w, g_col)
    t_final = torch.exp(log1ma.sum(-1))
    return rgb + t_final[:, :, None] * bg


def tiles_to_image(tiles, tiles_x: int, height: int, width: int):
    tiles_y = tiles.shape[0] // tiles_x
    img = tiles.reshape(tiles_y, tiles_x, TILE, TILE, 3).permute(0, 2, 1, 3, 4)
    img = img.reshape(tiles_y * TILE, tiles_x * TILE, 3)[:height, :width]
    return img.permute(2, 0, 1).contiguous()


def _image_to_tiles(img, tiles_x: int, tiles_y: int):
    _, h, w = img.shape
    img = F.pad(img, (0, tiles_x * TILE - w, 0, tiles_y * TILE - h))
    return img.permute(1, 2, 0).reshape(tiles_y, TILE, tiles_x, TILE, 3
                                        ).permute(0, 2, 1, 3, 4).reshape(
        tiles_y * tiles_x, PIX, 3)


class _PlainBlend(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mean2d, conic, opacity, colors, bg, tile_start,
                pair_gauss, kw):
        n_tiles = tile_start.shape[0] - 1
        tiles = torch.empty((n_tiles, PIX, 3), dtype=torch.float32,
                            device=mean2d.device)
        for c0 in range(0, n_tiles, TILE_CHUNK):
            c1 = min(c0 + TILE_CHUNK, n_tiles)
            gidx, gmask = tile_gather(tile_start, pair_gauss, c0, c1, kw["max_k"])
            tiles[c0:c1] = _chunk_rgb(c0, c1, kw["tiles_x"], gmask, mean2d[gidx],
                                      conic[gidx], opacity[gidx], colors[gidx], bg)
        ctx.save_for_backward(mean2d, conic, opacity, colors, bg, tile_start,
                              pair_gauss)
        ctx.kw = kw
        return tiles_to_image(tiles, kw["tiles_x"], kw["height"], kw["width"])

    @staticmethod
    def backward(ctx, grad_img):
        mean2d, conic, opacity, colors, bg, tile_start, pair_gauss = ctx.saved_tensors
        kw = ctx.kw
        n_tiles = tile_start.shape[0] - 1
        g_tiles = _image_to_tiles(grad_img, kw["tiles_x"], n_tiles // kw["tiles_x"])
        grads = [torch.zeros_like(t) for t in (mean2d, conic, opacity, colors)]
        for c0 in range(0, n_tiles, TILE_CHUNK):
            c1 = min(c0 + TILE_CHUNK, n_tiles)
            gidx, gmask = tile_gather(tile_start, pair_gauss, c0, c1, kw["max_k"])
            leaves = [t[gidx].detach().requires_grad_(True)
                      for t in (mean2d, conic, opacity, colors)]
            with torch.enable_grad():
                rgb = _chunk_rgb(c0, c1, kw["tiles_x"], gmask, *leaves, bg)
                got = torch.autograd.grad(rgb, leaves, g_tiles[c0:c1])
            flat = gidx.reshape(-1)
            for dst, g in zip(grads, got):
                dst.index_add_(0, flat, g.reshape((flat.shape[0],) + dst.shape[1:]))
        return (*grads, None, None, None, None)


def blend(tile_start, pair_gauss, mean2d, conic, opacity, colors, bg, *,
          tiles_x: int, height: int, width: int, max_k: int) -> torch.Tensor:
    """The tiles' alpha blend -> image [3, H, W], differentiable in mean2d,
    conic, opacity and colors."""
    kw = dict(tiles_x=tiles_x, height=height, width=width, max_k=max_k)
    return _PlainBlend.apply(mean2d, conic, opacity.reshape(-1), colors, bg,
                             tile_start, pair_gauss, kw)


def rasterize(means3d, colors, opacities, scales, rotations, viewmatrix,
              bg_color, cfg: RasterConfig, valid=None):
    """(image [3, H, W], radii [N])."""
    proj = project(means3d, scales, rotations, viewmatrix, cfg, valid)
    with torch.no_grad():
        tile_start, pair_gauss = build_tile_lists(proj, cfg)
    img = blend(tile_start, pair_gauss, proj.mean2d, proj.conic,
                opacities.reshape(-1), colors, bg_color, tiles_x=cfg.tiles_x,
                height=cfg.height, width=cfg.width,
                max_k=cfg.max_gaussians_per_tile)
    return img, proj.radius
