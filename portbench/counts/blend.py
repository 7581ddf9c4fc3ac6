"""The work of one tile blend and of its gradient on given inputs, and its
least time on one H100 (the K1 rooflines).

Frozen copies of chip_smoke.py:344-378 (the peaks and per-entry operation
counts), :726-780 (`entries_per_tile`, `entries_evaluated`,
`blend_bound`) and :802-855 (`warp_records`, `backward_bound`). Departures:
the pixel-entries come from the benchmark's plain blend
(reference/raster.py `tile_gather`, `alpha_terms`) instead of the port's
`tile_blend._alpha_chunks` (the same function); the results are returned
as dicts with the operations, bytes and entries beside the bound; the
backward's bytes leave out chip_smoke's atomics term (`warp_records`, 36
bytes per warp and record), which is what one kernel's layout costs and
not what the gradient needs; the operations are charged to the blended
pixel-entries only (alpha >= 1/255 before the pixel's transmittance drops
below 1e-4): an entry whose Gaussian does not reach the pixel contributes
nothing, and a kernel may cull it for a whole block of pixels at once, so
charging its evaluation to every pixel counted more than the function
needs (on an H100 the backward kernel takes less time than that count at
the peak would).

What is counted is the work the blend needs on these inputs, whatever a
kernel does: each input byte read once, each output written once, and the
operations of the pixel-entries that contribute to the image. An FMA
counts as one operation against a peak that counts it as two, so the
count errs low.
"""

from __future__ import annotations

import torch

from portbench.reference import raster

PEAK_FP32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
# fp32 operations per pixel-entry: evaluating it (offsets 2, quadratic form
# 8, clamp + exp + opacity + cap + threshold 5), and, only for an entry with
# alpha >= 1/255, blending it (weight, 3 FMAs, transmittance, test)
EVAL_OPS_PER_ENTRY = 15
BLEND_OPS_PER_ENTRY = 10
# gradient operations per blended pixel-entry (chip_smoke.py:371-376)
BWD_OPS_PER_BLENDED = 45


def _chunks(tile_start, pair_gauss, mean2d, conic, opacity, tiles_x, max_k):
    n_tiles = tile_start.shape[0] - 1
    for c0 in range(0, n_tiles, raster.TILE_CHUNK):
        c1 = min(c0 + raster.TILE_CHUNK, n_tiles)
        gidx, gmask = raster.tile_gather(tile_start, pair_gauss, c0, c1, max_k)
        alpha, t_before, _ = raster.alpha_terms(
            c0, c1, tiles_x, gmask, mean2d[gidx], conic[gidx], opacity[gidx])
        yield alpha, t_before


@torch.no_grad()
def entries_evaluated(tile_start, pair_gauss, mean2d, conic, opacity, *,
                      tiles_x: int, max_k: int) -> tuple[int, int]:
    """(evaluated, blended) pixel-entries: for each pixel the entries of its
    tile (at most max_k) whose transmittance before them is still >= 1e-4,
    and of those the ones with alpha >= 1/255."""
    evaluated = blended = 0
    for alpha, t_before in _chunks(tile_start, pair_gauss, mean2d, conic,
                                   opacity.reshape(-1), tiles_x, max_k):
        live = t_before >= raster.T_MIN
        evaluated += int(live.sum())
        blended += int((live & (alpha > 0)).sum())
    return evaluated, blended


def _list_records(tile_start, pair_gauss, max_k: int) -> tuple[int, int]:
    """(list entries blended, distinct Gaussians they name)."""
    counts = (tile_start[1:] - tile_start[:-1]).clamp_max(max_k).long()
    starts = tile_start[:-1].long()
    n_entries = int(counts.sum())
    first = torch.repeat_interleave(counts.cumsum(0) - counts, counts)
    idx = torch.repeat_interleave(starts, counts) + (
        torch.arange(n_entries, device=counts.device) - first)
    return n_entries, int(pair_gauss[idx].unique().numel())


def _bound(ops: int, n_bytes: int) -> dict:
    ops_ms = ops / PEAK_FP32_FLOPS * 1e3
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms), "ops": ops, "bytes": n_bytes,
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


@torch.no_grad()
def blend_bound(tile_start, pair_gauss, mean2d, conic, opacity, *, tiles_x,
                height, width, max_k) -> dict:
    """The forward's least time: the tile starts, the list entries blended
    and the records of the Gaussians they name read once, the image
    written once; the operations of the pixel-entries evaluated and
    blended."""
    n_entries, n_records = _list_records(tile_start, pair_gauss, max_k)
    n_bytes = (4 * tile_start.numel() + 4 * n_entries + 36 * n_records + 12
               + 12 * height * width)
    evaluated, blended = entries_evaluated(
        tile_start, pair_gauss, mean2d, conic, opacity, tiles_x=tiles_x,
        max_k=max_k)
    out = _bound((EVAL_OPS_PER_ENTRY + BLEND_OPS_PER_ENTRY) * blended, n_bytes)
    out.update(evaluated=evaluated, blended=blended)
    return out


@torch.no_grad()
def backward_bound(tile_start, pair_gauss, mean2d, conic, opacity, *,
                   tiles_x, height, width, max_k) -> dict:
    """The gradient's least time: the tile starts, list entries, records,
    the image and its gradient read once, the records' gradients written
    once; the operations of the alpha recompute per evaluated pixel-entry and of the
    gradient per blended one."""
    n_entries, n_records = _list_records(tile_start, pair_gauss, max_k)
    n_bytes = (4 * tile_start.numel() + 4 * n_entries + 36 * n_records
               + 24 * height * width + 36 * n_records)
    evaluated, blended = entries_evaluated(
        tile_start, pair_gauss, mean2d, conic, opacity, tiles_x=tiles_x,
        max_k=max_k)
    out = _bound((EVAL_OPS_PER_ENTRY + BWD_OPS_PER_BLENDED) * blended, n_bytes)
    out.update(evaluated=evaluated, blended=blended)
    return out
