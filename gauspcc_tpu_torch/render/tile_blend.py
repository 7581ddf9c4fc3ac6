"""Per-tile alpha blend: the hand-written CUDA kernel and its plain version.

Counterpart of `gauspcc_tpu/render/pallas_blend.py` (`_blend_kernel` :46,
`blend_tiles` :92) plus the record gather of `gauspcc_tpu/render/raster.py`
:317-342. The kernel (`csrc/tile_blend.cu`) gathers each tile's records
itself from the per-Gaussian arrays and writes the image `[3, H, W]`.

`blend_tiles` launches the kernel for CUDA tensors and raises if it cannot;
it takes the plain version `blend_tiles_reference` only for CPU tensors.
The plain version computes the same function the way the JAX package does
(exclusive prefix sum of log(1 - alpha), no early stop), so it is also the
oracle the kernel is held against on the card.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from gauspcc_tpu_torch import native

TILE = 16
PIX = TILE * TILE
ALPHA_MIN = 1.0 / 255.0
T_MIN = 1e-4
_REF_TILE_CHUNK = 64  # tiles per step of the plain version: bounds its [C, 256, K] temporaries
ORDER_BUCKETS = 64  # list-length buckets of the kernel's tile schedule
SCHED_SM_IDS = 1024  # per-SM rank counters in the schedule's scratch

# Number of kernel launches made by `blend_tiles`: one per call of the C
# entry, which launches the schedule's order_kernel and then blend_kernel.
# Callers reset it to 0 to count the launches of one run.
launches = 0


def kernel_tolerance(bg: torch.Tensor, colors: torch.Tensor) -> tuple[float, float]:
    """(rtol, atol) of the kernel against `blend_tiles_reference`.

    rtol 2e-4 / atol 2e-5 cover float32 reordering (the kernel multiplies
    transmittances in sequence, the plain version sums logs), as the JAX
    package's own Pallas test states. The kernel stops a pixel once
    T < 1e-4, which changes its background term by less than 1e-4 * max(bg);
    an entry whose T_before sits within rounding of 1e-4 may be kept by one
    side and dropped by the other, which moves the pixel by less than
    1e-4 * max(color)."""
    peak = max(float(bg.abs().max()), float(colors.abs().max()) if colors.numel() else 0.0)
    return 2e-4, 2e-5 + T_MIN * peak


def _check_inputs(tile_start, pair_gauss, mean2d, conic, opacity, colors, bg,
                  tiles_x, height, width, max_k):
    n = mean2d.shape[0]
    shapes = {
        "mean2d": (mean2d, (n, 2), torch.float32),
        "conic": (conic, (n, 3), torch.float32),
        "opacity": (opacity, (n,), torch.float32),
        "colors": (colors, (n, 3), torch.float32),
        "bg": (bg, (3,), torch.float32),
        "tile_start": (tile_start, (tile_start.shape[0],), torch.int32),
        "pair_gauss": (pair_gauss, (pair_gauss.shape[0],), torch.int32),
    }
    for name, (t, shape, dtype) in shapes.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != mean2d.device:
            raise ValueError(f"{name} is on {t.device}, mean2d on {mean2d.device}")
    n_tiles = tile_start.shape[0] - 1
    if n_tiles < 0 or tiles_x <= 0 or n_tiles % tiles_x:
        raise ValueError(f"{n_tiles} tiles do not fill rows of {tiles_x}")
    tiles_y = n_tiles // tiles_x
    if tiles_x * TILE < width or tiles_y * TILE < height:
        raise ValueError(f"{tiles_x}x{tiles_y} tiles do not cover {width}x{height}")
    if max_k <= 0:
        raise ValueError(f"max_k must be positive, got {max_k}")
    return n_tiles


def schedule_words(n_tiles: int) -> int:
    """int32 words of the kernel's schedule scratch for `n_tiles` tiles:
    the counter of the sorted walk, the tiles longest first, each tile's
    claim, and the per-SM rank counters."""
    return 1 + 2 * n_tiles + SCHED_SM_IDS


def _library():
    lib = native.load("tile_blend").lib
    if lib.tile_blend_forward.argtypes is None:
        # every pointer and the stream as c_void_p: ctypes would otherwise
        # pass them as 32-bit ints and cut them
        lib.tile_blend_forward.argtypes = [ctypes.c_void_p] * 7 + [
            ctypes.c_int] * 5 + [ctypes.c_void_p] * 3
        lib.tile_blend_forward.restype = ctypes.c_int
        lib.tile_blend_launch_shape.argtypes = [ctypes.c_int, ctypes.c_void_p]
        lib.tile_blend_launch_shape.restype = ctypes.c_int
    return lib


def launch_shape(n_tiles: int) -> dict:
    """The blend launch on the current card: blocks, threads, pixels per
    thread, static shared bytes, resident blocks per SM and registers per
    thread."""
    shape = (ctypes.c_int * 6)()
    rc = _library().tile_blend_launch_shape(n_tiles, ctypes.addressof(shape))
    if rc != 0:
        raise RuntimeError(f"tile_blend launch shape failed: CUDA error {rc}")
    return dict(zip(("blocks", "threads", "pix_per_thread", "shared_bytes",
                     "blocks_per_sm", "registers"), shape))


def _launch(args, sched: torch.Tensor, *, tiles_x: int, height: int,
            width: int, max_k: int) -> torch.Tensor:
    """One call of the C entry on CUDA tensors (the schedule's order, then
    the blend) -> image [3, H, W]; raises if a launch is refused. `sched`
    is the schedule's scratch, int32 [schedule_words(T)]. Counts no
    launch: `blend_tiles` does."""
    n_tiles = args[0].shape[0] - 1
    args = [t.contiguous() for t in args]
    dev = args[2].device
    out = torch.empty((3, height, width), dtype=torch.float32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.tile_blend_forward(
            *[t.data_ptr() for t in args], n_tiles, tiles_x, height, width,
            max_k, sched.data_ptr(), out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"tile_blend kernel launch failed: CUDA error {rc}")
    return out


def blend_tiles(tile_start: torch.Tensor, pair_gauss: torch.Tensor,
                mean2d: torch.Tensor, conic: torch.Tensor,
                opacity: torch.Tensor, colors: torch.Tensor, bg: torch.Tensor,
                *, tiles_x: int, height: int, width: int, max_k: int
                ) -> torch.Tensor:
    """Blend every tile's first min(count, max_k) entries -> image [3, H, W].

    tile_start [T + 1] int32 and pair_gauss [P] int32 are the sorted tile
    lists of `raster._build_tile_lists`; mean2d [N, 2], conic [N, 3],
    opacity [N], colors [N, 3] and bg [3] are float32."""
    global launches
    args = (tile_start, pair_gauss, mean2d, conic, opacity, colors, bg)
    kw = dict(tiles_x=tiles_x, height=height, width=width, max_k=max_k)
    if mean2d.device.type == "cpu":
        return blend_tiles_reference(*args, **kw)
    if mean2d.device.type != "cuda":
        raise ValueError(f"tile_blend runs on CUDA or CPU, not {mean2d.device}")
    n_tiles = _check_inputs(*args, tiles_x, height, width, max_k)
    sched = torch.empty(schedule_words(n_tiles), dtype=torch.int32,
                        device=mean2d.device)
    out = _launch(args, sched, **kw)
    launches += 1
    return out


def tile_order_reference(tile_start: torch.Tensor, max_k: int
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel's tile schedule: (bucket [T], order [T]).
    A tile's bucket grows with min(count, max_k) (0 for an empty tile, 1..63
    otherwise); the kernel blends the tiles in descending bucket order, in
    any order within a bucket. Here the order within a bucket is by tile."""
    length = (tile_start[1:] - tile_start[:-1]).clamp_max(max_k).long()
    bucket = torch.where(length > 0,
                         1 + (length - 1) * (ORDER_BUCKETS - 1) // max_k, 0)
    order = torch.sort(-bucket, stable=True).indices
    return bucket, order


def tiles_to_image(tiles: torch.Tensor, tiles_x: int, height: int,
                   width: int) -> torch.Tensor:
    """[T, 256, 3] row-major tiles -> [3, H, W] (raster.py:344-348)."""
    tiles_y = tiles.shape[0] // tiles_x
    img = tiles.reshape(tiles_y, tiles_x, TILE, TILE, 3).permute(0, 2, 1, 3, 4)
    img = img.reshape(tiles_y * TILE, tiles_x * TILE, 3)[:height, :width]
    return img.permute(2, 0, 1).contiguous()


def blend_tiles_reference(tile_start: torch.Tensor, pair_gauss: torch.Tensor,
                          mean2d: torch.Tensor, conic: torch.Tensor,
                          opacity: torch.Tensor, colors: torch.Tensor,
                          bg: torch.Tensor, *, tiles_x: int, height: int,
                          width: int, max_k: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device: the XLA blend of
    raster.py:264-315 in float32 over the same gather as the Pallas path."""
    n_tiles = _check_inputs(tile_start, pair_gauss, mean2d, conic, opacity,
                            colors, bg, tiles_x, height, width, max_k)
    tiles = torch.empty((n_tiles, PIX, 3), dtype=torch.float32,
                        device=mean2d.device)
    for c0, c1, alpha, t_before, log1ma, gidx in _alpha_chunks(
            tile_start, pair_gauss, mean2d, conic, opacity, tiles_x, max_k):
        w = torch.where(t_before >= T_MIN, alpha * t_before, 0.0)
        rgb = torch.einsum("cpk,ckr->cpr", w, colors[gidx])
        t_final = torch.exp(log1ma.sum(-1))
        tiles[c0:c1] = rgb + t_final[:, :, None] * bg
    return tiles_to_image(tiles, tiles_x, height, width)


def _alpha_chunks(tile_start, pair_gauss, mean2d, conic, opacity, tiles_x,
                  max_k):
    """Per chunk of tiles: (first, end, alpha, t_before, log1ma, gidx) with
    alpha, t_before, log1ma [C, 256, K] and gidx [C, K]. Entries past a
    tile's count have alpha 0 and t_before 0."""
    n_tiles = tile_start.shape[0] - 1
    dev = mean2d.device
    k = max_k
    slot = torch.arange(k, device=dev)
    pix = torch.arange(PIX, device=dev)
    pxo = (pix % TILE).to(torch.float32)
    pyo = (pix // TILE).to(torch.float32)
    n_pairs = pair_gauss.shape[0]
    for c0 in range(0, n_tiles, _REF_TILE_CHUNK):
        tids = torch.arange(c0, min(c0 + _REF_TILE_CHUNK, n_tiles), device=dev)
        starts = tile_start[tids].long()
        take = torch.clamp_max(tile_start[tids + 1].long() - starts, k)
        gmask = slot[None, :] < take[:, None]  # [C, K]
        if n_pairs:
            gidx = pair_gauss[torch.clamp(starts[:, None] + slot[None, :], 0,
                                          n_pairs - 1)].long()
        else:
            gidx = torch.zeros((tids.shape[0], k), dtype=torch.long, device=dev)
            gmask = torch.zeros_like(gmask)
        g_mean = mean2d[gidx]  # [C, K, 2]
        g_conic = conic[gidx]  # [C, K, 3]
        g_opa = opacity[gidx]  # [C, K]

        ppx = ((tids % tiles_x) * TILE).to(torch.float32)[:, None] + pxo[None, :]
        ppy = ((tids // tiles_x) * TILE).to(torch.float32)[:, None] + pyo[None, :]
        dx = ppx[:, :, None] - g_mean[:, None, :, 0]  # [C, 256, K]
        dy = ppy[:, :, None] - g_mean[:, None, :, 1]
        power = -0.5 * (g_conic[:, None, :, 0] * dx * dx
                        + g_conic[:, None, :, 2] * dy * dy
                        ) - g_conic[:, None, :, 1] * dx * dy
        alpha = torch.clamp_max(
            g_opa[:, None, :] * torch.exp(torch.clamp_max(power, 0.0)), 0.99)
        alpha = torch.where(gmask[:, None, :] & (alpha >= ALPHA_MIN), alpha, 0.0)
        log1ma = torch.log1p(-alpha)
        # transmittance before each entry: exclusive prefix sum over depth
        t_before = torch.exp(torch.cumsum(F.pad(log1ma[..., :-1], (1, 0)), -1))
        t_before = torch.where(gmask[:, None, :], t_before, 0.0)
        yield c0, c0 + tids.shape[0], alpha, t_before, log1ma, gidx
