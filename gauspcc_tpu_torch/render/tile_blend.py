"""Per-tile alpha blend: the hand-written CUDA kernels and their plain version.

Counterpart of `gauspcc_tpu/render/pallas_blend.py` (`_blend_kernel` :46,
`blend_tiles` :92) plus the record gather of `gauspcc_tpu/render/raster.py`
:317-342, and of the gradient JAX takes by autodiff of its XLA blend
(raster.py:264-315). The kernels (`csrc/tile_blend.cu`) gather each tile's
records themselves from the per-Gaussian arrays; the forward writes the
image `[3, H, W]`, the backward adds the gradients of mean2d, conic,
opacity and colors.

`blend_tiles` launches the forward for CUDA tensors and raises if it
cannot, under `_TileBlend`, whose backward is the backward kernel. It takes
the plain version `blend_tiles_reference` only for CPU tensors, where
autograd through it is the gradient. The plain version computes the same
function the way the JAX package does (exclusive prefix sum of
log(1 - alpha), no early stop), so it, and autograd through it, are also
the oracles the kernels are held against on the card.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from gauspcc_tpu_torch import native
from gauspcc_tpu_torch.utils import profiling

TILE = 16
PIX = TILE * TILE
ALPHA_MIN = 1.0 / 255.0
T_MIN = 1e-4
_REF_TILE_CHUNK = 64  # tiles per step of the plain version: bounds its [C, 256, K] temporaries
ORDER_BUCKETS = 64  # list-length buckets of the kernel's tile schedule
SCHED_SM_IDS = 1024  # per-SM rank counters in the schedule's scratch

# Number of kernel launches made by `blend_tiles`: one per call of the C
# entry, which launches the schedule's order_kernel and then blend_kernel.
# Callers reset it to 0 to count the launches of one run. While the
# recorder is on, each launch also counts "launches" in the innermost span
# (utils/profiling.py).
launches = 0
# The same for the backward's C entry (order_kernel, then backward_kernel),
# counted by `blend_tiles_backward`.
backward_launches = 0
ALPHA_MAX = 0.99
F32_ULP = 2.0 ** -24  # unit roundoff of float32
# The backward kernel's packed gradient [N, GRAD_STRIDE] (16-byte rows, so
# each record takes three vector atomics): each part's (offset, width); the
# last 3 floats of a row are padding.
GRAD_STRIDE = 12
GRAD_PARTS = {"colors": (0, 3), "opacity": (3, 1), "mean2d": (4, 2),
              "conic": (6, 3)}


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


GRAD_EPS = 2e-4  # float32 reordering, relative (kernel_tolerance's rtol)
CLAMP_WINDOW = 1e-5  # relative distance of opacity * exp(power) from 0.99


def gradient_tolerance(tile_start, pair_gauss, mean2d, conic, opacity, colors,
                       bg, grad_out, *, tiles_x: int, height: int, width: int,
                       max_k: int) -> dict[str, torch.Tensor]:
    """Per-element atol of the backward kernel's gradients (mean2d, conic,
    opacity, colors) against autograd of `blend_tiles_reference`, for the
    upstream gradient `grad_out` [3, H, W].

    Each Gaussian's gradient is a sum over the pixel-entries (pixel p, list
    entry j) that name it; the atol is the sum over them of these bounds on
    the difference of one term, times its chain factor (e for opacity,
    alpha |dpower/d.| for mean and conic, w for colour). With g = grad_out
    at p, cg_j = c_j . g, Gabs = sum_j w_j |cg_j| + T_final |bg . g| (what G
    and S_j are sums of) and M = max(|bg . g|, max_j |cg_j|):

    - float32 reordering. T is a running product in the kernel and exp of
      a cumulative sum of log1p(-alpha) in the plain version; G - S_j is a
      difference of sums in one and a back-propagated cumulative sum in the
      other; the per-Gaussian sums take another order (warp shuffles and
      atomics, whose order changes from run to run). eps (T_j |cg_j| + Gabs
      / (1 - alpha_j)) on dL/dalpha_j and eps w_j |g| on dL/dc_j, with eps =
      GRAD_EPS + 16 ulps times the quadratic form's largest term sum over
      the pixel's entries (the power's rounding, as the kernel's near-cut
      window), plus n ulps of the summed magnitudes for a sum of n terms.
    - the early stop. The kernel stops a pixel once T < 1e-4 and its image
      uses T_end, T after the last entry blended; the plain version
      multiplies T_final over every entry, so it sends each entry j a
      gradient through T_final (bg . g) that the kernel sends through T_end,
      or not at all past the stop: at most T_end |bg . g| / (1 - alpha_j)
      <= 1e-4 |bg . g| / (1 - alpha_j) per entry of a stopped pixel. An
      entry whose T_before lies within rounding of 1e-4 may be blended on
      one side only, which moves its own term by 1e-4 (|cg_j| + 2 M) / (1 -
      alpha_j) and every earlier entry's by 2e-4 M / (1 - alpha_i). So
      every entry of a pixel whose T_final < 2e-4 gets 3e-4 M / (1 -
      alpha_j) on dL/dalpha_j and 2e-4 |g| on dL/dc_j.
    - the clamps. Where opacity * exp(power) lies within CLAMP_WINDOW of
      0.99, the kernel's exponential may clamp alpha on one side only; where
      the power lies within its rounding of 0, its clamp to 0 likewise. Each
      such entry may differ by its whole term (T_j |cg_j| + Gabs / (1 -
      alpha_j) on dL/dalpha_j; on the power's chain for the latter).

    Entries at the 1/255 cut are kept and dropped alike: the kernel recomputes
    them as the plain version does (tile_blend.cu, near_cut_window)."""
    n = mean2d.shape[0]
    dev = mean2d.device
    f = torch.float64
    tol = {"mean2d": torch.zeros((n, 2), dtype=f, device=dev),
           "conic": torch.zeros((n, 3), dtype=f, device=dev),
           "opacity": torch.zeros((n,), dtype=f, device=dev),
           "colors": torch.zeros((n, 3), dtype=f, device=dev)}
    mags = {k: torch.zeros_like(v) for k, v in tol.items()}
    terms = torch.zeros((n,), dtype=f, device=dev)
    n_tiles = tile_start.shape[0] - 1
    tiles_y = n_tiles // tiles_x
    pad_h, pad_w = tiles_y * TILE, tiles_x * TILE
    g_img = F.pad(grad_out.to(f), (0, pad_w - width, 0, pad_h - height))
    # [T, 256, 3] tiles of the upstream gradient (out-of-image pixels 0)
    g_tiles = g_img.permute(1, 2, 0).reshape(tiles_y, TILE, tiles_x, TILE, 3
                                             ).permute(0, 2, 1, 3, 4).reshape(
        n_tiles, PIX, 3)
    bg64 = bg.to(f)
    for c0, c1, alpha, t_before, log1ma, gidx in _alpha_chunks(
            tile_start, pair_gauss, mean2d, conic, opacity, tiles_x, max_k):
        alpha, t_before = alpha.to(f), t_before.to(f)
        g = g_tiles[c0:c1]  # [C, 256, 3]
        col = colors[gidx].to(f)  # [C, K, 3]
        cg = torch.einsum("cpr,ckr->cpk", g, col)
        bgg = (g * bg64).sum(-1)  # [C, 256]
        live = t_before >= T_MIN
        blended = live & (alpha > 0)
        w = torch.where(blended, alpha * t_before, 0.0)
        t_final = torch.exp(log1ma.to(f).sum(-1))
        gabs = (w * cg.abs()).sum(-1) + t_final * bgg.abs()
        big = torch.maximum(bgg.abs(), cg.abs().amax(-1))
        # the pixel-entries' geometry, as _alpha_chunks computes it
        ids = torch.arange(c0, c1, device=dev)
        pix = torch.arange(PIX, device=dev)
        ppx = ((ids % tiles_x) * TILE)[:, None] + (pix % TILE)[None, :]
        ppy = ((ids // tiles_x) * TILE)[:, None] + (pix // TILE)[None, :]
        dx = ppx[:, :, None].to(f) - mean2d[gidx][:, None, :, 0].to(f)
        dy = ppy[:, :, None].to(f) - mean2d[gidx][:, None, :, 1].to(f)
        ca, cb, cc = (conic[gidx][:, None, :, i].to(f) for i in range(3))
        quad = 0.5 * ca.abs() * dx * dx + cb.abs() * (dx * dy).abs() + \
            0.5 * cc.abs() * dy * dy
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        e = torch.exp(torch.clamp_max(power, 0.0))
        opa = opacity[gidx][:, None, :].to(f)
        eps = GRAD_EPS + 16 * F32_ULP * torch.where(
            t_before > 0, quad, 0.0).amax(-1, keepdim=True)
        inv = 1.0 / (1.0 - torch.clamp_max(alpha, ALPHA_MAX))
        whole = t_before * cg.abs() + gabs[..., None] * inv  # |dL/dalpha| scale
        near_stop = (t_final < 2 * T_MIN)[..., None]
        err_a = eps * whole + torch.where(near_stop, 3 * T_MIN * big[..., None] * inv, 0.0)
        near_clamp = (opa * e - ALPHA_MAX).abs() <= CLAMP_WINDOW * ALPHA_MAX
        # every entry the plain version differentiates (alpha > 0, blended
        # or past the stop)
        kept = alpha > 0
        err_a = torch.where(kept, err_a + torch.where(near_clamp, whole, 0.0), 0.0)
        near_zero = kept & (power > -16 * F32_ULP * quad)
        whole = torch.where(kept, whole, 0.0)
        dpx, dpy = ca * dx + cb * dy, cc * dy + cb * dx  # dpower/d(mx, my)
        geo = torch.stack([dpx.abs(), dpy.abs(), 0.5 * dx * dx, (dx * dy).abs(),
                           0.5 * dy * dy], -1)  # [C, 256, K, 5]
        err_pow = (alpha * err_a)[..., None] * geo + torch.where(
            near_zero, alpha * whole, 0.0)[..., None] * geo
        err_col = eps[..., None] * (w[..., None] * g.abs()[:, :, None, :]) + \
            torch.where(near_stop[..., None] & kept[..., None],
                        2 * T_MIN * g.abs()[:, :, None, :], 0.0)
        flat = gidx.reshape(-1)

        def add(dst, per_entry):  # [C, 256, K, ...] summed per Gaussian
            dst.index_add_(0, flat, per_entry.sum(1).reshape(
                (flat.shape[0],) + tuple(per_entry.shape[3:])))

        add(tol["opacity"], err_a * e)
        add(tol["mean2d"], err_pow[..., :2])
        add(tol["conic"], err_pow[..., 2:])
        add(tol["colors"], err_col)
        add(mags["opacity"], whole * e)
        add(mags["mean2d"], (alpha * whole)[..., None] * geo[..., :2])
        add(mags["conic"], (alpha * whole)[..., None] * geo[..., 2:])
        add(mags["colors"], w[..., None] * g.abs()[:, :, None, :])
        add(terms, kept.to(f))
    # a sum of n terms in float32, in any order: n ulps of their magnitudes
    for k in tol:
        scale = terms if tol[k].dim() == 1 else terms[:, None]
        tol[k] = (tol[k] + scale * F32_ULP * mags[k]).to(torch.float32)
    return tol


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
        lib.tile_blend_backward.argtypes = [ctypes.c_void_p] * 8 + [
            ctypes.c_int] * 5 + [ctypes.c_void_p] * 3
        lib.tile_blend_backward.restype = ctypes.c_int
        lib.tile_blend_launch_shape.argtypes = [ctypes.c_int, ctypes.c_int,
                                                ctypes.c_void_p]
        lib.tile_blend_launch_shape.restype = ctypes.c_int
    return lib


def launch_shape(n_tiles: int, backward: bool = False) -> dict:
    """The blend's launch (or the backward's) on the current card: blocks,
    threads, pixels per thread, static shared bytes, resident blocks per SM
    and registers per thread."""
    shape = (ctypes.c_int * 6)()
    rc = _library().tile_blend_launch_shape(int(backward), n_tiles,
                                            ctypes.addressof(shape))
    if rc != 0:
        raise RuntimeError(f"tile_blend launch shape failed: CUDA error {rc}")
    return dict(zip(("blocks", "threads", "pix_per_thread", "shared_bytes",
                     "blocks_per_sm", "registers"), shape))


def _launch(args, sched: torch.Tensor, *, tiles_x: int, height: int,
            width: int, max_k: int) -> torch.Tensor:
    """One call of the C entry on CUDA tensors (the schedule's order, then
    the blend) -> image [3, H, W]; raises if a launch is refused. `sched`
    is the schedule's scratch, int32 [schedule_words(T)]. Counts no
    launch: `_TileBlend.forward` does."""
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


class _TileBlend(torch.autograd.Function):
    """The blend on CUDA tensors with its gradient: forward kernel, then the
    backward kernel. The tile lists and bg get no gradient."""

    @staticmethod
    def forward(ctx, tile_start, pair_gauss, mean2d, conic, opacity, colors,
                bg, kw):
        global launches
        args = (tile_start, pair_gauss, mean2d, conic, opacity, colors, bg)
        n_tiles = _check_inputs(*args, **kw)
        sched = torch.empty(schedule_words(n_tiles), dtype=torch.int32,
                            device=mean2d.device)
        out = _launch(args, sched, **kw)
        launches += 1
        profiling.count("launches")
        ctx.save_for_backward(*args, out)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, grad_out):
        *args, out = ctx.saved_tensors
        grads = blend_tiles_backward(*args, out, grad_out, **ctx.kw)
        return (None, None, *grads, None, None)


def blend_tiles(tile_start: torch.Tensor, pair_gauss: torch.Tensor,
                mean2d: torch.Tensor, conic: torch.Tensor,
                opacity: torch.Tensor, colors: torch.Tensor, bg: torch.Tensor,
                *, tiles_x: int, height: int, width: int, max_k: int
                ) -> torch.Tensor:
    """Blend every tile's first min(count, max_k) entries -> image [3, H, W].

    tile_start [T + 1] int32 and pair_gauss [P] int32 are the sorted tile
    lists of `raster._build_tile_lists`; mean2d [N, 2], conic [N, 3],
    opacity [N], colors [N, 3] and bg [3] are float32. Differentiable in
    mean2d, conic, opacity and colors."""
    args = (tile_start, pair_gauss, mean2d, conic, opacity, colors, bg)
    kw = dict(tiles_x=tiles_x, height=height, width=width, max_k=max_k)
    if mean2d.device.type == "cpu":
        return blend_tiles_reference(*args, **kw)
    if mean2d.device.type != "cuda":
        raise ValueError(f"tile_blend runs on CUDA or CPU, not {mean2d.device}")
    return _TileBlend.apply(*args, kw)


def blend_tiles_backward(tile_start: torch.Tensor, pair_gauss: torch.Tensor,
                         mean2d: torch.Tensor, conic: torch.Tensor,
                         opacity: torch.Tensor, colors: torch.Tensor,
                         bg: torch.Tensor, out: torch.Tensor,
                         grad_out: torch.Tensor, *,
                         tiles_x: int, height: int, width: int, max_k: int):
    """Gradients (mean2d [N, 2], conic [N, 3], opacity [N], colors [N, 3])
    of the blend whose image is `out` [3, H, W], for grad_out = dL/d(out).

    The backward kernel on CUDA tensors (counted in `backward_launches`),
    which reads bg's part of the image from `out` and adds every gradient
    into one packed buffer, returned as views (`unpack_gradients`);
    autograd through `blend_tiles_reference` on CPU tensors."""
    global backward_launches
    kw = dict(tiles_x=tiles_x, height=height, width=width, max_k=max_k)
    if mean2d.device.type == "cpu":
        return blend_backward_reference(tile_start, pair_gauss, mean2d, conic,
                                        opacity, colors, bg, grad_out, **kw)
    if mean2d.device.type != "cuda":
        raise ValueError(f"tile_blend runs on CUDA or CPU, not {mean2d.device}")
    n_tiles = _check_inputs(tile_start, pair_gauss, mean2d, conic, opacity,
                            colors, bg, **kw)
    for name, t in (("out", out), ("grad_out", grad_out)):
        if tuple(t.shape) != (3, height, width) or t.dtype != torch.float32 \
                or t.device != mean2d.device:
            raise ValueError(f"{name}: expected float32 (3, {height}, {width}) "
                             f"on {mean2d.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    args = [t.contiguous() for t in (tile_start, pair_gauss, mean2d, conic,
                                     opacity, colors, out, grad_out)]
    dev = mean2d.device
    packed = torch.zeros((mean2d.shape[0], GRAD_STRIDE), dtype=torch.float32,
                         device=dev)
    sched = torch.empty(schedule_words(n_tiles), dtype=torch.int32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.tile_blend_backward(
            *[t.data_ptr() for t in args], n_tiles, tiles_x, height, width,
            max_k, sched.data_ptr(), packed.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"tile_blend backward launch failed: CUDA error {rc}")
    backward_launches += 1
    profiling.count("launches")
    return unpack_gradients(packed)


def unpack_gradients(packed: torch.Tensor):
    """Views of the backward kernel's packed gradient [N, GRAD_STRIDE]:
    (mean2d [N, 2], conic [N, 3], opacity [N], colors [N, 3])."""
    def part(name):
        at, width = GRAD_PARTS[name]
        return packed[:, at] if width == 1 else packed[:, at:at + width]
    return tuple(part(name) for name in ("mean2d", "conic", "opacity", "colors"))


def blend_backward_reference(tile_start, pair_gauss, mean2d, conic, opacity,
                             colors, bg, grad_out, *, tiles_x: int,
                             height: int, width: int, max_k: int):
    """Plain version of the backward, on any device: autograd through
    `blend_tiles_reference` -> (mean2d, conic, opacity, colors) gradients."""
    leaves = [t.detach().requires_grad_(True)
              for t in (mean2d, conic, opacity, colors)]
    with torch.enable_grad():
        out = blend_tiles_reference(tile_start, pair_gauss, *leaves, bg,
                                    tiles_x=tiles_x, height=height,
                                    width=width, max_k=max_k)
        return torch.autograd.grad(out, leaves, grad_out)


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
