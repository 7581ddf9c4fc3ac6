"""Smoke run of the PyTorch/CUDA port (`gauspcc_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--baseline FILE]

Phases, each printed with its wall time; any failure ends the run with a
non-zero exit and no result line:

  device  the card's name and power limit (nvidia-smi); no CUDA -> exit 1
  build   nvcc builds every kernel of the port from gauspcc_tpu_torch/csrc;
          ptxas registers, shared memory and spills per kernel
  kernel  the tile-blend kernel against its plain PyTorch version on random
          tiles at K = 1024 (empty tiles, short ones, tiles over K); the
          backward kernel against autograd of the plain version, for a
          seeded upstream gradient, on those tiles and on random tiles at
          K = 256, within gradient_tolerance; both on thin Gaussians near 45
          degrees whose alpha lies at the 1/255 cut (cut_lists)
  scene   the r5 soak scene (512x512, textured, white background, 6,000
          ground-truth Gaussians, 24 orbit cameras, 30,000 seed points)
          built on the card, ground truth rendered by the port
  serve   a seeded, untrained HAC state at the full HACConfig width served
          through `pipeline.evaluate` on the 3 held-out views (K = 1024, D
          from select_eval_d capped at 128); the kernel's launches in that
          run are counted, and one whole frame is blended by both the
          kernel and the plain version and compared; then each stage of a
          view is timed alone, and one whole view by wall clock, by CUDA
          events, for its host syncs and under torch.profiler (device busy
          time, idle share, longest kernels). At the frame's lists it also
          prints the kernel's launch shape, the per-tile load, the SFU's
          exp term beside the bound, and the device time of each of the
          two kernels a call launches (order_kernel, blend_kernel) under
          torch.profiler
  train   `soak.train` on the same scene at the full HACConfig width, 600
          steps with the soak's compressed phase schedule (phases 0, 1, 2)
          and densification at steps 100, 200 and 300: the loss per phase,
          the anchors after each densification, the raster caps, the
          non-finite gradient count, both kernels' launches; checks a
          finite loss falling in phase 0, bits per parameter > 0 in phase
          2, and a held-out PSNR above the serve phase's. Then a step at
          phases 0 and 2 by wall clock, CUDA events and torch.profiler, its
          host syncs; on one training frame's lists, both kernels against
          their plain versions, timed beside their bounds; and the forward
          re-timed on trained lists at K = 1024
  reference  the whole slice at small widths on a 64x64 scene, on the card
          and through the port's CPU path, compared: ground truth, eval
          renders, and 3 training steps at phase 0

With --baseline FILE, an earlier tile_blend.cu is built, run on the thin
Gaussians at the cut (its values outside the tolerance are reported, not
checked), and checked and timed beside the kernel on the serve frame, in
turns (baseline, kernel, kernel, baseline); its C interface is
tile_blend_forward(7 pointers, 5 ints, schedule scratch, out, stream), as
from PR 5 on.

Then one JSON line per the port's kernels (launches, error, times, bound)
and, last, {"ok": true, "device": {...}}. Nothing is written into the tree
except the kernel build under gauspcc_tpu_torch/build/ (gitignored).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
import warnings
from collections import Counter
from pathlib import Path

import numpy as np
import torch

from gauspcc_tpu_torch import native
from gauspcc_tpu_torch.cli import soak
from gauspcc_tpu_torch.models.hac import model as hac
from gauspcc_tpu_torch.models.hac import pipeline
from gauspcc_tpu_torch.models.hac import render as hac_render
from gauspcc_tpu_torch.models.hac import train as hac_train
from gauspcc_tpu_torch.render import raster, tile_blend
from gauspcc_tpu_torch.utils import image as img_lib

SEED = 0
# r5 soak settings (gauspcc_tpu/cli/soak.py:135-147) and eval caps (runs/soak_hac_r5)
HW, N_GT, N_CAMS, N_SEED, VOXEL_SIZE = 512, 6000, 24, 30_000, 0.01
EVAL_K = 1024
# published H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor
# cores, and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# fp32 operations per pixel-entry: evaluating it (offsets 2, quadratic form
# 8, clamp + exp + opacity + cap + threshold 5), and, only for an entry with
# alpha >= 1/255, blending it (weight, 3 FMAs, transmittance, test)
EVAL_OPS_PER_ENTRY = 15
BLEND_OPS_PER_ENTRY = 10
# Hopper's SFU: 16 exp a clock per SM (one per evaluated pixel-entry)
SFU_EXP_PER_CLOCK = 16
# a delay kernel's length: the host enqueues a timed run behind it
DELAY_CYCLES = 50_000_000
# reference phase: small widths (as the CPU parity tests use) on a 64x64
# scene. GT renders (no quantisation) must agree to the kernel's tolerance
# plus REF_ATOL of float32 rounding in project; HAC renders pass through the
# STE quantiser, where a rounding tie can move one symbol, so they are held
# to a PSNR between the two renders instead.
SMALL_CFG = dict(feat_dim=16, n_offsets=4, voxel_size=0.05,
                 resolutions_3d=(6, 10, 16), resolutions_2d=(16, 32),
                 log2_hashmap_size=13, log2_hashmap_size_2d=13)
REF_ATOL = 1e-4
REF_PSNR_DB = 60.0
# gradient fp32 operations per blended pixel-entry in the backward: c . g
# (5), w and S (3), dL/dalpha (5: T c.g, G - S, 1 - alpha, the quotient),
# T (2), the colour partials (6), opacity (2), dL/dpower (1), the mean
# partials (10) and the conic's (11); the alpha is recomputed as the
# forward evaluates it (EVAL_OPS_PER_ENTRY per evaluated pixel-entry)
BWD_OPS_PER_BLENDED = 45
# bytes of the atomics of one record and warp that touched it: 9 floats
ATOMIC_BYTES_PER_WARP_RECORD = 36
# train phase: a smoke-length run of the soak at full width, with the soak's
# compressed phase schedule (600 steps: phase 0 to 300, 1 to 400, 2 after)
# and densification at steps 100, 200 and 300
TRAIN_STEPS = 600
TRAIN_DENSIFY = dict(start_stat=50, update_from=50, update_interval=100,
                     update_until=400)
# reference phase: training steps of the small scene at phase 0 on the card
# and on the CPU. The first step's losses differ by the blend's float32
# reordering (the kernels' tolerance, 2e-4); Adam's first steps move every
# element by about its lr whatever the size of its gradient, so an element
# whose gradient lies within that reordering of 0 may move the other way on
# the other device, which the later losses see: loss rtol 1e-3, and the
# change of mlp_color's output weight within 2% of its norm (a few of its
# 1,500 elements).
REF_TRAIN_STEPS = 3
REF_LOSS_RTOL = 1e-3
REF_LEAF_RTOL = 0.02


def log(msg: str) -> None:
    print(msg, flush=True)


class Phase:
    """Prints the phase's wall time when it ends without an exception."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        log(f"[{self.name}] start")
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            log(f"[{self.name}] ok in {time.perf_counter() - self.t0:.3f} s")
        return False


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over `reps` runs after one warm-up."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def device_ms(fn, reps: int) -> tuple[float, float]:
    """(device ms, host ms) per run of fn() over `reps` back-to-back runs
    after one warm-up. The runs are enqueued behind a delay kernel, so the
    card runs them without gaps however long the host takes to enqueue
    each (for a short kernel `cuda_ms` measures the host's rate of
    enqueueing); host ms is that enqueueing, by wall clock. The delay
    doubles until the card is still in it when the last run is enqueued."""
    fn()
    torch.cuda.synchronize()
    delay = DELAY_CYCLES
    for _ in range(6):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(delay)
        e0.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host = (time.perf_counter() - t0) * 1e3 / reps
        e1.record()
        covered = not e0.query()
        e1.synchronize()
        if covered:
            return e0.elapsed_time(e1) / reps, host
        delay *= 2
    raise RuntimeError("the delay kernel never covered the host's enqueueing")


def wall_ms(fn, reps: int) -> list[float]:
    """Host wall-clock milliseconds of each of `reps` calls of fn(), with
    the device synchronised before and after each call."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def host_syncs(fn) -> Counter:
    """Where fn() makes the host wait for the device: the Python lines of
    its synchronising CUDA operations (torch's sync debug mode), counted."""
    root = Path(__file__).resolve().parent
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    where = Counter()
    for w in caught:
        if "synchroniz" in str(w.message):
            path = Path(w.filename).resolve()
            name = path.relative_to(root) if path.is_relative_to(root) else path.name
            where[f"{name}:{w.lineno}"] += 1
    return where


def device_profile(fn):
    """One fn() under torch.profiler -> (busy ms, device activities, top
    kernels): busy is the union of the intervals in which a kernel, copy or
    fill ran on the card; top kernels are (name, count, ms), longest first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    per_name: dict[str, list[float]] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            per_name.setdefault(e.name, []).append(
                e.time_range.end - e.time_range.start)
    top = sorted(((n, len(d), sum(d) / 1e3) for n, d in per_name.items()),
                 key=lambda t: -t[2])[:8]
    return busy_us / 1e3, len(spans), top


def check_close(name: str, got: torch.Tensor, want: torch.Tensor,
                rtol: float, atol: float) -> float:
    if got.shape != want.shape:
        raise RuntimeError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        raise RuntimeError(f"{name}: non-finite values")
    diff = (got - want).abs()
    bad = int((diff > atol + rtol * want.abs()).sum())
    max_abs = float(diff.max())
    log(f"  {name}: max |diff| = {max_abs:.3e} "
        f"(tolerance atol {atol:.3e} + rtol {rtol:g} * |reference|), {bad} outside")
    if bad:
        raise RuntimeError(f"{name}: {bad} values outside the tolerance")
    return max_abs


def random_tiles(gen: torch.Generator, device, tiles_x: int, tiles_y: int,
                 max_k: int):
    """Tile lists with empty tiles, short ones, ones up to K and ones over
    K; each tile's Gaussians lie around it, stored in shuffled order so the
    kernel's gather is a real one."""
    n_tiles = tiles_x * tiles_y

    def randint(lo, hi):
        return torch.randint(lo, hi, (n_tiles,), generator=gen)

    kind = randint(0, 4)
    half = max_k // 2 + 1
    counts = torch.where(kind == 0, 0, torch.where(
        kind == 1, randint(1, half), torch.where(
            kind == 2, randint(half, max_k + 1), randint(max_k + 1, 2 * max_k))))
    n = int(counts.sum())
    tile_of = torch.repeat_interleave(torch.arange(n_tiles), counts)
    origin = torch.stack([tile_of % tiles_x, tile_of // tiles_x], -1) * 16
    mean2d = origin.float() + torch.rand(n, 2, generator=gen) * 32 - 8
    conic = torch.stack([torch.rand(n, generator=gen) * 0.3 + 0.02,
                         (torch.rand(n, generator=gen) - 0.5) * 0.02,
                         torch.rand(n, generator=gen) * 0.3 + 0.02], -1)
    # per-tile opacity scale: faint tiles run their whole list, dense ones
    # saturate early
    opacity = (torch.rand(n_tiles, generator=gen) * 0.9 + 0.02)[tile_of] * (
        0.5 + 0.5 * torch.rand(n, generator=gen))
    colors = torch.rand(n, 3, generator=gen)
    perm = torch.randperm(n, generator=gen)

    def shuffled(v):
        out = torch.empty_like(v)
        out[perm] = v
        return out.to(device)

    tile_start = torch.cat([torch.zeros(1, dtype=torch.long), counts.cumsum(0)])
    bg = torch.rand(3, generator=gen)
    return (tile_start.int().to(device), perm.int().to(device),
            shuffled(mean2d), shuffled(conic), shuffled(opacity),
            shuffled(colors), bg.to(device))


def cut_lists(device, tiles_x: int, tiles_y: int, seed: int = 0):
    """One thin Gaussian near 45 degrees alone in each tile, whose alpha at
    one pixel of the tile lies within a few ulps of 1/255, on both sides.

    The 2-D covariance is L u u^T + 0.3 I with u at 45 degrees (the +0.3 px
    low-pass bounds the thin axis), so the conic entries are near 1/0.6; the
    mean lies 120-160 px along u from the pixel, where the quadratic form's
    terms are about 10^4 and cancel to a power of -3 to -5. The opacity is
    set from the plain version's own exp(power) on `device`, moved by -2 to
    +2 ulps, so the plain version keeps about half of the entries and drops
    the rest."""
    rng = np.random.default_rng(seed)
    n = tiles_x * tiles_y
    tile = np.arange(n)
    target = np.stack([tile % tiles_x, tile // tiles_x], -1) * 16 + \
        rng.integers(0, 16, (n, 2))
    u = np.array([1.0, 1.0]) / np.sqrt(2.0)
    u_perp = np.array([1.0, -1.0]) / np.sqrt(2.0)
    d_par = rng.uniform(120, 160, n) * rng.choice([-1.0, 1.0], n)
    d_perp = rng.uniform(-1.0, 1.0, n)
    q = rng.uniform(6.0, 10.0, n)  # -2 * power at the pixel
    length = d_par**2 / (q - d_perp**2 / 0.3)
    cov = length[:, None, None] * np.outer(u, u)[None] + 0.3 * np.eye(2)[None]
    inv = np.linalg.inv(cov)
    conic = np.stack([inv[:, 0, 0], inv[:, 0, 1], inv[:, 1, 1]], -1)
    mean2d = target - d_par[:, None] * u - d_perp[:, None] * u_perp
    f32 = dict(dtype=torch.float32, device=device)
    mean_t, conic_t = torch.tensor(mean2d, **f32), torch.tensor(conic, **f32)
    # the plain version's power and exp at the pixel, on the same device
    dx = torch.tensor(target[:, 0], **f32) - mean_t[:, 0]
    dy = torch.tensor(target[:, 1], **f32) - mean_t[:, 1]
    power = -0.5 * (conic_t[:, 0] * dx * dx + conic_t[:, 2] * dy * dy
                    ) - conic_t[:, 1] * dx * dy
    e = torch.exp(torch.clamp_max(power, 0.0))
    opacity = (1.0 / 255.0) / e
    for _ in range(2):  # ulp steps from the quotient, on either side
        step = torch.tensor(rng.integers(-1, 2, n), device=device)
        opacity = torch.where(step > 0, torch.nextafter(opacity, torch.ones_like(opacity)),
                              torch.where(step < 0, torch.nextafter(
                                  opacity, torch.zeros_like(opacity)), opacity))
    colors = torch.tensor(rng.uniform(0, 1, (n, 3)), **f32)
    tile_start = torch.arange(n + 1, dtype=torch.int32, device=device)
    pair_gauss = torch.arange(n, dtype=torch.int32, device=device)
    bg = torch.tensor(rng.uniform(0, 1, 3), **f32)
    return (tile_start, pair_gauss, mean_t, conic_t, opacity, colors, bg)


def entries_per_tile(tile_start, pair_gauss, mean2d, conic, opacity, *,
                     tiles_x: int, max_k: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """(evaluated [T], blended [T]) pixel-entries of each tile's blend on
    these inputs: for each pixel, the entries of its tile (at most max_k)
    whose T_before is still at or above 1e-4, and of those the ones with
    alpha >= 1/255, which are blended."""
    evaluated, blended = [], []
    for _, _, alpha, t_before, _, _ in tile_blend._alpha_chunks(
            tile_start, pair_gauss, mean2d, conic, opacity, tiles_x, max_k):
        live = t_before >= tile_blend.T_MIN
        evaluated.append(live.sum((1, 2)))
        blended.append((live & (alpha > 0)).sum((1, 2)))
    empty = torch.zeros(0, dtype=torch.long, device=mean2d.device)
    return torch.cat([empty, *evaluated]), torch.cat([empty, *blended])


def entries_evaluated(tile_start, pair_gauss, mean2d, conic, opacity, *,
                      tiles_x: int, max_k: int) -> tuple[int, int]:
    """(evaluated, blended) pixel-entries of the whole blend on these
    inputs (`entries_per_tile`, summed): the data-dependent work its bound
    counts."""
    evaluated, blended = entries_per_tile(
        tile_start, pair_gauss, mean2d, conic, opacity, tiles_x=tiles_x,
        max_k=max_k)
    return int(evaluated.sum()), int(blended.sum())


def blend_bound(tile_start, pair_gauss, mean2d, conic, opacity, *, tiles_x,
                height, width, max_k):
    """(bound_ms, bound_by, detail) for one blend on these inputs: each
    input read once (tile starts, the list entries blended, the records of
    the Gaussians they name), the image written once, and the operations of
    the pixel-entries evaluated and blended, at the published peaks."""
    counts = (tile_start[1:] - tile_start[:-1]).clamp_max(max_k).long()
    starts = tile_start[:-1].long()
    n_entries = int(counts.sum())
    first = torch.repeat_interleave(counts.cumsum(0) - counts, counts)
    idx = torch.repeat_interleave(starts, counts) + (
        torch.arange(n_entries, device=counts.device) - first)
    n_records = int(pair_gauss[idx].unique().numel())
    n_bytes = (4 * tile_start.numel() + 4 * n_entries + 36 * n_records + 12
               + 12 * height * width)
    evaluated, blended = entries_evaluated(
        tile_start, pair_gauss, mean2d, conic, opacity, tiles_x=tiles_x,
        max_k=max_k)
    ops = EVAL_OPS_PER_ENTRY * evaluated + BLEND_OPS_PER_ENTRY * blended
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_FP32_FLOPS * 1e3
    detail = (f"{n_entries} list entries, {n_records} records, {n_bytes} B; "
              f"{evaluated} pixel-entries evaluated, {blended} of them blended "
              f"({blended / max(evaluated, 1):.4f}), {ops} fp32 ops")
    if ops_ms >= bytes_ms:
        return ops_ms, "operations", detail
    return bytes_ms, "bytes", detail


def ptxas_lines(build_log: str) -> list[str]:
    """Registers, shared memory and spills of each kernel of a build, one
    line per kernel, from nvcc's -Xptxas -v output."""
    out, name = [], "?"
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            name = next((k for k in ("backward_kernel", "blend_kernel",
                                     "order_kernel") if k in mangled), mangled)
        elif "registers" in line or "spill" in line:
            out.append(f"{name}: {line.split(':', 1)[-1].strip()}")
    return out


def warp_records(tile_start, pair_gauss, mean2d, conic, opacity, *,
                 tiles_x: int, max_k: int) -> int:
    """Records touched per warp, summed: for each tile, entry and warp of
    the backward (4 warps, each of 64 pixels: rows 2w, 2w + 1, 2w + 8 and
    2w + 9), whether any of its pixels blends the entry, which costs one
    warp reduction and 9 atomics."""
    total = 0
    rows = torch.arange(tile_blend.PIX, device=mean2d.device) // tile_blend.TILE
    warp = (rows % 8) // 2
    for _, _, alpha, t_before, _, _ in tile_blend._alpha_chunks(
            tile_start, pair_gauss, mean2d, conic, opacity, tiles_x, max_k):
        blended = (t_before >= tile_blend.T_MIN) & (alpha > 0)  # [C, 256, K]
        for w in range(4):
            total += int(blended[:, warp == w].any(1).sum())
    return total


def backward_bound(tile_start, pair_gauss, mean2d, conic, opacity, *,
                   tiles_x, height, width, max_k):
    """(bound_ms, bound_by, detail) for one backward on these inputs: each
    input read once (tile starts, the list entries, the records of the
    Gaussians they name, the image and its gradient), the gradients of those
    Gaussians written once, the atomics' bytes of the warps that touched a
    record; the operations of the alpha recompute per evaluated pixel-entry
    and of the gradient per blended one, at the published peaks."""
    counts = (tile_start[1:] - tile_start[:-1]).clamp_max(max_k).long()
    starts = tile_start[:-1].long()
    n_entries = int(counts.sum())
    first = torch.repeat_interleave(counts.cumsum(0) - counts, counts)
    idx = torch.repeat_interleave(starts, counts) + (
        torch.arange(n_entries, device=counts.device) - first)
    n_records = int(pair_gauss[idx].unique().numel())
    touched = warp_records(tile_start, pair_gauss, mean2d, conic, opacity,
                           tiles_x=tiles_x, max_k=max_k)
    n_bytes = (4 * tile_start.numel() + 4 * n_entries + 36 * n_records
               + 24 * height * width + 36 * n_records
               + ATOMIC_BYTES_PER_WARP_RECORD * touched)
    evaluated, blended = entries_evaluated(
        tile_start, pair_gauss, mean2d, conic, opacity, tiles_x=tiles_x,
        max_k=max_k)
    ops = EVAL_OPS_PER_ENTRY * evaluated + BWD_OPS_PER_BLENDED * blended
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_FP32_FLOPS * 1e3
    detail = (f"{n_entries} list entries, {n_records} records, {touched} "
              f"warp-records touched, {n_bytes} B; {evaluated} pixel-entries "
              f"evaluated, {blended} blended, {ops} fp32 ops")
    if ops_ms >= bytes_ms:
        return ops_ms, "operations", detail
    return bytes_ms, "bytes", detail


def check_gradients(name: str, frame, out, g, kw) -> float:
    """The backward kernel against autograd of the plain version on one set
    of lists, within gradient_tolerance; returns the largest |difference|."""
    got = tile_blend.blend_tiles_backward(*frame, out, g, **kw)
    torch.cuda.synchronize()
    want = tile_blend.blend_backward_reference(*frame, g, **kw)
    tol = tile_blend.gradient_tolerance(*frame, g, **kw)
    worst = 0.0
    for part, a, b in zip(("mean2d", "conic", "opacity", "colors"), got, want):
        if not bool(torch.isfinite(a).all()):
            raise RuntimeError(f"{name} {part}: non-finite gradient")
        diff = (a - b).abs()
        bad = int((diff > tol[part]).sum())
        worst = max(worst, float(diff.max()) if diff.numel() else 0.0)
        log(f"  {name}, d{part}: max |diff| {float(diff.max()):.3e}, largest "
            f"|reference| {float(b.abs().max()):.3e}, median tolerance "
            f"{float(tol[part].median()):.3e}, {bad} of {diff.numel()} outside")
        if bad:
            raise RuntimeError(f"{name} d{part}: {bad} values outside "
                               f"gradient_tolerance")
    return worst


def baseline_launcher(path: Path, frame, kw):
    """fn() -> image of an earlier tile_blend.cu on the frame's lists, with
    the C interface tile_blend_forward(7 pointers, 5 ints, schedule scratch,
    out, stream)."""
    built = native.load_source(path)
    log(f"  baseline {path}: nvcc {built.seconds:.3f} s")
    for line in ptxas_lines(built.log):
        log(f"  baseline ptxas: {line}")
    fn = built.lib.tile_blend_forward
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    args = [t.contiguous() for t in frame]
    n_tiles = args[0].shape[0] - 1
    sched = torch.empty(tile_blend.schedule_words(n_tiles), dtype=torch.int32,
                        device=args[0].device)

    def run():
        out = torch.empty((3, kw["height"], kw["width"]), device=args[0].device)
        rc = fn(*[t.data_ptr() for t in args], n_tiles, kw["tiles_x"],
                kw["height"], kw["width"], kw["max_k"], sched.data_ptr(),
                out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"baseline launch failed: CUDA error {rc}")
        return out
    return run


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--baseline", type=Path, default=None,
                        help="an earlier tile_blend.cu to time beside the kernel")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    # float32 matmuls in full precision (the default), stated and set
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    with Phase("device"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60
        ).stdout.strip().splitlines()[0]
        log(smi)
        max_sm_mhz = float(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, check=True, timeout=60
        ).stdout.split()[0])
        n_sms = torch.cuda.get_device_properties(0).multi_processor_count
        log(f"  {n_sms} SMs, clocks.max.sm {max_sm_mhz:g} MHz")
        log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
            f"{torch.cuda.device_count()} device(s)")

    with Phase("build"):
        built = native.load("tile_blend")
        log(f"  tile_blend: nvcc {built.seconds:.3f} s -> {built.path.name}")
        for line in ptxas_lines(built.log):
            log(f"  ptxas {line}")

    with Phase("kernel"):
        gen = torch.Generator().manual_seed(SEED)
        args = random_tiles(gen, dev, 32, 32, EVAL_K)
        kw = dict(tiles_x=32, height=HW, width=HW, max_k=EVAL_K)
        got = tile_blend.blend_tiles(*args, **kw)
        torch.cuda.synchronize()
        want = tile_blend.blend_tiles_reference(*args, **kw)
        counts = args[0][1:] - args[0][:-1]
        log(f"  random tiles: {int((counts == 0).sum())} empty, "
            f"{int((counts > EVAL_K).sum())} over K={EVAL_K}, "
            f"{int(counts.sum())} entries")
        rtol, atol = tile_blend.kernel_tolerance(args[6], args[5])
        check_close("random tiles, kernel vs plain", got, want, rtol, atol)
        # the backward against autograd of the plain version, for a seeded
        # upstream gradient, on these tiles at K = 1024 and at K = 256
        g = torch.randn((3, HW, HW), generator=torch.Generator().manual_seed(SEED)
                        ).to(dev)
        check_gradients("random tiles, K=1024, backward vs plain autograd",
                        args, got, g, kw)
        kw256 = dict(kw, max_k=256)
        check_gradients("random tiles, K=256, backward vs plain autograd",
                        args, tile_blend.blend_tiles(*args, **kw256), g, kw256)
        # thin Gaussians near 45 degrees with alpha at the 1/255 cut
        cut = cut_lists(dev, 32, 32)
        kw_cut = dict(kw, max_k=4)
        cut_out = tile_blend.blend_tiles(*cut, **kw_cut)
        torch.cuda.synchronize()
        cut_want = tile_blend.blend_tiles_reference(*cut, **kw_cut)
        rtol_c, atol_c = tile_blend.kernel_tolerance(cut[6], cut[5])
        check_close("thin Gaussians at the cut, kernel vs plain", cut_out,
                    cut_want, rtol_c, atol_c)
        check_gradients("thin Gaussians at the cut, backward vs plain autograd",
                        cut, cut_out, g, kw_cut)
        if opts.baseline is not None:
            base_cut = baseline_launcher(opts.baseline, cut, kw_cut)()
            torch.cuda.synchronize()
            diff = (base_cut - cut_want).abs()
            log(f"  baseline on the thin Gaussians at the cut: max |diff| "
                f"{float(diff.max()):.3e}, "
                f"{int((diff > atol_c + rtol_c * cut_want.abs()).sum())} values "
                f"outside the tolerance (reported, not checked)")

    with Phase("scene"):
        scene = soak.build_scene(np.random.default_rng(SEED), HW, N_GT, N_CAMS,
                                 N_SEED, white_background=True, device=dev)
        torch.cuda.synchronize()
        log(f"  {len(scene.train_cameras)} train / {len(scene.test_cameras)} "
            f"test cameras at {HW}x{HW}, {scene.points.shape[0]} seed points")

    with Phase("serve"):
        cfg = hac.HACConfig(voxel_size=VOXEL_SIZE)
        points = hac.voxelize_points(scene.points, cfg.voxel_size, SEED)
        state = hac.update_anchor_bound(hac.init_state(
            cfg, points, np.random.default_rng(SEED), device=dev))
        cap = state["valid"].shape[0]
        spec = cfg.grid_spec
        log(f"  HAC state (seeded, untrained): {points.shape[0]} anchors in "
            f"capacity {cap}, {cap * cfg.n_offsets} neural Gaussians, "
            f"feat_dim {cfg.feat_dim}, n_offsets {cfg.n_offsets}, "
            f"{spec.xyz.n_rows + 3 * spec.plane.n_rows} table rows")
        torch.cuda.reset_peak_memory_stats()
        tile_blend.launches = 0
        res = pipeline.evaluate(state, cfg, scene.test_cameras, max_k=EVAL_K,
                                white_background=True)
        torch.cuda.synchronize()
        launches = tile_blend.launches
        log(f"  K={res['eval_k']} D={res['eval_d']}, tile_blend launches in "
            f"evaluate: {launches}, peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
        if launches == 0:
            raise RuntimeError("evaluate did not launch the tile_blend kernel")
        for name, v in res["per_view"].items():
            log(f"  view {name}: {v['ms']:.3f} ms after warm-up, PSNR "
                f"{v['psnr']:.3f} dB, SSIM {v['ssim']:.4f} (untrained state: "
                f"a smoke number, not a quality figure)")
        serve_psnr = res["psnr"]
        for img in res["renders"]:
            if img.shape != (3, HW, HW) or not bool(torch.isfinite(img).all()):
                raise RuntimeError(f"bad render: {tuple(img.shape)}")
            if float(img.min()) < -1e-5 or float(img.max()) > 1 + 1e-5:
                raise RuntimeError("render outside [0, 1]")

        # one whole frame, kernel against plain version on the same lists
        cam = scene.test_cameras[0]
        rcfg = pipeline._raster_cfg(cam, res["eval_k"], res["eval_d"])
        ca = hac_render.CameraArrays.from_camera(cam, dev)
        bg = torch.ones(3, device=dev)
        with torch.no_grad():
            visible = hac_render.prefilter_voxel(state, cfg, ca, rcfg)
            ng, _ = hac.generate_neural_gaussians(state, cfg, ca.camera_center,
                                                  visible)
            proj = raster.project(ng.xyz, ng.scaling, ng.rot, ca.viewmatrix,
                                  rcfg, ng.valid)
            tile_start, pair_gauss, _ = raster._build_tile_lists(proj, rcfg)
        frame = (tile_start, pair_gauss, proj.mean2d, proj.conic,
                 ng.opacity.reshape(-1), ng.color, bg)
        kw = dict(tiles_x=rcfg.tiles_x, height=HW, width=HW, max_k=rcfg.max_gaussians_per_tile)
        got = tile_blend.blend_tiles(*frame, **kw)
        torch.cuda.synchronize()
        if not torch.equal(got, res["renders"][0]):
            raise RuntimeError("frame re-blended from the same lists differs "
                               "from evaluate's render")
        want = tile_blend.blend_tiles_reference(*frame, **kw)
        rtol, atol = tile_blend.kernel_tolerance(bg, frame[5])
        frame_err = check_close("whole frame, kernel vs plain", got, want, rtol, atol)
        counts = tile_start[1:] - tile_start[:-1]
        log(f"  frame: {int(proj.radius.gt(0).sum())} Gaussians on screen, "
            f"{int(counts.sum())} pairs, {int(counts.gt(rcfg.max_gaussians_per_tile).sum())} "
            f"of {rcfg.n_tiles} tiles over K")
        shape = tile_blend.launch_shape(rcfg.n_tiles)
        log(f"  launch: {shape['blocks']} blocks x {shape['threads']} threads, "
            f"{shape['pix_per_thread']} pixels per thread, "
            f"{shape['shared_bytes']} B static shared memory, "
            f"{shape['blocks_per_sm']} resident blocks per SM, "
            f"{shape['registers']} registers")
        kernel_ms, host_ms = device_ms(
            lambda: tile_blend.blend_tiles(*frame, **kw), 20)
        events_ms = cuda_ms(lambda: tile_blend.blend_tiles(*frame, **kw), 20)
        plain_ms = cuda_ms(lambda: tile_blend.blend_tiles_reference(*frame, **kw), 3)
        bound_ms, bound_by, detail = blend_bound(*frame[:5], **kw)
        log(f"  tile_blend at the frame's shapes: kernel {kernel_ms:.4f} ms "
            f"(device time, behind a delay; host enqueue {host_ms:.4f} ms a "
            f"call; {events_ms:.4f} ms by CUDA events over 20 back-to-back "
            f"calls), plain {plain_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}: {detail})")
        per_tile, _ = entries_per_tile(*frame[:5], tiles_x=rcfg.tiles_x,
                                       max_k=kw["max_k"])
        mean_load = float(per_tile.double().mean())
        log(f"  per-tile load: largest {int(per_tile.max())}, mean "
            f"{mean_load:.1f} evaluated pixel-entries per tile (largest / "
            f"mean {int(per_tile.max()) / max(mean_load, 1e-9):.3f}), "
            f"{int((per_tile == per_tile.max()).sum())} tiles at the largest")
        sfu_ms = int(per_tile.sum()) / (SFU_EXP_PER_CLOCK * n_sms
                                        * max_sm_mhz * 1e6) * 1e3
        log(f"  SFU term beside the bound: {int(per_tile.sum())} exps at "
            f"{SFU_EXP_PER_CLOCK} a clock per SM x {n_sms} SMs at "
            f"{max_sm_mhz:g} MHz = {sfu_ms:.4f} ms")
        # the two kernels of a call, each alone, by the profiler's device
        # times over 20 calls
        _, _, top = device_profile(
            lambda: [tile_blend.blend_tiles(*frame, **kw) for _ in range(20)])
        for part in ("order_kernel", "blend_kernel"):
            hit = [(n, ms) for name, n, ms in top if part in name]
            log(f"  {part}: " + (f"{hit[0][1] / hit[0][0]:.4f} ms a launch "
                                 f"(torch.profiler, {hit[0][0]} launches)"
                                 if hit else "not measured (no device time "
                                 "in the profile)"))
        if opts.baseline is not None:
            base = baseline_launcher(opts.baseline, frame, kw)
            check_close("baseline, frame vs plain", base(), want, rtol, atol)
            turns = []
            for who in ("baseline", "kernel", "kernel", "baseline"):
                fn = base if who == "baseline" else (
                    lambda: tile_blend.blend_tiles(*frame, **kw))
                ms, host = device_ms(fn, 20)
                turns.append(ms)
                log(f"  turn {len(turns)}: {who} {ms:.4f} ms (host {host:.4f} ms)")
            log(f"  baseline {(turns[0] + turns[3]) / 2:.4f} ms, kernel "
                f"{(turns[1] + turns[2]) / 2:.4f} ms (means of the turns)")
        with torch.no_grad():
            stages = {
                "prefilter": lambda: hac_render.prefilter_voxel(
                    state, cfg, ca, rcfg),
                "context (hash grid + mlp_grid)": lambda: hac.grid_mlp_split(
                    state, cfg, hac.calc_interp_feat(
                        state, cfg, hac.get_anchor(state, cfg))),
                "neural Gaussians (context included)":
                    lambda: hac.generate_neural_gaussians(
                        state, cfg, ca.camera_center, visible),
                "project": lambda: raster.project(
                    ng.xyz, ng.scaling, ng.rot, ca.viewmatrix, rcfg, ng.valid),
                "tile lists (N*D sort)": lambda: raster._build_tile_lists(
                    proj, rcfg),
                "blend kernel": lambda: tile_blend.blend_tiles(*frame, **kw),
            }
            for name, fn in stages.items():
                log(f"  view stage {name}: {cuda_ms(fn, 5):.4f} ms "
                    f"(CUDA events over 5 back-to-back runs)")

            # one whole view (render_image, as evaluate times it), by three
            # clocks, and how much of it the card is busy
            def view():
                return hac_render.render_image(state, cfg, ca, rcfg, bg)
            walls = sorted(wall_ms(view, 10))
            log(f"  whole view, host wall clock with a sync at each end, 10 "
                f"runs: min {walls[0]:.4f}, median {walls[5]:.4f}, max "
                f"{walls[-1]:.4f} ms")
            log(f"  whole view, CUDA events over 10 back-to-back runs: "
                f"{cuda_ms(view, 10):.4f} ms")
            syncs = host_syncs(view)
            log(f"  whole view, host syncs: {sum(syncs.values())} "
                + ", ".join(f"{k} x{v}" for k, v in syncs.most_common()))
            busy, n_dev, top = device_profile(view)
            idle = (f"idle share {1 - busy / walls[5]:.4f} of the median wall "
                    f"clock" if n_dev else "idle share not measured")
            log(f"  whole view under torch.profiler: {n_dev} device "
                f"activities, device busy {busy:.4f} ms, {idle}")
            for name, n, ms in top:
                log(f"    {ms:9.4f} ms  x{n:<4d} {name[:100]}")

    with Phase("train"):
        tile_blend.launches = 0
        tile_blend.backward_launches = 0
        t0 = time.perf_counter()
        tstate, tcfg, topt, tres = soak.train(
            scene, TRAIN_STEPS, voxel_size=VOXEL_SIZE, white_background=True,
            log=lambda m: log(f"  {m}"), log_every=100, device=dev,
            **TRAIN_DENSIFY)
        torch.cuda.synchronize()
        train_wall = time.perf_counter() - t0
        train_launches = tile_blend.launches
        bwd_launches = tile_blend.backward_launches
        log(f"  {TRAIN_STEPS} steps in {train_wall:.3f} s "
            f"({train_wall / TRAIN_STEPS * 1e3:.3f} ms a step, densification "
            f"and cap checks included); tile_blend launches {train_launches}, "
            f"backward launches {bwd_launches}")
        if train_launches == 0 or bwd_launches == 0:
            raise RuntimeError("training did not launch both blend kernels")
        h = tres["history"]
        for ph in (0, 1, 2):
            sel = h["phase"] == ph
            log(f"  phase {ph}: {int(sel.sum())} steps, loss mean "
                f"{h['loss'][sel].mean():.5f} (first {h['loss'][sel][0]:.5f}, "
                f"last {h['loss'][sel][-1]:.5f}), train PSNR mean "
                f"{h['psnr'][sel].mean():.3f} dB, bits per parameter mean "
                f"{h['bit_per_param'][sel].mean():.4f}")
        if not np.isfinite(h["loss"]).all():
            raise RuntimeError("non-finite training loss")
        p0 = h["loss"][h["phase"] == 0]
        log(f"  phase 0 loss: first 50 steps {p0[:50].mean():.5f}, last 50 "
            f"{p0[-50:].mean():.5f}")
        if not p0[-50:].mean() < p0[:50].mean():
            raise RuntimeError("the phase-0 loss did not fall")
        if not (h["bit_per_param"][h["phase"] == 2] > 0).all():
            raise RuntimeError("bit_per_param is not > 0 in phase 2")
        for it, info in tres["densify"]:
            log(f"  densify at step {it}: {info['n_anchors']} anchors "
                f"(+{info['n_added']} / -{info['n_pruned']}), capacity grown: "
                f"{info['recompiled']}")
        if len(tres["densify"]) < 2:
            raise RuntimeError("fewer than two densifications")
        rcfg_t = tres["rcfg"]
        log(f"  raster caps after adapt_caps: " + (", ".join(
            f"step {it}: D={d} K={k}" for it, d, k in tres["caps"]) or "unchanged")
            + f"; final D={rcfg_t.max_tiles_per_gaussian} "
            f"K={rcfg_t.max_gaussians_per_tile}")
        log(f"  non-finite gradient components over the run: "
            f"{int(h['nonfinite_grads'].sum())}")
        trained = pipeline.evaluate(tstate, tcfg, scene.test_cameras,
                                    max_k=EVAL_K, white_background=True)
        for name, v in trained["per_view"].items():
            log(f"  held-out view {name} after training: PSNR {v['psnr']:.3f} "
                f"dB, SSIM {v['ssim']:.4f}")
        log(f"  held-out PSNR {trained['psnr']:.3f} dB trained, "
            f"{serve_psnr:.3f} dB untrained (serve phase, same views); K="
            f"{trained['eval_k']} D={trained['eval_d']}")
        if not trained["psnr"] > serve_psnr:
            raise RuntimeError("training did not raise the held-out PSNR")

        # the step alone, by phase: wall clock, CUDA events, profile
        optimizer = hac_train.make_optimizer(topt, scene.cameras_extent)
        step_fn = hac_train.make_train_step(tcfg, rcfg_t, optimizer, topt,
                                            white_background=True)
        params, rest = hac.split_state(tstate)
        box = {"opt": tres["opt_state"], "stats": tres["stats"]}
        step_cams = [hac_render.CameraArrays.from_camera(c, dev, with_image=True)
                     for c in scene.train_cameras[:4]]
        gen = torch.Generator(device=dev).manual_seed(SEED)
        turn = [0]

        def one_step(phase):
            cam = step_cams[turn[0] % len(step_cams)]
            turn[0] += 1
            _, box["opt"], box["stats"], _ = step_fn(
                params, rest, box["opt"], box["stats"], cam, phase=phase,
                generator=gen)

        step_ms = {}
        for ph in (0, 2):
            walls = sorted(wall_ms(lambda: one_step(ph), 10))
            events = cuda_ms(lambda: one_step(ph), 10)
            tile_blend.backward_launches = 0
            busy, n_dev, top = device_profile(lambda: one_step(ph))
            per_step = tile_blend.backward_launches
            step_ms[ph] = walls[5]
            log(f"  step at phase {ph}: host wall clock with a sync at each "
                f"end, 10 steps: min {walls[0]:.4f}, median {walls[5]:.4f}, max "
                f"{walls[-1]:.4f} ms; CUDA events over 10 back-to-back steps "
                f"{events:.4f} ms; backward launches in one step {per_step}")
            idle = (f"idle share {1 - busy / walls[5]:.4f} of the median wall "
                    f"clock" if n_dev else "idle share not measured")
            log(f"  one phase-{ph} step under torch.profiler: {n_dev} device "
                f"activities, device busy {busy:.4f} ms, {idle}")
            for name, n, ms in top:
                log(f"    {ms:9.4f} ms  x{n:<4d} {name[:100]}")
        syncs = host_syncs(lambda: one_step(0))
        log(f"  one step, host syncs: {sum(syncs.values())} "
            + ", ".join(f"{k} x{v}" for k, v in syncs.most_common()))

        # one training frame's lists (the trained state, training caps)
        cam = scene.train_cameras[0]
        ca = hac_render.CameraArrays.from_camera(cam, dev)
        bg = torch.ones(3, device=dev)

        def frame_of(rc, ca):
            with torch.no_grad():
                vis = hac_render.prefilter_voxel(tstate, tcfg, ca, rc)
                ngt, _ = hac.generate_neural_gaussians(
                    tstate, tcfg, ca.camera_center, vis, training=True, phase=0)
                pj = raster.project(ngt.xyz, ngt.scaling, ngt.rot,
                                    ca.viewmatrix, rc, ngt.valid)
                ts, pg, _ = raster._build_tile_lists(pj, rc)
            return (ts, pg, pj.mean2d, pj.conic, ngt.opacity.reshape(-1),
                    ngt.color, bg)

        frame_t = frame_of(rcfg_t, ca)
        kw_t = dict(tiles_x=rcfg_t.tiles_x, height=HW, width=HW,
                    max_k=rcfg_t.max_gaussians_per_tile)
        out_t = tile_blend.blend_tiles(*frame_t, **kw_t)
        torch.cuda.synchronize()
        rtol_t, atol_t = tile_blend.kernel_tolerance(bg, frame_t[5])
        check_close("trained frame, kernel vs plain", out_t,
                    tile_blend.blend_tiles_reference(*frame_t, **kw_t),
                    rtol_t, atol_t)
        g_t = torch.randn((3, HW, HW), generator=torch.Generator().manual_seed(SEED)
                          ).to(dev)
        bwd_err = check_gradients("trained frame, backward vs plain autograd",
                                  frame_t, out_t, g_t, kw_t)
        counts_t = frame_t[0][1:] - frame_t[0][:-1]
        log(f"  trained frame (train view 0, D={rcfg_t.max_tiles_per_gaussian} "
            f"K={kw_t['max_k']}): {int(counts_t.sum())} pairs, "
            f"{int(counts_t.gt(kw_t['max_k']).sum())} of {rcfg_t.n_tiles} tiles "
            f"over K, longest list {int(counts_t.max())}")
        shape_b = tile_blend.launch_shape(rcfg_t.n_tiles, backward=True)
        log(f"  backward launch: {shape_b['blocks']} blocks x "
            f"{shape_b['threads']} threads, {shape_b['blocks_per_sm']} resident "
            f"blocks per SM, {shape_b['registers']} registers")
        bwd_ms, bwd_host = device_ms(lambda: tile_blend.blend_tiles_backward(
            *frame_t, out_t, g_t, **kw_t), 20)
        leaves = [t.detach().requires_grad_(True) for t in frame_t[2:6]]
        with torch.enable_grad():
            ref_out = tile_blend.blend_tiles_reference(
                frame_t[0], frame_t[1], *leaves, bg, **kw_t)
        bwd_plain_ms = cuda_ms(lambda: torch.autograd.grad(
            ref_out, leaves, g_t, retain_graph=True), 3)
        del ref_out, leaves
        bwd_bound_ms, bwd_bound_by, bwd_detail = backward_bound(
            *frame_t[:5], **kw_t)
        log(f"  backward at the trained frame: kernel {bwd_ms:.4f} ms (device "
            f"time, behind a delay; host enqueue {bwd_host:.4f} ms a call), "
            f"plain (autograd of the plain version, backward only) "
            f"{bwd_plain_ms:.4f} ms, bound {bwd_bound_ms:.4f} ms "
            f"({bwd_bound_by}: {bwd_detail})")
        fwd_t_ms, _ = device_ms(lambda: tile_blend.blend_tiles(*frame_t, **kw_t), 20)
        fb_ms, fb_by, fb_detail = blend_bound(*frame_t[:5], **kw_t)
        log(f"  tile_blend at the trained frame: {fwd_t_ms:.4f} ms, bound "
            f"{fb_ms:.4f} ms ({fb_by}: {fb_detail})")
        # K1 re-timed on trained lists at the eval caps, held-out view 0 (the
        # serve phase's frame, with the trained state)
        cam_e = scene.test_cameras[0]
        rcfg_e = pipeline._raster_cfg(cam_e, EVAL_K, trained["eval_d"])
        frame_e = frame_of(rcfg_e, hac_render.CameraArrays.from_camera(cam_e, dev))
        kw_e = dict(tiles_x=rcfg_e.tiles_x, height=HW, width=HW, max_k=EVAL_K)
        counts_e = frame_e[0][1:] - frame_e[0][:-1]
        fwd_e_ms, _ = device_ms(lambda: tile_blend.blend_tiles(*frame_e, **kw_e), 20)
        fe_ms, fe_by, fe_detail = blend_bound(*frame_e[:5], **kw_e)
        per_tile_e, _ = entries_per_tile(*frame_e[:5], tiles_x=rcfg_e.tiles_x,
                                         max_k=EVAL_K)
        log(f"  tile_blend on trained lists at K={EVAL_K} D={trained['eval_d']} "
            f"(held-out view 0): {fwd_e_ms:.4f} ms, bound {fe_ms:.4f} ms "
            f"({fe_by}: {fe_detail}); {int(counts_e.gt(EVAL_K).sum())} of "
            f"{rcfg_e.n_tiles} tiles over K; per-tile load largest "
            f"{int(per_tile_e.max())}, mean {float(per_tile_e.double().mean()):.1f}")

    with Phase("reference"):
        # the whole slice on the card against the port's CPU path (plain
        # blend), which the CPU tests hold against the JAX package
        small = hac.HACConfig(**SMALL_CFG)
        runs, runs_device = {}, {}
        for d in (dev, torch.device("cpu")):
            sc = soak.build_scene(np.random.default_rng(SEED), 64, 300, 8, 2000,
                                  white_background=True, device=d)
            pts = hac.voxelize_points(sc.points, small.voxel_size, SEED)
            st = hac.update_anchor_bound(hac.init_state(
                small, pts, np.random.default_rng(SEED), device=d))
            runs[d.type] = (sc, pipeline.evaluate(st, small, sc.test_cameras,
                                                  max_k=256, white_background=True))
            runs_device[id(sc)] = d
        (sc_gpu, res_gpu), (sc_cpu, res_cpu) = runs["cuda"], runs["cpu"]
        for cg, cc in zip(sc_gpu.train_cameras + sc_gpu.test_cameras,
                          sc_cpu.train_cameras + sc_cpu.test_cameras):
            # the kernel's tolerance (white background, colours in [0, 1])
            # plus float32 differences in project
            rtol, atol = tile_blend.kernel_tolerance(torch.ones(3), torch.ones(3))
            check_close(f"small scene GT view {cg.uid}, card vs CPU",
                        torch.from_numpy(cg.image), torch.from_numpy(cc.image),
                        rtol, atol + REF_ATOL)
        for rg, rc in zip(res_gpu["renders"], res_cpu["renders"]):
            agree = float(img_lib.psnr(rg.cpu(), rc))
            log(f"  small HAC eval render, card vs CPU: PSNR {agree:.2f} dB "
                f"(limit {REF_PSNR_DB} dB), max |diff| "
                f"{float((rg.cpu() - rc).abs().max()):.3e}")
            if not agree >= REF_PSNR_DB:
                raise RuntimeError("card and CPU renders disagree")
        # a few training steps at phase 0 (no noise: the card's and the
        # CPU's generators draw different numbers) on each side
        steps = {}
        for sc in (sc_gpu, sc_cpu):
            d = runs_device[id(sc)]
            pts = hac.voxelize_points(sc.points, small.voxel_size, SEED)
            st = hac.update_anchor_bound(hac.init_state(
                small, pts, np.random.default_rng(SEED), device=d))
            params, rest = hac.split_state(st)
            o = hac_train.OptConfig(iterations=100)
            optimizer = hac_train.make_optimizer(o, sc.cameras_extent)
            ostate = optimizer.init(hac_train.param_leaves(params))
            stats = hac_train.zero_stats(rest["valid"].shape[0], small.n_offsets, d)
            step = hac_train.make_train_step(
                small, pipeline._raster_cfg(sc.train_cameras[0]), optimizer, o,
                white_background=True)
            w0 = params["nets"].mlp_color.fc1.weight.detach().clone()
            losses = []
            for i in range(REF_TRAIN_STEPS):
                cam = hac_render.CameraArrays.from_camera(
                    sc.train_cameras[i], d, with_image=True)
                params, ostate, stats, m = step(params, rest, ostate, stats,
                                                cam, phase=0)
                losses.append(float(m["loss"]))
            steps[d.type] = (losses, (params["nets"].mlp_color.fc1.weight.detach()
                                      - w0).cpu())
        (lg, dg), (lc, dc) = steps["cuda"], steps["cpu"]
        rel = float((dg - dc).norm() / dc.norm())
        log(f"  {REF_TRAIN_STEPS} training steps of the small scene, card vs "
            f"CPU: losses {[f'{x:.6f}' for x in lg]} vs "
            f"{[f'{x:.6f}' for x in lc]} (rtol {REF_LOSS_RTOL}); mlp_color "
            f"output weight change differs by {rel:.3e} of its norm (limit "
            f"{REF_LEAF_RTOL})")
        if not np.allclose(lg, lc, rtol=REF_LOSS_RTOL, atol=0):
            raise RuntimeError("card and CPU training losses disagree")
        if not rel <= REF_LEAF_RTOL:
            raise RuntimeError("card and CPU training steps disagree")

    log(json.dumps({"kernels": [{
        "name": "tile_blend",
        "route": "cuda",
        "source": "gauspcc_tpu_torch/csrc/tile_blend.cu",
        "replaces": "gauspcc_tpu/render/pallas_blend.py:46",
        "launches": launches,
        "max_abs_err": frame_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }, {
        "name": "tile_blend_backward",
        "route": "cuda",
        "source": "gauspcc_tpu_torch/csrc/tile_blend.cu",
        "replaces": "gauspcc_tpu/render/raster.py:264",
        "launches": bwd_launches,
        "max_abs_err": bwd_err,
        "ms": bwd_ms,
        "plain_ms": bwd_plain_ms,
        "bound_ms": bwd_bound_ms,
        "bound_by": bwd_bound_by,
        "library_ms": None,
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
