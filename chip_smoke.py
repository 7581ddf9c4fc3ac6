"""Smoke run of the PyTorch/CUDA port (`gauspcc_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--baseline FILE]

Phases, each printed with its wall time; any failure ends the run with a
non-zero exit and no result line:

  device  the card's name and power limit (nvidia-smi); no CUDA -> exit 1
  build   nvcc builds every kernel of the port from gauspcc_tpu_torch/csrc
  kernel  the tile-blend kernel against its plain PyTorch version on random
          tiles at K = 1024 (empty tiles, short ones, tiles over K)
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
          torch.profiler; with --baseline FILE, an earlier tile_blend.cu
          with the one-block-per-tile C interface (tile_blend_forward: 7
          pointers, 5 ints, out, stream) is built, checked and timed beside
          the kernel, in turns (baseline, kernel, kernel, baseline)
  reference  the whole slice at small widths on a 64x64 scene, on the card
          and through the port's CPU path, compared

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


def baseline_launcher(path: Path, frame, kw):
    """fn() -> image of an earlier tile_blend.cu (one block per tile, C
    interface tile_blend_forward(7 pointers, 5 ints, out, stream)) on the
    frame's lists."""
    built = native.load_source(path)
    log(f"  baseline {path}: nvcc {built.seconds:.3f} s")
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  baseline ptxas: {line.strip()}")
    fn = built.lib.tile_blend_forward
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    args = [t.contiguous() for t in frame]
    n_tiles = args[0].shape[0] - 1

    def run():
        out = torch.empty((3, kw["height"], kw["width"]), device=args[0].device)
        rc = fn(*[t.data_ptr() for t in args], n_tiles, kw["tiles_x"],
                kw["height"], kw["width"], kw["max_k"], out.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
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
        for line in built.log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")

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
            ng = hac.generate_neural_gaussians(state, cfg, ca.camera_center,
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

    with Phase("reference"):
        # the whole slice on the card against the port's CPU path (plain
        # blend), which the CPU tests hold against the JAX package
        small = hac.HACConfig(**SMALL_CFG)
        runs = {}
        for d in (dev, torch.device("cpu")):
            sc = soak.build_scene(np.random.default_rng(SEED), 64, 300, 8, 2000,
                                  white_background=True, device=d)
            pts = hac.voxelize_points(sc.points, small.voxel_size, SEED)
            st = hac.update_anchor_bound(hac.init_state(
                small, pts, np.random.default_rng(SEED), device=d))
            runs[d.type] = (sc, pipeline.evaluate(st, small, sc.test_cameras,
                                                  max_k=256, white_background=True))
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
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
