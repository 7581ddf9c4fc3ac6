"""Tracing and profiling (counterpart of gauspcc_tpu/utils/profiling.py:
`PhaseTimer` :19, `device_memory_stats` :58, `trace` :76).

Named phase timers that wait for the device at both edges, so the wall
clock of a phase is its device work too; per-device memory in use and
its peak; a `torch.profiler` trace with CPU and CUDA activities written
as a Chrome trace (chrome://tracing, Perfetto).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch

from gauspcc_tpu_torch.device import resolve


class PhaseTimer:
    """Accumulating named timers: `with timer.phase("feat"): ...`. On a
    CUDA device the timer synchronises that device at both edges of a
    phase; on the CPU there is nothing to wait for."""

    def __init__(self, device="cuda"):
        self.device = resolve(device)
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def phase(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> str:
        return ", ".join(f"{k} {self.totals[k]:.3f}s/{self.counts[k]}x"
                         for k in sorted(self.totals))

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()


def device_memory_stats() -> dict:
    """{"cuda:<i>": {bytes_in_use, peak_bytes_in_use}} for every CUDA
    device (torch's caching allocator's allocated bytes, now and at their
    peak); {} without CUDA, as the JAX package's on the CPU."""
    if not torch.cuda.is_available():
        return {}
    out = {}
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": s.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": s.get("allocated_bytes.all.peak", 0),
        }
    return out


@contextlib.contextmanager
def trace(log_dir: str, device="cuda"):
    """Profile the block with torch.profiler, CPU activities and, on a
    CUDA device, CUDA activities, and write `log_dir/trace.json`; yields
    the profiler (its `key_averages()` sums the kernels by name)."""
    from torch.profiler import ProfilerActivity, profile

    dev = resolve(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
