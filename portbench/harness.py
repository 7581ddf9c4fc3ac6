"""The data-driven core of the benchmark: cells, configurations, drivers
and per-layer metrics resolved by name from files, one run of a cell, and
the reading of its trace.

A driver module (portbench/drivers/<driver>.py) has

    setup(cell: CellSpec, seed: int, device) -> a session with
        .window(seconds: float, trace: bool) -> Window
        .release()   # frees the program's state once the window is read
        .check() -> list[Check]   # the plain reference's comparison

A per-layer metric module (portbench/layer_metrics/<metric>.py) has
`read(run: TracedRun) -> float | None` and returns None where the cell gives
it nothing to read (the harness then leaves the metric out).
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Any

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
SETUP_MARKS: list = []  # (phase, host clock at its end) while setting up


def mark(phase: str) -> None:
    """Note the end of a set-up phase (printed to stderr by run_cell)."""
    SETUP_MARKS.append((phase, time.perf_counter()))


@dataclass
class CellSpec:
    name: str
    config_name: str
    config: dict
    traffic: dict
    driver: str
    chips: int
    end_to_end: list  # BENCHMARK.json entries that this cell reports
    per_layer: list
    limits: dict  # the workload file's limits of `correct`, over the driver's


@dataclass
class Check:
    """One number that decides `correct`: it passes while value <= limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclass
class Window:
    """What a measured window gives: its units of work (steps, views,
    round trips), their failures, the end-to-end values by metric name and
    the window's length. A traced run's readers get the rest from the
    session's `trace_info()`, worked out after the profiler has stopped."""

    attempted: int
    failed: int
    values: dict
    seconds: float


@dataclass
class TracedRun:
    """What a per-layer metric reads: the device events of the traced
    window (name, start ns, end ns), its length, the device's busy seconds,
    the units of work done in it, and the traffic driver's own records."""

    cell: CellSpec
    kernels: list
    window_s: float
    busy_s: float
    units: int
    info: dict


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _json(ROOT / "BENCHMARK.json")


def _reported(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(name: str, bench: dict | None = None, base: Path = HERE,
              root: Path = ROOT) -> CellSpec:
    """The cell `name` of BENCHMARK.json, with its workload file (under
    `base`/workloads), its configuration file (its path is relative to
    `root`) and the metrics it reports."""
    bench = benchmark() if bench is None else bench
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"unknown workload {name!r}")
    wl = _json(base / "workloads" / f"{name}.json")
    conf_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    conf = _json(root / conf_entry["file"])
    return CellSpec(
        name=name, config_name=entry["config"], config=conf,
        traffic=wl["traffic"], driver=wl["driver"], chips=entry["chips"],
        end_to_end=[m for m in bench["end_to_end"] if _reported(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reported(m, name)],
        limits=dict(wl.get("limits", {})))


def _module(kind: str, name: str, base: Path = HERE) -> ModuleType:
    """<base>/<kind>/<name>.py, imported by path (names may hold dots)."""
    path = base / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.{kind}.{name.replace('.', '__')}", path)
    if spec is None or not path.exists():
        raise SystemExit(f"no {kind[:-1]} file {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str, base: Path = HERE) -> ModuleType:
    return _module("drivers", name, base)


def metric_reader(name: str, base: Path = HERE) -> ModuleType:
    return _module("layer_metrics", name, base)


def sync(device) -> None:
    """Wait for the card (a no-op on the CPU)."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def moved_leaves(grads: dict) -> list:
    """The leaves a training check compares: those whose reference
    gradient is at least a thousandth of the median leaf's. A leaf no loss
    term reaches (HAC's deform MLP) moves under Adam by round-off alone."""
    import numpy as np
    import torch

    norms = {k: float(torch.linalg.norm(v.double())) for k, v in grads.items()}
    med = float(np.median(list(norms.values())))
    return [k for k, v in norms.items() if v >= 1e-3 * med]


def leaf_norm_gaps(prog: dict, refs: dict, keep) -> tuple[float, str, float]:
    """(worst gap, its leaf, the median leaf's gap) of | ||prog[leaf]|| -
    ||ref[leaf]|| | over max(||ref[leaf]||, the median leaf's norm), over
    the leaves `keep`. A NaN reads as infinite."""
    import numpy as np
    import torch

    norms = {k: float(torch.linalg.norm(refs[k].double())) for k in keep}
    med = float(np.median(list(norms.values())))
    gaps = {}
    for k in keep:
        gap = abs(float(torch.linalg.norm(prog[k].double())) - norms[k]) / max(
            norms[k], med)
        gaps[k] = gap if gap == gap else float("inf")
    at = max(gaps, key=gaps.get)
    return gaps[at], at, float(np.median(list(gaps.values())))


def change_gaps(w0: dict, got1: dict, ref1: dict, got: dict, ref: dict,
                g1: dict, keep, group_of) -> dict:
    """The parameters' change against the reference's, by leaf_norm_gaps.
    `step1`: the worst leaf after the first step. From zero moments Adam's
    first update is lr * g / (|g| + eps) a component, about lr * sign(g),
    so a leaf's norm counts its moved components and its rate alone: a
    leaf or a group with a wrong rate reads the gap of its rate. `median`
    and `worst` (with `worst_leaf`): the leaves after the last step.
    `group_worst` (with `group`): the worst over the groups (`group_of`) of
    the group's median leaf after the last step. For the worst leaf after
    the last step: the share of its components whose change has opposite
    signs on the two sides (`worst_flips`), their share of the squared gap
    of the changes (`worst_flip_gap`), and the share of that gap in
    components whose first reference gradient is under a hundredth of the
    leaf's root mean square (`worst_small_g_gap`)."""
    import numpy as np
    import torch

    d1_got = {k: got1[k] - w0[k] for k in keep}
    d1_ref = {k: ref1[k] - w0[k] for k in keep}
    step1, step1_leaf, _ = leaf_norm_gaps(d1_got, d1_ref, keep)
    d_got = {k: got[k] - w0[k] for k in keep}
    d_ref = {k: ref[k] - w0[k] for k in keep}
    worst, worst_leaf, median = leaf_norm_gaps(d_got, d_ref, keep)
    groups: dict = {}
    for k in keep:
        groups.setdefault(group_of(k), []).append(k)
    norms = {k: float(torch.linalg.norm(d_ref[k].double())) for k in keep}
    med = float(np.median(list(norms.values())))
    per_group = {}
    for name, ks in groups.items():
        per_group[name] = float(np.median([
            abs(float(torch.linalg.norm(d_got[k].double())) - norms[k])
            / max(norms[k], med) for k in ks]))
    group = max(per_group, key=per_group.get)
    a, b = d_got[worst_leaf].double(), d_ref[worst_leaf].double()
    diff2 = (a - b) ** 2
    total = max(float(diff2.sum()), 1e-300)
    flips = (torch.sign(a) * torch.sign(b)) < 0
    g = g1[worst_leaf].double().abs()
    small = g < 1e-2 * torch.sqrt((g ** 2).mean())
    return {"step1": step1, "step1_leaf": step1_leaf, "median": median,
            "worst": worst, "worst_leaf": worst_leaf,
            "group_worst": per_group[group], "group": group,
            "worst_flips": float(flips.double().mean()),
            "worst_flip_gap": float(diff2[flips].sum()) / total,
            "worst_small_g_gap": float(diff2[small].sum()) / total}


# ---------------------------------------------------------------------------
# the trace
# ---------------------------------------------------------------------------

def _is_kernel(name: str) -> bool:
    return not (name.startswith("Memcpy") or name.startswith("Memset"))


def device_events(prof) -> tuple[list, list]:
    """(device events, host events) of a torch.profiler run, each as
    (name, start ns, end ns), sorted by start."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        item = (e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
        (dev if e.device_type() == DeviceType.CUDA else host).append(item)
    dev.sort(key=lambda t: t[1])
    host.sort(key=lambda t: t[1])
    return dev, host


def busy_ns(events) -> float:
    """The union of the device events' intervals (chip_smoke.py:595-620,
    `device_profile`)."""
    busy, end = 0.0, float("-inf")
    for _, a, b in events:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def breakdown(dev_events, host_events, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps of the device, each named by the innermost host operation running
    at its middle."""
    per_name: dict[str, float] = {}
    for name, a, b in dev_events:
        per_name[name] = per_name.get(name, 0.0) + (b - a)
    ops = sorted(per_name.items(), key=lambda t: -t[1])[:top]
    gaps, end = [], None
    for _, a, b in dev_events:
        if end is not None and a > end:
            gaps.append((a - end, end, a))
        end = b if end is None else max(end, b)
    gaps.sort(key=lambda t: -t[0])
    named = []
    for length, a, b in gaps[:top]:
        mid = (a + b) / 2
        inner = [h for h in host_events if h[1] <= mid <= h[2]]
        label = (min(inner, key=lambda h: h[2] - h[1])[0] if inner
                 else "host: Python outside any torch op")
        named.append([label, length / 1e9])
    return {"device_ops": [[n, t / 1e9] for n, t in ops], "idle_gaps": named}


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------

def _device_info(torch, device, trace_info: dict | None) -> dict:
    import subprocess

    dev = torch.device(device)
    info: dict[str, Any] = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                            "kind": (torch.cuda.get_device_name(dev)
                                     if dev.type == "cuda" else "cpu"),
                            "count": 1,
                            "memory_peak_bytes": (
                                int(torch.cuda.max_memory_allocated(dev))
                                if dev.type == "cuda" else 0)}
    if dev.type == "cuda":
        try:
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
                 f"--id={dev.index or 0}"], capture_output=True, text=True,
                timeout=20).stdout.strip()
            info["power_limit"] = out
        except (OSError, subprocess.SubprocessError):
            info["power_limit"] = "unknown"
    if trace_info is not None:
        info.update(trace_info)
    return info


def run_cell(spec: CellSpec, *, seed: int, seconds: float, trace: bool,
             t_start: float, device="cuda") -> dict:
    """Set up, measure, check. Returns the result object (with the stderr
    lines to print under "_stderr_lines")."""
    import torch

    session = driver(spec.driver).setup(spec, seed, device)
    sync(device)
    mark("driver")
    setup_s = time.perf_counter() - t_start
    prev, phases = t_start, []
    for phase, t in SETUP_MARKS:
        phases.append(f"{phase} {t - prev:.3f}")
        prev = t
    SETUP_MARKS.clear()
    metrics: dict[str, dict] = {}
    breakdown_out = None
    trace_info = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            win = session.window(seconds, trace=True)
        dev_ev, host_ev = device_events(prof)
        kernels = [e for e in dev_ev if _is_kernel(e[0])]
        busy_s = busy_ns(dev_ev) / 1e9
        info = session.trace_info() if hasattr(session, "trace_info") else {}
        run = TracedRun(spec, kernels, win.seconds, busy_s, win.attempted,
                        info)
        for m in spec.per_layer:
            value = metric_reader(m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        breakdown_out = breakdown(dev_ev, host_ev)
        trace_info = {"busy_s": busy_s, "window_s": win.seconds}
        print("trace info: " + json.dumps(info, default=str), file=sys.stderr)
        del prof, run
    else:
        win = session.window(seconds, trace=False)
        for m in spec.end_to_end:
            if m["name"] in win.values:
                metrics[m["name"]] = {"value": win.values[m["name"]],
                                      "unit": m["unit"]}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    device_info = _device_info(torch, device, trace_info)
    session.release()
    checks = session.check()
    correct = bool(checks) and all(c.ok for c in checks) and win.failed == 0
    result = {"correct": correct, "attempted": win.attempted,
              "failed": win.failed, "metrics": metrics, "device": device_info}
    if breakdown_out is not None:
        result["breakdown"] = breakdown_out
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in checks}
    result["_stderr_lines"] = ["setup phases (s): " + ", ".join(phases)] + [
        f"check {c.name}: {c.value!r} (limit {c.limit!r})"
                               + ("" if c.ok else " FAILED") for c in checks]
    return result
