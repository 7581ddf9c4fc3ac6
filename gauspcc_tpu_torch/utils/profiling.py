"""Tracing and profiling (counterpart of gauspcc_tpu/utils/profiling.py:
`PhaseTimer` :19, `device_memory_stats` :58, `trace` :76).

Named phase timers that wait for the device at both edges, so the wall
clock of a phase is its device work too; per-device memory in use and
its peak; a `torch.profiler` trace with CPU and CUDA activities written
as a Chrome trace (chrome://tracing, Perfetto).

The recorder: spans and counters inside the program, on while a torch
profiler runs (`torch.autograd.profiler._is_profiler_enabled`: under
`trace`, or any `torch.profiler.profile`) and off otherwise, with no
setting of its own. `span(name)` marks a unit of work or a layer of it (a
context manager, or a decorator where the function is defined); `count`
adds to a counter of the innermost open span; `spans()`, `counters()`
read what the profiled regions recorded since `reset()` cleared it. A
span keeps its name, its parent, its root (the outermost span open when it
began: a step, a view, an encode), its host interval on the clock of the
profiler's events (`time.time_ns()`, which kineto's `start_ns()` follow),
so it compares directly with a trace's intervals, and on a CUDA device a
pair of timing events recorded on the current stream at its edges, read
only by `spans()`. While on, the recorder also counts the host's blocking
waits on the device (counter "syncs"): torch's sync debug mode warns at
each one, and the recorder counts the warnings without showing them.

Off, a span reads one flag: it records no event, takes no clock, makes
no object and never synchronises. On, it still synchronises nothing and
launches no kernel (an event record is not a kernel), and it makes no
profiler event: no `record_function`, NVTX range or annotation, which a
trace would count among its device events. Spans and counts come from one
thread at a time (a backward's hooks run while the thread that started
it waits).
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
import warnings
from collections import defaultdict
from typing import Any, NamedTuple

import torch
import torch.autograd.profiler as _profiler

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
    the profiler (its `key_averages()` sums the kernels by name). The
    recorder runs meanwhile: `spans()` and `counters()` read the block's
    spans afterwards."""
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
    recording()  # the profiler has stopped: the recorder goes off
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------

_SYNC_WARNING = "called a synchronizing CUDA operation"


class Mark(NamedTuple):
    """A point in time: `ns` on the host (the profiler's clock) and, on a
    CUDA device, a timing event recorded on the current stream."""

    ns: int
    event: Any = None


def mark(device: torch.device | None = None) -> Mark:
    """Now, on the host and on `device`'s timeline: a timing event on the
    current stream when `device` is a CUDA device (by default, when CUDA
    is up). Nothing waits."""
    cuda = (torch.cuda.is_initialized() if device is None
            else device.type == "cuda")
    event = None
    if cuda:
        event = torch.cuda.Event(enable_timing=True)
        event.record()
    return Mark(time.time_ns(), event)


def elapsed_ms(a: Mark, b: Mark) -> float:
    """Milliseconds from `a` to `b`: on the device between their events
    (waiting for `b`'s), else on the host clock."""
    if a.event is not None and b.event is not None:
        b.event.synchronize()
        return float(a.event.elapsed_time(b.event))
    return (b.ns - a.ns) / 1e6


class Span(NamedTuple):
    """One recorded span: ids count from 0 after a reset; `parent` is None
    for a root, whose `root` is its own id. Host times are ns on the
    profiler's clock; `device_ms` is the time between its events (None off
    the card, or for a span left open); `counters` are its own counts."""

    name: str
    id: int
    parent: int | None
    root: int
    start_ns: int
    end_ns: int | None
    device_ms: float | None
    counters: dict


class _Record:
    __slots__ = ("name", "id", "parent", "root", "start", "end", "counters",
                 "opener", "device_ms")

    def __init__(self, name, id_, parent, root, start, opener):
        self.name, self.id, self.parent, self.root = name, id_, parent, root
        self.start, self.end, self.opener = start, None, opener
        self.counters: dict[str, int] = {}
        self.device_ms = None


class _Recorder:
    """What is recorded, the spans open now (innermost last), the counts
    made outside any span, the hooks of backward spans, and what switching
    on changed (the sync debug mode, the warning filter it added, the
    warning display it replaced)."""

    def __init__(self):
        self.on = False
        self.records: list[_Record] = []
        self.stack: list[_Record] = []
        self.loose: dict[str, int] = {}
        self.hooks: list = []  # [handles, done] of each backward span
        self.mode = None  # the sync debug mode that "warn" replaced
        self.filter = None  # the warning filter switching on added
        self.show = None  # the warning display it replaced

    def clear(self) -> None:
        self.records, self.stack, self.loose = [], [], {}

    def open(self, name: str, opener, push: bool = True,
             start: Mark | None = None) -> _Record:
        """Begin a span now, or at `start`, a mark already taken."""
        if not self.on:
            self.switch_on()
        elif self.mode is None:
            self.watch_syncs()
        parent = self.stack[-1] if self.stack else None
        rec = _Record(name, len(self.records),
                      None if parent is None else parent.id,
                      len(self.records) if parent is None else parent.root,
                      mark() if start is None else start, opener)
        self.records.append(rec)
        if push:
            self.stack.append(rec)
        return rec

    def close(self, opener) -> None:
        """End the innermost span `opener` opened, and any left open inside
        it."""
        for i in range(len(self.stack) - 1, -1, -1):
            if self.stack[i].opener is opener:
                end = mark()
                for rec in self.stack[i:]:
                    rec.end = end
                del self.stack[i:]
                return

    def count(self, name: str, n: int) -> None:
        target = self.stack[-1].counters if self.stack else self.loose
        target[name] = target.get(name, 0) + n

    def switch_on(self) -> None:
        """Record, and count syncs."""
        before = list(warnings.filters)
        warnings.filterwarnings("always", message=_SYNC_WARNING)
        self.filter = None if warnings.filters[0] in before else warnings.filters[0]
        self.show = warnings.showwarning
        warnings.showwarning = _show_warning
        self.on = True
        self.watch_syncs()

    def watch_syncs(self) -> None:
        """Turn the sync debug mode to "warn" once CUDA is up (at switching
        on, or at a span opened after CUDA started)."""
        if torch.cuda.is_initialized():
            self.mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")

    def switch_off(self) -> None:
        """Keep what was recorded; undo what switching on did (the sync
        debug mode, its own warning filter and display; filters added
        meanwhile stay) and remove the backward spans' hooks."""
        self.on = False
        self.stack = []
        for handles, _ in self.hooks:
            for h in handles:
                h.remove()
        self.hooks = []
        if self.mode is not None:
            torch.cuda.set_sync_debug_mode(self.mode)
        if self.filter is not None and self.filter in warnings.filters:
            warnings.filters.remove(self.filter)
            if hasattr(warnings, "_filters_mutated"):
                warnings._filters_mutated()
        if warnings.showwarning is _show_warning:
            warnings.showwarning = self.show
        self.mode = self.filter = self.show = None


_REC = _Recorder()


def _show_warning(message, category, filename, lineno, file=None, line=None):
    """The warning display while the recorder is on: a sync is counted,
    any other warning shown as before."""
    if str(message).startswith(_SYNC_WARNING):
        count("syncs")
        return None
    show = _REC.show or warnings._showwarning_orig
    return show(message, category, filename, lineno, file, line)


def recording() -> bool:
    """Whether the recorder is on, that is whether a torch profiler runs.
    The recorder follows the profiler at its own calls: it switches on at
    its first call inside a profiled region and off at its first call after
    one (or when `trace` exits)."""
    if _profiler._is_profiler_enabled:
        if not _REC.on:
            _REC.switch_on()
        return True
    if _REC.on:
        _REC.switch_off()
    return False


class _Span:
    """`span(name)`: one object per name, so that a span off makes none."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        if _profiler._is_profiler_enabled:
            _REC.open(self.name, self)
        elif _REC.on:
            _REC.switch_off()
        return self

    def __exit__(self, *exc) -> bool:
        if _REC.stack:  # empty while off
            _REC.close(self)
        return False

    def __call__(self, fn):
        """As a decorator: every call of `fn` is a span."""

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with self:
                return fn(*args, **kwargs)

        return spanned


_SPANS: dict[str, _Span] = {}


def span(name: str) -> _Span:
    """A span named `name` around a block (`with span(name):`) or every
    call of a function (`@span(name)`)."""
    s = _SPANS.get(name)
    if s is None:
        s = _SPANS.setdefault(name, _Span(name))
    return s


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name` of the innermost open span (or of no
    span, outside every span); nothing while the recorder is off."""
    if _profiler._is_profiler_enabled:
        if not _REC.on:
            _REC.switch_on()
        _REC.count(name, n)
    elif _REC.on:
        _REC.switch_off()


def add_span(name: str, start: Mark, end: Mark) -> None:
    """Record a span that ran from `start` to `end` (marks already taken,
    as a phase timer takes them), under the innermost open span; nothing
    while the recorder is off."""
    if recording():
        _REC.open(name, None, push=False, start=start).end = end


def backward_span(name: str, start: torch.Tensor, ends) -> None:
    """A span inside a backward pass, from the moment the gradient of
    `start` is computed to the moment the last gradient of `ends` is, under
    the span open when it begins; it is pushed on no stack, so counts made
    meanwhile go to that span. Tensor hooks that record a mark and return
    None, so no gradient changes and no kernel runs; registered only while
    the recorder is on, and removed once spent or when it goes off."""
    if not recording() or not start.requires_grad:
        return
    ends = [t for t in ends if t.requires_grad]
    for spent in [h for h in _REC.hooks if h[1]]:
        for h in spent[0]:
            h.remove()
        _REC.hooks.remove(spent)
    state: dict[str, Any] = {"rec": None, "left": len(ends)}
    entry: list = [[], False]

    def begin(grad):
        if _REC.on and state["rec"] is None:
            state["rec"] = _REC.open(name, state, push=False)

    def end(grad):
        state["left"] -= 1
        if state["left"] == 0:
            rec = state["rec"]
            if rec is not None and _REC.on:
                rec.end = mark()
            entry[1] = True

    entry[0].append(start.register_hook(begin))
    entry[0].extend(t.register_hook(end) for t in ends)
    _REC.hooks.append(entry)


def _device_ms(rec: _Record) -> float | None:
    if rec.device_ms is None and rec.end is not None \
            and rec.start.event is not None and rec.end.event is not None:
        rec.device_ms = elapsed_ms(rec.start, rec.end)
    return rec.device_ms


def spans() -> list[Span]:
    """The spans recorded since `reset()`, in the order they began. Reading
    a span's device time waits for its end event: read after the profiled
    region's closing synchronise."""
    recording()
    return [Span(r.name, r.id, r.parent, r.root, r.start.ns,
                 None if r.end is None else r.end.ns, _device_ms(r),
                 dict(r.counters)) for r in _REC.records]


def counters() -> dict[str, int]:
    """Every counter recorded since `reset()`, summed over the spans and
    the counts made outside any span."""
    recording()
    out = dict(_REC.loose)
    for r in _REC.records:
        for k, v in r.counters.items():
            out[k] = out.get(k, 0) + v
    return out


def reset() -> None:
    """Forget what was recorded (a span open now is forgotten too)."""
    _REC.clear()
