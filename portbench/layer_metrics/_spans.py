"""What the readers of the program's own spans share: the recorder of
gauspcc_tpu_torch.utils.profiling, which records while the traced window's
profiler runs. Each returns None where there is nothing to read: no such
span in the window, or a program without the recorder."""

from __future__ import annotations

from gauspcc_tpu_torch.utils import profiling


def _spans():
    read = getattr(profiling, "spans", None)
    return read() if read is not None else []


def _root_names(spans) -> dict:
    names = {s.id: s.name for s in spans}
    return {s.id: names[s.root] for s in spans}


def device_ms_per_unit(run, name: str, root: str):
    """The device ms between the edges of the spans `name` under a root
    span `root`, summed, per unit of work."""
    spans = _spans()
    roots = _root_names(spans)
    ms = [s.device_ms for s in spans
          if s.name == name and roots[s.id] == root and s.device_ms is not None]
    if not ms or not run.units:
        return None
    return sum(ms) / run.units


def count_per_unit(run, counter: str, roots: set):
    """The counter `counter` over every span under a root named in
    `roots`, per unit of work."""
    spans = _spans()
    names = _root_names(spans)
    under = [s for s in spans if names[s.id] in roots]
    if not under or not run.units:
        return None
    return sum(s.counters.get(counter, 0) for s in under) / run.units


def _union(intervals) -> list:
    out: list = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def idle_gaps(kernels) -> list:
    """The gaps between the merged intervals of the window's kernels, as
    (start ns, end ns)."""
    merged = _union((a, b) for _, a, b in kernels)
    return [(x[1], y[0]) for x, y in zip(merged, merged[1:])]


def host_idle_ms_per_unit(run, names: set):
    """The device's idle ms (gaps between kernels) that fall inside the
    host intervals of the spans named in `names`, per unit of work."""
    spans = [(s.start_ns, s.end_ns) for s in _spans()
             if s.name in names and s.end_ns is not None]
    if not spans or not run.kernels or not run.units:
        return None
    host = _union(spans)
    total, i = 0, 0
    for a, b in idle_gaps(run.kernels):
        while i < len(host) and host[i][1] <= a:
            i += 1
        j = i
        while j < len(host) and host[j][0] < b:
            total += min(b, host[j][1]) - max(a, host[j][0])
            j += 1
    return total / 1e6 / run.units
