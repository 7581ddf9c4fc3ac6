"""What the per-layer metrics share: the traced window's K1 kernel times
and the shares worked out from them."""

from __future__ import annotations


def k1_times_ms(run) -> tuple[list, list]:
    """(forward ms, backward ms) of each K1 call in the traced window, in
    order: a call is its `order_kernel` and the `blend_kernel` or
    `backward_kernel` that follows it."""
    fwd, bwd, pending = [], [], 0.0
    for name, a, b in run.kernels:
        ms = (b - a) / 1e6
        if "order_kernel" in name:
            pending += ms
        elif "blend_kernel" in name:
            fwd.append(pending + ms)
            pending = 0.0
        elif "backward_kernel" in name:
            bwd.append(pending + ms)
            pending = 0.0
    return fwd, bwd


def roofline_pct(bounds_ms, times_ms):
    """The calls' least time over their measured time, in %, over the calls
    whose inputs were kept (the first ones of the window); None if none."""
    n = min(len(bounds_ms or []), len(times_ms))
    if n == 0:
        return None
    return 100.0 * sum(bounds_ms[:n]) / sum(times_ms[:n])


def idle_pct(run):
    return 100.0 * (1.0 - run.busy_s / run.window_s)


def launches_per_unit(run):
    return len(run.kernels) / run.units if run.units else None


def mfu_pct(run):
    ops = run.info.get("ops_per_unit")
    if not ops:
        return None
    return 100.0 * ops * run.units / run.window_s / run.info["peak_flops"]


def per_unit_roofline_pct(run, bound_key: str, kernel: str):
    """A unit's least time for `kernel`'s work (info[bound_key], the same
    for every unit of the window) over the kernel's profiled time per unit,
    in %; None without such kernels."""
    bound = run.info.get(bound_key)
    ms = sum((b - a) / 1e6 for name, a, b in run.kernels if kernel in name)
    if not bound or not ms or not run.units:
        return None
    return 100.0 * bound * run.units / ms
