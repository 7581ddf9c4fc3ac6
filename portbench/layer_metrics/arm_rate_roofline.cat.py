"""The ARMs' rate of the planes: its least time on the H100 (counts/arm_rate.py,
forward and backward) over the device ms of its two spans a step (%)."""

from portbench.layer_metrics import _spans


def read(run):
    bound = run.info.get("arm_rate_bound_ms")
    parts = [_spans.device_ms_per_unit(run, name, "hac.step")
             for name in ("cat.arm_rate", "cat.arm_rate.bwd")]
    if not bound or None in parts or not sum(parts):
        return None
    return 100.0 * bound / sum(parts)
