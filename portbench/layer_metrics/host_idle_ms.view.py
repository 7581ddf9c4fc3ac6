"""Device-idle ms a view inside the host's frame conversion (span
gui.frame_bytes)."""

from portbench.layer_metrics import _spans


def read(run):
    return _spans.host_idle_ms_per_unit(run, {"gui.frame_bytes"})
