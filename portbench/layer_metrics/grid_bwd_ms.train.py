"""Device ms a HAC step of the hash grid's backward (span hac.grid.bwd: from
the grid output's gradient to the last table's)."""

from portbench.layer_metrics import _spans


def read(run):
    return _spans.device_ms_per_unit(run, "hac.grid.bwd", "hac.step")
