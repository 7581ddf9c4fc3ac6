"""Device ms a view of the neural Gaussians (span hac.neural: the hash-grid
context and the MLPs)."""

from portbench.layer_metrics import _spans


def read(run):
    return _spans.device_ms_per_unit(run, "hac.neural", "hac.view")
