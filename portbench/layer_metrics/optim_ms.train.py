"""Device ms a HAC step of the optimizer update (span optim.update,
GroupAdam.update)."""

from portbench.layer_metrics import _spans


def read(run):
    return _spans.device_ms_per_unit(run, "optim.update", "hac.step")
