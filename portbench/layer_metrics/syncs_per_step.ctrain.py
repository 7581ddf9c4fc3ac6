"""The host's blocking waits on the device a codec training step (counter
syncs in the spans under codec.step)."""

from portbench.layer_metrics import _spans


def read(run):
    return _spans.count_per_unit(run, "syncs", {"codec.step"})
