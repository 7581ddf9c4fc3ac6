"""Device ms a CAT-3DGS step of the triplane field's backward (span
cat.field.bwd under hac.step: from the sampled features' gradient to the
last scale's plane gradient)."""

from portbench.layer_metrics import _spans


def read(run):
    return _spans.device_ms_per_unit(run, "cat.field.bwd", "hac.step")
