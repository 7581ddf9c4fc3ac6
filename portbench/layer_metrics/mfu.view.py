"""The operations a view needs (counts/hac_ops.py) over the window's time
and the H100's published float32 peak (%)."""

from portbench.layer_metrics import _common


def read(run):
    return _common.mfu_pct(run)
