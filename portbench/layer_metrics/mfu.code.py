"""The operations a round trip needs (counts/codec_ops.py) over the window's
time and the H100's published dense bf16 peak (%)."""

from portbench.layer_metrics import _common


def read(run):
    return _common.mfu_pct(run)
