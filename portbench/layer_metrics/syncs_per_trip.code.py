"""The host's blocking waits on the device a round trip (counter syncs in
the spans under codec.encode and codec.decode)."""

from portbench.layer_metrics import _spans


def read(run):
    return _spans.count_per_unit(run, "syncs", {"codec.encode", "codec.decode"})
