"""Device-idle ms a round trip inside the codec's host phases (spans
codec.merge, codec.pyramid, codec.write, codec.parse, codec.split)."""

from portbench.layer_metrics import _spans


def read(run):
    return _spans.host_idle_ms_per_unit(
        run, {"codec.merge", "codec.pyramid", "codec.write", "codec.parse",
              "codec.split"})
