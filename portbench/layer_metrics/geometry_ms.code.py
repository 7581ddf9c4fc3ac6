"""The codec's own per-level CUDA events (its profile=), phase 'geometry',
summed over a round trip's encode and decode (ms)."""


def read(run):
    return run.info.get("geometry_ms")
