"""The codec's own per-level CUDA events, phase 'context', summed over a
round trip's encode and decode (ms)."""


def read(run):
    return run.info.get("context_ms")
