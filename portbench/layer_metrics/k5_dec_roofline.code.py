"""K5 decode: the frozen rans_bytes of a round trip's levels at 3.35 TB/s
over decode_stage_kernel's profiled time per round trip (%)."""

from portbench.layer_metrics import _common


def read(run):
    return _common.per_unit_roofline_pct(run, "rans_dec_bound_ms", "decode_stage_kernel")
