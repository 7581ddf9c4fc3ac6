"""K5 encode: the frozen rans_bytes of a round trip's levels at 3.35 TB/s
over encode_stage_kernel's profiled time per round trip (%)."""

from portbench.layer_metrics import _common


def read(run):
    return _common.per_unit_roofline_pct(run, "rans_enc_bound_ms", "encode_stage_kernel")
