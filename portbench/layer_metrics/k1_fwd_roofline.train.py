"""K1 forward (order_kernel + blend_kernel): the frozen blend_bound of the
kept frames over those calls' profiled time, training cell (%)."""

from portbench.layer_metrics import _common


def read(run):
    return _common.roofline_pct(run.info.get("blend_fwd_bound_ms"), _common.k1_times_ms(run)[0])
