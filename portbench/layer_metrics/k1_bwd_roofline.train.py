"""K1 backward (order_kernel + backward_kernel): the frozen backward_bound
of the kept frames over those calls' profiled time (%)."""

from portbench.layer_metrics import _common


def read(run):
    return _common.roofline_pct(run.info.get("blend_bwd_bound_ms"), _common.k1_times_ms(run)[1])
