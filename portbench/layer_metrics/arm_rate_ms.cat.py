"""Device ms a CAT-3DGS step of the ARMs' rate of the planes (spans
cat.arm_rate and cat.arm_rate.bwd under hac.step: its forward, and its
backward from the total's gradient to the last latent plane's)."""

from portbench.layer_metrics import _spans


def read(run):
    parts = [_spans.device_ms_per_unit(run, name, "hac.step")
             for name in ("cat.arm_rate", "cat.arm_rate.bwd")]
    if None in parts:
        return None
    return sum(parts)
