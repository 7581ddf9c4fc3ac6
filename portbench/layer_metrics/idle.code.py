"""Share of the traced window in which no operation ran on the card, coding
cell (%)."""

from portbench.layer_metrics import _common


def read(run):
    return _common.idle_pct(run)
