"""Device ms a view of the tile lists (span raster.tile_lists: the
duplication and the sort)."""

from portbench.layer_metrics import _spans


def read(run):
    return _spans.device_ms_per_unit(run, "raster.tile_lists", "hac.view")
