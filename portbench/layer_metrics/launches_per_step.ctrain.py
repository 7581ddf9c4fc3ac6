"""CUDA kernels launched in the traced window per codec training step."""

from portbench.layer_metrics import _common


def read(run):
    return _common.launches_per_unit(run)
