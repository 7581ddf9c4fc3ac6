"""Floating-point operations that one HAC view or phase-2 step needs, from
its shapes (the `mfu.train` and `mfu.view` counts of the hac cells).

Counted, per anchor the prefilter finds visible: the four MLPs
(mlp_opacity, mlp_cov, mlp_color, mlp_grid: 2 x in x out a dense layer)
and the hash-grid interpolation (per level and corner, the weight's
products and normalisation and 2 x F for the features); per frame the
blend's pixel-entries (counts/blend.py) and, for training, SSIM's five
separable 11-tap filters of the 3 channels. A training step counts the
MLPs, the grid and SSIM three times (forward, and the backward's two
products). Elementwise work (the entropy model's bits, the projection,
the losses' sums, Adam) is not counted, so the count is a lower bound of
what the step needs, never above it. No count follows from how the port
computes (its banded SSIM products, its work on invisible anchors).
"""

from __future__ import annotations

PEAK_FP32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores


def mlp_flops_per_anchor(shape) -> int:
    fd, k = shape.feat_dim, shape.n_offsets
    in_local = fd + 4
    layers = [(in_local, fd), (fd, k), (in_local, fd), (fd, 7 * k),
              (in_local, fd), (fd, 3 * k), (shape.enc_dim, 2 * fd),
              (2 * fd, shape.grid_out_dim)]
    return sum(2 * a * b for a, b in layers)


def grid_flops_per_anchor(shape) -> int:
    f = shape.n_features_per_level
    per_3d = 8 * (2 + 1 + 2 * f)  # weight (2 products), normalise, features
    per_2d = 4 * (1 + 1 + 2 * f)
    return (len(shape.resolutions_3d) * per_3d
            + 3 * len(shape.resolutions_2d) * per_2d)


def ssim_flops(height: int, width: int, channels: int = 3) -> int:
    return 5 * channels * 2 * 11 * 2 * height * width


def view_ops(shape, n_visible: int, blend_ops: int) -> int:
    return n_visible * (mlp_flops_per_anchor(shape)
                        + grid_flops_per_anchor(shape)) + blend_ops


def train_step_ops(shape, n_visible: int, height: int, width: int,
                   blend_fwd_ops: int, blend_bwd_ops: int) -> int:
    dense = n_visible * (mlp_flops_per_anchor(shape) + grid_flops_per_anchor(shape))
    return 3 * (dense + ssim_flops(height, width)) + blend_fwd_ops + blend_bwd_ops
