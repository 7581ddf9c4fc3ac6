"""Floating-point operations that one CAT-3DGS phase-5 training step needs,
from its shapes (what `mfu.train` reads in the cat3dgs cells).

Counted, per anchor the prefilter finds visible: the scaffold's three MLPs
and mlp_attr, whose form is HAC's mlp_grid with the triplane's features in
place of the hash grid's (`hac_ops.mlp_flops_per_anchor`), the chcm MLPs
(slice i's from the slices before it), and the triplane sample (per scale,
plane and tap, the weight's product and 2 x C for the features); per step
the ARMs' rate of every latent pixel (counts/arm_rate.py) and, per frame,
SSIM's filters (`hac_ops.ssim_flops`) and the blend's pixel-entries
(counts/blend.py). The dense work counts three times (forward, and the
backward's two products). Elementwise work (the entropy model's bits, the
projection, the losses' sums, Adam) is not counted, so the count is a
lower bound of what the step needs. No count follows from how the port
computes (its work on invisible anchors and padding rows).
"""

from __future__ import annotations

from types import SimpleNamespace

from portbench.counts import arm_rate, hac_ops

PEAK_FP32_FLOPS = hac_ops.PEAK_FP32_FLOPS


def dense_flops_per_anchor(shape) -> int:
    fd = shape.feat_dim
    scaffold_and_attr = hac_ops.mlp_flops_per_anchor(SimpleNamespace(
        feat_dim=fd, n_offsets=shape.n_offsets, enc_dim=shape.ctx_dim,
        grid_out_dim=shape.grid_out_dim))
    chcm, before = 0, 0
    for i in range(1, len(shape.chcm_slices)):
        before += shape.chcm_slices[i - 1]
        chcm += 2 * before * 2 * fd + 2 * 2 * fd * 2 * shape.chcm_slices[i]
    return scaffold_and_attr + chcm


def sample_flops_per_anchor(shape) -> int:
    return len(shape.multiscale) * 3 * 4 * (2 + 2 * shape.tri_feat)


def train_step_ops(shape, n_visible: int, height: int, width: int,
                   blend_fwd_ops: int, blend_bwd_ops: int) -> int:
    dense = n_visible * (dense_flops_per_anchor(shape)
                         + sample_flops_per_anchor(shape))
    arm = arm_rate.arm_rate_bound(shape)
    return (3 * (dense + hac_ops.ssim_flops(height, width))
            + arm["fwd_ops"] + arm["bwd_ops"] + blend_fwd_ops + blend_bwd_ops)
