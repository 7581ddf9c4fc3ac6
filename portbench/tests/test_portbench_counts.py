"""The frozen counts on hand-worked inputs."""

import math

import pytest
import torch

from portbench.counts import blend, codec_ops, hac_ops, rans_bytes
from portbench.reference import hac as ref_hac


def one_tile(points, opacity):
    """One 16x16 tile listing Gaussians at the given pixels, in order,
    each so narrow (conic 20) that it reaches its own pixel only."""
    n = len(points)
    return dict(tile_start=torch.tensor([0, n], dtype=torch.int32),
                pair_gauss=torch.arange(n, dtype=torch.int32),
                mean2d=torch.tensor(points, dtype=torch.float32),
                conic=torch.tensor([[20.0, 0.0, 20.0]] * n),
                opacity=torch.full((n,), opacity))


def test_blend_counts_on_one_tile():
    t = one_tile([(5.0, 7.0), (5.0, 7.0), (10.0, 2.0)], 0.5)
    # every pixel evaluates its 3 entries (T never falls below 1e-4);
    # alpha >= 1/255 only where a Gaussian sits: 2 at (5, 7), 1 at (10, 2)
    assert blend.entries_evaluated(**t, tiles_x=1, max_k=256) == (768, 3)
    fwd = blend.blend_bound(**t, tiles_x=1, height=16, width=16, max_k=256)
    assert fwd["ops"] == 25 * 3
    assert fwd["bytes"] == 4 * 2 + 4 * 3 + 36 * 3 + 12 + 12 * 256
    assert fwd["bound_by"] == "bytes"
    assert math.isclose(fwd["bound_ms"], fwd["bytes"] / 3.35e12 * 1e3)
    bwd = blend.backward_bound(**t, tiles_x=1, height=16, width=16, max_k=256)
    assert bwd["ops"] == 60 * 3
    assert bwd["bytes"] == 4 * 2 + 4 * 3 + 36 * 3 + 24 * 256 + 36 * 3
    # K caps the list: the third entry is not blended
    assert blend.entries_evaluated(**t, tiles_x=1, max_k=2) == (512, 2)


def test_blend_counts_stop_below_the_transmittance_floor():
    # five entries at one pixel, alpha 0.95 each: T before them 1, 0.05,
    # 0.0025, 1.25e-4 (still counted) and 6.25e-6 (past the stop)
    t = one_tile([(3.0, 3.0)] * 5, 0.95)
    assert blend.entries_evaluated(**t, tiles_x=1, max_k=256) == (255 * 5 + 4, 4)


def test_rans_bytes_of_one_level():
    shapes = [(128, 3), (128, 3), (128, 5), (128, 17)]
    assert rans_bytes.rans_bytes(shapes, 100, True, 50) == 4 * 50 + 4 * 100 * 12
    assert rans_bytes.rans_bytes(shapes, 100, False, 50) == (
        4 * 50 + 100 * 4 * (3 + 3 + 5 + 17) + 128 * 4 * (2 + 3 + 3 + 3))


def test_hac_operation_counts_at_the_published_widths():
    shape = ref_hac.HACShape(50, 10, 0.001, 2, 19, 17,
                             (18, 24, 33, 44, 59, 80, 108, 148, 201, 275, 376, 514),
                             (130, 258, 514, 1026), 1.0, 0.001, 0.2)
    assert shape.enc_dim == 48 and shape.grid_out_dim == 175
    assert hac_ops.mlp_flops_per_anchor(shape) == 2 * (
        54 * 50 + 50 * 10 + 54 * 50 + 50 * 70 + 54 * 50 + 50 * 30
        + 48 * 100 + 100 * 175)
    assert hac_ops.grid_flops_per_anchor(shape) == 12 * 8 * 7 + 12 * 4 * 6
    assert hac_ops.ssim_flops(4, 4) == 5 * 3 * 2 * 11 * 2 * 16


def test_codec_pairs_of_a_line_of_voxels():
    line = torch.tensor([[0, 0, 0], [1, 0, 0], [2, 0, 0]])
    # k = 3: each voxel reaches itself and its neighbours on the line
    assert codec_ops._pairs(line, 3, "cpu") == 2 + 3 + 2
    levels = [(line.numpy().astype("int32"), None)] * 2
    ops = codec_ops.round_trip_ops(levels, 3, 4, "cpu")
    heads = sum(2 * 3 * (4 * 4 + 4 * s) for s in (2, 2, 4, 16))
    assert ops == 2 * (2 * 4 * 4 * (5 * 7 + 13 * 7) + heads)


@pytest.mark.parametrize("n", [1, 7])
def test_bound_is_never_zero(n):
    t = one_tile([(1.0, 1.0)] * n, 0.3)
    assert blend.blend_bound(**t, tiles_x=1, height=16, width=16,
                             max_k=256)["bound_ms"] > 0
