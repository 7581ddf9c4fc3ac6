"""Tests of the port that need an NVIDIA GPU: a CUDA kernel has no CPU mode.

Marked `cuda`; without a card they skip. This file imports no JAX, so it
also runs on the machine with the card, which has none:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(`--noconftest` because tests/conftest.py sets JAX up.)"""

import numpy as np
import pytest
import torch

import chip_smoke
from gauspcc_tpu_torch.core.quant import ste_binary
from gauspcc_tpu_torch.fields import hashgrid
from gauspcc_tpu_torch.fields import triplane as tri
from gauspcc_tpu_torch.models.cat3dgs import field as cfield
from gauspcc_tpu_torch.render import raster, tile_blend
from gauspcc_tpu_torch.utils import profiling


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("max_k", [32, 1024])
def test_kernel_matches_plain_version(cuda_device, max_k):
    gen = torch.Generator().manual_seed(max_k)
    args = chip_smoke.random_tiles(gen, cuda_device, 8, 5, max_k)
    kw = dict(tiles_x=8, height=70, width=120, max_k=max_k)
    before = tile_blend.launches
    got = tile_blend.blend_tiles(*args, **kw)
    torch.cuda.synchronize()
    assert tile_blend.launches == before + 1
    want = tile_blend.blend_tiles_reference(*args, **kw)
    rtol, atol = tile_blend.kernel_tolerance(args[6], args[5])
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
    _check_backward(args, got, **kw)


def _check_backward(args, out, seed=0, **kw):
    """The backward kernel against autograd of the plain version for a
    seeded upstream gradient, within gradient_tolerance; returns its
    gradients."""
    gen = torch.Generator().manual_seed(seed)
    g = torch.randn((3, kw["height"], kw["width"]), generator=gen).to(args[2].device)
    before = tile_blend.backward_launches
    got = tile_blend.blend_tiles_backward(*args, out, g, **kw)
    torch.cuda.synchronize()
    assert tile_blend.backward_launches == before + 1
    want = tile_blend.blend_backward_reference(*args, g, **kw)
    tol = tile_blend.gradient_tolerance(*args, g, **kw)
    for name, a, b in zip(("mean2d", "conic", "opacity", "colors"), got, want):
        assert a.shape == b.shape and bool(torch.isfinite(a).all()), name
        excess = ((a - b).abs() - tol[name]).max()
        assert float(excess) <= 0.0, (name, float(excess))
    return got


@pytest.mark.cuda
def test_rasterize_on_card_matches_cpu(cuda_device):
    """The same Gaussians through rasterize on the card (kernel) and on the
    CPU (plain version): radii exact, image within the kernel tolerance
    plus float32 differences in project (atol 1e-4)."""
    rng = np.random.default_rng(0)
    n = 400
    means = (rng.random((n, 3)) * 1.4 - 0.7).astype(np.float32)
    means[:, 2] += 3.0
    arrays = dict(
        means3d=means, colors=rng.random((n, 3)).astype(np.float32),
        opacities=rng.uniform(0.2, 0.95, (n, 1)).astype(np.float32),
        scales=rng.uniform(0.02, 0.1, (n, 3)).astype(np.float32),
        rotations=rng.normal(size=(n, 4)).astype(np.float32),
        viewmatrix=np.eye(4, dtype=np.float32),
        bg_color=np.ones(3, np.float32))
    cfg = raster.RasterConfig(96, 128, 0.45, 0.35, max_gaussians_per_tile=256)
    on_cpu = raster.rasterize(cfg=cfg, **{k: torch.from_numpy(v)
                                          for k, v in arrays.items()})
    before = tile_blend.launches
    on_card = raster.rasterize(cfg=cfg, **{k: torch.from_numpy(v).to(cuda_device)
                                           for k, v in arrays.items()})
    torch.cuda.synchronize()
    assert tile_blend.launches == before + 1
    torch.testing.assert_close(on_card[1].cpu(), on_cpu[1], rtol=0, atol=0)
    torch.testing.assert_close(on_card[0].cpu(), on_cpu[0], rtol=0, atol=1e-4)


def _lists(gen, device, tiles_x, counts, *, opacity=None, spread=32.0):
    """Tile lists with the given per-tile counts; each tile's Gaussians lie
    around it, stored in shuffled order. `opacity` fixes every opacity."""
    n_tiles = counts.shape[0]
    n = int(counts.sum())
    tile_of = torch.repeat_interleave(torch.arange(n_tiles), counts)
    origin = torch.stack([tile_of % tiles_x, tile_of // tiles_x], -1) * 16
    mean2d = origin.float() + 8 + (torch.rand(n, 2, generator=gen) - 0.5) * spread
    conic = torch.stack([torch.rand(n, generator=gen) * 0.3 + 0.02,
                         (torch.rand(n, generator=gen) - 0.5) * 0.02,
                         torch.rand(n, generator=gen) * 0.3 + 0.02], -1)
    opa = (torch.full((n,), opacity) if opacity is not None
           else torch.rand(n, generator=gen) * 0.9 + 0.05)
    colors = torch.rand(n, 3, generator=gen)
    perm = torch.randperm(n, generator=gen)

    def shuffled(v):
        out = torch.empty_like(v)
        out[perm] = v
        return out.to(device)

    tile_start = torch.cat([torch.zeros(1, dtype=torch.long), counts.cumsum(0)])
    return (tile_start.int().to(device), perm.int().to(device),
            shuffled(mean2d), shuffled(conic), shuffled(opa),
            shuffled(colors), torch.rand(3, generator=gen).to(device))


def _check_kernel(args, **kw):
    """The forward against the plain version, then the backward against
    autograd of it."""
    before = tile_blend.launches
    got = tile_blend.blend_tiles(*args, **kw)
    torch.cuda.synchronize()
    assert tile_blend.launches == before + 1
    want = tile_blend.blend_tiles_reference(*args, **kw)
    rtol, atol = tile_blend.kernel_tolerance(args[6], args[5])
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
    _check_backward(args, got, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("max_k", [1, 300])
def test_kernel_at_k_off_the_batch_and_pixel_counts(cuda_device, max_k):
    """K of 1 and 300: not a multiple of the 64-record batch or of P; the
    lists run from empty to twice K."""
    gen = torch.Generator().manual_seed(max_k)
    counts = torch.randint(0, 2 * max_k + 2, (40,), generator=gen)
    args = _lists(gen, cuda_device, 8, counts)
    _check_kernel(args, tiles_x=8, height=70, width=120, max_k=max_k)


@pytest.mark.cuda
def test_kernel_one_full_tile_among_empty_tiles(cuda_device):
    """The schedule with one long job: one tile of K entries, the rest empty
    (they still write the background)."""
    counts = torch.zeros(40, dtype=torch.long)
    counts[17] = 1024
    args = _lists(torch.Generator().manual_seed(1), cuda_device, 8, counts,
                  spread=8.0)
    _check_kernel(args, tiles_x=8, height=80, width=128, max_k=1024)


@pytest.mark.cuda
def test_kernel_every_tile_saturates_in_its_first_batch(cuda_device):
    """Opacity 0.99 and Gaussians wide over their tile: every pixel's T
    falls under 1e-4 within the first few entries, which exercises the
    early stop of P pixels per thread and of the block."""
    counts = torch.full((40,), 300, dtype=torch.long)
    gen = torch.Generator().manual_seed(2)
    args = list(_lists(gen, cuda_device, 8, counts, opacity=0.99, spread=4.0))
    args[3] = args[3] * 0.01  # conic: wide Gaussians
    _check_kernel(args, tiles_x=8, height=80, width=128, max_k=1024)


@pytest.mark.cuda
@pytest.mark.parametrize("height, width", [(33, 47), (17, 250)])
def test_kernel_image_not_a_multiple_of_the_tile(cuda_device, height, width):
    tiles_x, tiles_y = -(-width // 16), -(-height // 16)
    gen = torch.Generator().manual_seed(height * width)
    args = chip_smoke.random_tiles(gen, cuda_device, tiles_x, tiles_y, 256)
    _check_kernel(args, tiles_x=tiles_x, height=height, width=width, max_k=256)


@pytest.mark.cuda
def test_schedule_blends_longest_lists_first(cuda_device):
    """The device's tile order: a permutation of the tiles in descending
    length bucket, as the plain version orders them. Every slot was
    claimed, every block took one rank on its SM, and the sorted walk's
    counter ends at one failed pull per block past the last tile."""
    gen = torch.Generator().manual_seed(3)
    tiles_x, tiles_y, k = 32, 32, 1024
    args = chip_smoke.random_tiles(gen, cuda_device, tiles_x, tiles_y, k)
    n_tiles = tiles_x * tiles_y
    sched = torch.empty(tile_blend.schedule_words(n_tiles), dtype=torch.int32,
                        device=cuda_device)
    got = tile_blend._launch(args, sched, tiles_x=tiles_x, height=512,
                             width=512, max_k=k)
    sched = sched.cpu()
    bucket, order = tile_blend.tile_order_reference(args[0].cpu(), k)
    taken = sched[1:1 + n_tiles]
    claimed = sched[1 + n_tiles:1 + 2 * n_tiles]
    ranks = sched[1 + 2 * n_tiles:]
    assert torch.equal(torch.sort(taken).values, torch.arange(n_tiles,
                                                              dtype=torch.int32))
    assert torch.equal(bucket[taken.long()], bucket[order])
    assert bool((claimed == 1).all())
    blocks = tile_blend.launch_shape(n_tiles)["blocks"]
    assert int(ranks.sum()) == blocks
    assert int(sched[0]) == n_tiles + blocks
    want = tile_blend.blend_tiles_reference(*args, tiles_x=tiles_x, height=512,
                                            width=512, max_k=k)
    rtol, atol = tile_blend.kernel_tolerance(args[6], args[5])
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


@pytest.mark.cuda
def test_fast_exponential_matches_plain_version_at_k_1024(cuda_device):
    """ex2.approx with expf redone near the 1/255 cut, at K = 1024 on the
    random tiles where ex2.approx alone kept or dropped entries at the cut
    against the plain version (3 values outside the tolerance)."""
    gen = torch.Generator().manual_seed(0)
    args = chip_smoke.random_tiles(gen, cuda_device, 32, 32, 1024)
    _check_kernel(args, tiles_x=32, height=512, width=512, max_k=1024)


@pytest.mark.cuda
def test_kernel_keeps_and_drops_what_the_plain_version_does_at_the_cut(
        cuda_device):
    """One Gaussian whose alpha at pixel (187, 236) lies on 1/255 to the
    last bit: the fused power and the plain version's, one product at a
    time, differ by one ulp there, and put the alpha on the two sides of
    the cut unless the kernel redoes it as the plain version rounds it.
    Found on chip_smoke.random_tiles (seed 3, 32x32 tiles, K = 1024), where
    it moved one value by 3.3e-4."""
    tiles_x, x, y = 32, 187, 236
    counts = torch.zeros(tiles_x * tiles_x, dtype=torch.long)
    counts[(y // 16) * tiles_x + x // 16] = 1
    f32 = dict(dtype=torch.float32, device=cuda_device)
    args = (torch.cat([torch.zeros(1, dtype=torch.long), counts.cumsum(0)]
                      ).int().to(cuda_device),
            torch.zeros(1, dtype=torch.int32, device=cuda_device),
            torch.tensor([[178.07659912109375, 237.96572875976562]], **f32),
            torch.tensor([[0.11286859214305878, -0.008538194932043552,
                           0.0221365038305521]], **f32),
            torch.tensor([0.42527127265930176], **f32),
            torch.tensor([[0.39223986864089966, 0.46046727895736694,
                           0.18155789375305176]], **f32),
            torch.ones(3, **f32))
    kw = dict(tiles_x=tiles_x, height=512, width=512, max_k=1024)
    want = tile_blend.blend_tiles_reference(*args, **kw)
    assert bool((want[:, y, x] == 1.0).all())  # the plain version drops it
    _check_kernel(args, **kw)


@pytest.mark.cuda
def test_launch_shape_is_the_persistent_grid(cuda_device):
    """Resident blocks per SM times the SMs, at most one block per tile;
    256 pixels over threads x pixels per thread, whole rows of 16."""
    n_sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    many = tile_blend.launch_shape(100_000)
    few = tile_blend.launch_shape(7)
    assert many["blocks_per_sm"] >= 1
    assert many["blocks"] == many["blocks_per_sm"] * n_sms
    assert few["blocks"] == 7
    assert many["threads"] * many["pix_per_thread"] == tile_blend.PIX
    assert many["threads"] % tile_blend.TILE == 0
    assert many["shared_bytes"] > 0 and many["registers"] > 0


@pytest.mark.cuda
def test_thin_gaussians_at_the_cut_keep_and_drop_what_the_plain_version_does(
        cuda_device):
    """Thin Gaussians near 45 degrees, whose quadratic-form terms are about
    10^4 where alpha lies within a few ulps of 1/255 (chip_smoke.cut_lists):
    the fused power and the plain one differ by up to 2e-3 there, beyond a
    fixed 1e-4 window. The forward and the backward hold against the plain
    version."""
    args = chip_smoke.cut_lists(cuda_device, 32, 32)
    _check_kernel(args, tiles_x=32, height=512, width=512, max_k=4)


@pytest.mark.cuda
def test_backward_repeats_within_the_atomics_reordering(cuda_device):
    """Two runs of the backward on the same inputs: the atomics add in
    another order each time, so the sums may differ in their last bits, and
    no more than the reordering term of gradient_tolerance allows."""
    gen = torch.Generator().manual_seed(5)
    args = chip_smoke.random_tiles(gen, cuda_device, 16, 16, 1024)
    kw = dict(tiles_x=16, height=256, width=256, max_k=1024)
    out = tile_blend.blend_tiles(*args, **kw)
    first = _check_backward(args, out, seed=1, **kw)
    again = _check_backward(args, out, seed=1, **kw)
    g = torch.randn((3, 256, 256), generator=torch.Generator().manual_seed(1)
                    ).to(cuda_device)
    tol = tile_blend.gradient_tolerance(*args, g, **kw)
    for name, a, b in zip(("mean2d", "conic", "opacity", "colors"), first, again):
        assert float(((a - b).abs() - tol[name]).max()) <= 0.0, name


@pytest.mark.cuda
def test_rasterize_gradients_on_card_match_cpu(cuda_device):
    """The same Gaussians through rasterize on the card (forward and
    backward kernels) and on the CPU (autograd of the plain version): the
    gradients of every input, and of means2d_extra, agree to the float32
    differences of project and the blend (rtol 1e-3 of the largest)."""
    rng = np.random.default_rng(1)
    n = 300
    means = (rng.random((n, 3)) * 1.4 - 0.7).astype(np.float32)
    means[:, 2] += 3.0
    arrays = dict(
        means3d=means, colors=rng.random((n, 3)).astype(np.float32),
        opacities=rng.uniform(0.2, 0.95, (n, 1)).astype(np.float32),
        scales=rng.uniform(0.02, 0.1, (n, 3)).astype(np.float32),
        rotations=rng.normal(size=(n, 4)).astype(np.float32),
        means2d_extra=np.zeros((n, 2), np.float32))
    cfg = raster.RasterConfig(64, 96, 0.45, 0.35, max_gaussians_per_tile=128)
    target = rng.random((3, 64, 96)).astype(np.float32)
    grads = {}
    for dev in ("cpu", cuda_device):
        leaves = {k: torch.from_numpy(v).to(dev).requires_grad_(True)
                  for k, v in arrays.items()}
        img, _ = raster.rasterize(
            viewmatrix=torch.eye(4, device=dev), bg_color=torch.ones(3, device=dev),
            cfg=cfg, **leaves)
        loss = ((img - torch.from_numpy(target).to(dev)) ** 2).sum()
        grads[str(dev)] = [t.cpu() for t in torch.autograd.grad(
            loss, list(leaves.values()))]
    for name, a, b in zip(arrays, grads["cpu"], grads[str(cuda_device)]):
        scale = float(a.abs().max())
        torch.testing.assert_close(b, a, rtol=0, atol=1e-3 * scale, msg=name)


def _explicit(device, lists, mean2d, conic, opacity, seed=0):
    """Tile lists given per tile (lists of Gaussian indices, front to
    back) over the given Gaussians, with seeded colours and background."""
    gen = torch.Generator().manual_seed(seed)
    n = len(mean2d)
    counts = torch.tensor([len(ids) for ids in lists])
    f32 = dict(dtype=torch.float32)
    return (torch.cat([torch.zeros(1, dtype=torch.long), counts.cumsum(0)]
                      ).int().to(device),
            torch.tensor([i for ids in lists for i in ids], dtype=torch.int32
                         ).to(device),
            torch.tensor(mean2d, **f32).to(device),
            torch.tensor(conic, **f32).to(device),
            torch.tensor(opacity, **f32).to(device),
            torch.rand(n, 3, generator=gen).to(device),
            torch.rand(3, generator=gen).to(device))


def _blended(args, tiles_x, max_k):
    """[T, 256, K] whether each pixel of each tile blends each list entry,
    by the plain version."""
    out = []
    for _, _, alpha, t_before, _, _ in tile_blend._alpha_chunks(
            *args[:5], tiles_x, max_k):
        out.append((t_before >= tile_blend.T_MIN) & (alpha > 0))
    return torch.cat(out).cpu()


# the backward's warp of each pixel of a tile: its 8x8 quadrant (w % 2, w // 2)
_WARP_OF_PIXEL = (torch.arange(256) // 16 // 8) * 2 + torch.arange(256) % 16 // 8


@pytest.mark.cuda
def test_backward_every_warp_blends_every_record(cuda_device):
    """Wide, faint Gaussians over their tile: every pixel blends every
    record, so all 4 warps of a block add their sums of each record and
    the flush combines 4 slices."""
    tiles_x, per_tile = 2, 40
    mean2d, lists = [], []
    for tile in range(4):
        cx, cy = (tile % tiles_x) * 16 + 7.5, (tile // tiles_x) * 16 + 7.5
        lists.append(list(range(len(mean2d), len(mean2d) + per_tile)))
        mean2d += [[cx + 0.1 * j, cy - 0.05 * j] for j in range(per_tile)]
    n = len(mean2d)
    args = _explicit(cuda_device, lists, mean2d, [[1e-4, 0.0, 1e-4]] * n,
                     [0.05 + 0.0005 * j for j in range(n)])
    kw = dict(tiles_x=tiles_x, height=32, width=32, max_k=64)
    assert bool(_blended(args, tiles_x, 64)[:, :, :per_tile].all())
    _check_kernel(args, **kw)


@pytest.mark.cuda
def test_backward_record_touched_by_one_warp(cuda_device):
    """Point-like Gaussians 0.2 px off single pixels (conic 20: alpha 0.5
    exp(-6.8) at the nearest other pixel, below 1/255): each record is
    blended by one pixel, so one warp of the block (one quadrant) stores
    its sum and the flush reads one slice."""
    tiles_x = 2
    mean2d, lists = [], []
    for tile in range(4):
        x0, y0 = (tile % tiles_x) * 16, (tile // tiles_x) * 16
        ids = []
        for j in range(32):  # rows 0..15 twice, columns spread
            ids.append(len(mean2d))
            mean2d.append([x0 + (3 * j + j // 16 + tile) % 16 + 0.2,
                           y0 + j % 16 + 0.2])
        lists.append(ids)
    n = len(mean2d)
    args = _explicit(cuda_device, lists, mean2d, [[20.0, 0.0, 20.0]] * n,
                     [0.5] * n, seed=1)
    blended = _blended(args, tiles_x, 64)[:, :, :32]  # [T, 256, 32]
    for w in range(4):
        assert int(blended[:, _WARP_OF_PIXEL == w].any(1).sum()) > 0
    per_record = torch.stack([blended[:, _WARP_OF_PIXEL == w].any(1)
                              for w in range(4)]).sum(0)
    assert bool((per_record == 1).all())
    _check_kernel(args, tiles_x=tiles_x, height=32, width=32, max_k=64)


@pytest.mark.cuda
def test_backward_one_gaussian_in_every_tile(cuda_device):
    """One wide Gaussian first in every tile's list, then local ones: every
    block's flush adds into the same Gaussian's gradient."""
    tiles_x, tiles_y = 8, 5
    gen = torch.Generator().manual_seed(7)
    mean2d, conic, opacity = [[64.0, 40.0]], [[1e-4, 0.0, 1e-4]], [0.3]
    lists = []
    for tile in range(tiles_x * tiles_y):
        x0, y0 = (tile % tiles_x) * 16, (tile // tiles_x) * 16
        ids = [0]
        for _ in range(12):
            ids.append(len(mean2d))
            u = torch.rand(2, generator=gen)
            mean2d.append([x0 + 16 * float(u[0]), y0 + 16 * float(u[1])])
            conic.append([0.1, 0.0, 0.1])
            opacity.append(0.4)
        lists.append(ids)
    args = _explicit(cuda_device, lists, mean2d, conic, opacity, seed=2)
    assert bool(_blended(args, tiles_x, 64)[:, :, 0].any(1).all())
    _check_kernel(args, tiles_x=tiles_x, height=80, width=128, max_k=64)


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [1, 2, 3])
def test_backward_packed_gradient_when_n_is_not_a_multiple_of_4(cuda_device,
                                                                extra):
    """N = 4m + extra Gaussians: the packed [N, 12] buffer and its views
    have autograd's shapes, and hold the gradient of the last Gaussian."""
    gen = torch.Generator().manual_seed(extra)
    counts = torch.full((20,), 10, dtype=torch.long)
    counts[-1] += extra
    args = _lists(gen, cuda_device, 5, counts, spread=16.0)
    n = int(counts.sum())
    assert n % 4 == extra
    kw = dict(tiles_x=5, height=64, width=80, max_k=64)
    out = tile_blend.blend_tiles(*args, **kw)
    got = _check_backward(args, out, **kw)
    for g, leaf in zip(got, args[2:6]):
        assert g.shape == leaf.shape
    base = got[0].untyped_storage().data_ptr()
    assert all(g.untyped_storage().data_ptr() == base for g in got)
    assert base % 16 == 0


@pytest.mark.cuda
def test_backward_skips_a_chunk_no_lane_touches(cuda_device):
    """Each list: 8 Gaussians on the tile, 8 far off it (alpha below 1/255
    at every pixel, a whole chunk of 8 records no lane blends), then 8 on
    the tile again: the sums after the skipped chunk land on their own
    records."""
    tiles_x = 2
    mean2d, lists = [], []
    for tile in range(4):
        x0, y0 = (tile % tiles_x) * 16, (tile // tiles_x) * 16
        ids = []
        for j in range(24):
            ids.append(len(mean2d))
            far = 8 <= j < 16
            mean2d.append([x0 + 2 * (j % 8) + (300.0 if far else 1.0),
                           y0 + 1.5 * (j % 8) + 2.0])
        lists.append(ids)
    n = len(mean2d)
    args = _explicit(cuda_device, lists, mean2d, [[0.05, 0.01, 0.05]] * n,
                     [0.3] * n, seed=3)
    touched = _blended(args, tiles_x, 64).any(1)  # [T, K]
    assert not bool(touched[:, 8:16].any())
    assert bool(touched[:, :8].all()) and bool(touched[:, 16:24].all())
    _check_kernel(args, tiles_x=tiles_x, height=32, width=32, max_k=64)


@pytest.mark.cuda
def test_backward_culls_quadrants_at_the_edge_of_reach(cuda_device):
    """Round Gaussians beside a quadrant's edge whose alpha at the nearest
    pixel of the next quadrant lies just above or just below 1/255: the
    quadrants the backward leaves out of a record's walk (quadrant_mask)
    are only ones where it blends no pixel."""
    tiles_x = 2
    rng = np.random.default_rng(11)
    mean2d, conic, opacity, lists = [], [], [], []
    for tile in range(4):
        x0, y0 = (tile % tiles_x) * 16, (tile // tiles_x) * 16
        ids = []
        for j in range(24):
            ids.append(len(mean2d))
            # the mean on a pixel row, 0.5-3 px left of column 8 (quadrant 0
            # side): alpha at column 8 = opacity exp(-c d^2 / 2), set to
            # 1/255 times 1.001 (blended), 0.999 (dropped, walked) or 0.99
            # (dropped, and the next quadrant left out of the walk)
            d = rng.uniform(0.5, 3.0)
            c = rng.uniform(0.5, 2.0)
            mean2d.append([x0 + 8 - d, y0 + float(rng.integers(0, 16))])
            conic.append([c, 0.0, c])
            target = (1 / 255) * np.exp(0.5 * c * d * d)
            opacity.append(min(0.99, target * rng.choice([0.99, 0.999, 1.001])))
        lists.append(ids)
    args = _explicit(cuda_device, lists, mean2d, conic, opacity, seed=4)
    touched = _blended(args, tiles_x, 64)[:, :, :24]  # [T, 256, 24]
    right = torch.arange(256) % 16 >= 8
    reach_right = touched[:, right].any(1)
    assert 0 < int(reach_right.sum()) < reach_right.numel()
    _check_kernel(args, tiles_x=tiles_x, height=32, width=32, max_k=64)


@pytest.mark.cuda
@pytest.mark.parametrize("cap,n_valid", [(16384, 16384), (16384, 9001),
                                         (16384, 0), (2048, 1500), (256, 77)])
def test_rans_kernels_match_plain_versions(cuda_device, cap, n_valid):
    """Both rANS kernels against their plain versions, bit for bit: the
    encode's state, word counts and words, then the decode's state,
    pointer, symbols and fused prev; every coded symbol decodes."""
    from gauspcc_tpu_torch.ops import rans
    gen = torch.Generator().manual_seed(cap + n_valid)
    tables, syms = chip_smoke.random_rans_inputs(gen, cap, cuda_device)
    enc, dec = rans.encode_launches, rans.decode_launches
    chip_smoke.check_rans("test", tables, syms, n_valid)
    assert rans.encode_launches == enc + 4
    assert rans.decode_launches == dec + 4


def _table(freqs):
    """int32 CDF rows [cap, n + 1] (uint16 values, the last column wrapped to
    0) from integer frequencies [cap, n] summing to 2^16 (0 allowed)."""
    cdf = np.concatenate([np.zeros((freqs.shape[0], 1), np.int64),
                          np.cumsum(freqs, 1)], 1)
    return (cdf & 0xFFFF).astype(np.int32)


def _edge_inputs(kind, cap, seed, device):
    """Tables and symbols per stage: `refill`, the coded symbol has
    frequency 1 (a word a step); `norefill`, it has 2^16 - (n - 1) (no word
    in the whole stage); `zerofreq`, random frequencies of which about 40%
    are 0 (equal neighbouring entries), never the coded symbol's."""
    rng = np.random.default_rng(seed)
    tables, syms = [], []
    for n in (2, 2, 4, 16):
        s = rng.integers(0, n, cap)
        at = (np.arange(cap), s)
        if kind == "refill":
            f = np.full((cap, n), 65535 // (n - 1), np.int64)
            f[at] = 1
            f[np.arange(cap), (s + 1) % n] += 65536 - f.sum(1)
        elif kind == "norefill":
            f = np.ones((cap, n), np.int64)
            f[at] = 65536 - (n - 1)
        else:
            w = rng.random((cap, n)) * (rng.random((cap, n)) >= 0.4)
            w[at] = np.maximum(w[at], 0.05)
            f = np.floor(w / w.sum(1, keepdims=True) * 65000).astype(np.int64)
            # the coded symbol below 2^16, the last above 0: no entry but
            # the last reaches 2^16
            for j in ((s + 1) % n, n - 1):
                f[np.arange(cap), j] = np.maximum(f[np.arange(cap), j], 1)
            f[at] += 65536 - f.sum(1)
        tables.append(torch.from_numpy(_table(f)).to(device))
        syms.append(torch.from_numpy(s.astype(np.int32)).to(device))
    return tables, syms


@pytest.mark.cuda
@pytest.mark.parametrize("cap,n_valid,kind", [
    (256, 256, "random"),  # 8 lanes x 32 steps
    (1024, 1000, "random"),  # 8 lanes x 128 steps, the last step in part
    (2048, 1999, "random"),  # 16 lanes
    (16768, 16768, "random"),  # 128 lanes x 131 steps: a ragged last slot
    (16768, 12837, "random"),  # n_valid mid-step, 101 steps walked
    (16384, 16384, "refill"),
    (16384, 16384, "norefill"),
    (16384, 15000, "zerofreq"),
    (2048, 2048, "zerofreq"),
])
def test_rans_kernels_on_edge_cases(cuda_device, cap, n_valid, kind):
    """Both rANS kernels against their plain versions, bit for bit, at 8,
    16 and 128 lanes, steps not a multiple of the ring's slot, and tables
    that refill at every step, at none, or hold zero-frequency symbols."""
    from gauspcc_tpu_torch.ops import rans
    if kind == "random":
        gen = torch.Generator().manual_seed(cap + n_valid)
        tables, syms = chip_smoke.random_rans_inputs(gen, cap, cuda_device)
    else:
        tables, syms = _edge_inputs(kind, cap, cap + n_valid, cuda_device)
    enc, dec = rans.encode_launches, rans.decode_launches
    out = chip_smoke.check_rans(kind, tables, syms, n_valid)
    assert rans.encode_launches == enc + 4
    assert rans.decode_launches == dec + 4
    steps = cap // rans.lane_count(cap)
    if kind == "refill":
        assert (out["n_words"] == 4 * steps + 2).all()
    if kind == "norefill":
        assert (out["n_words"] == 2).all()


@pytest.mark.cuda
def test_rans_stream_equals_the_first_kernels(cuda_device):
    """The kernels write the bytes that the first rANS kernels
    (tests/baseline/rans_direct.cu, the same C interface) write, and decode
    the same symbols, states and pointers."""
    from pathlib import Path
    coder = chip_smoke.baseline_rans_coder(
        Path(__file__).resolve().parent / "baseline" / "rans_direct.cu")
    gen = torch.Generator().manual_seed(9)
    for cap, n_valid in ((16768, 16001), (1024, 77)):
        tables, syms = chip_smoke.random_rans_inputs(gen, cap, cuda_device)
        chip_smoke.check_rans_baseline("test", tables, syms, n_valid, coder)


@pytest.mark.cuda
def test_codec_roundtrip_on_the_card(cuda_device, tmp_path):
    """A small cloud through compress and decompress on the card, with
    seeded weights at NetConfig(16, 3): lossless, through both kernels."""
    from gauspcc_tpu_torch.codecs.gauspcgc import codec, model
    from gauspcc_tpu_torch.ops import rans
    cfg = model.NetConfig(channels=16, kernel_size=3)
    net = model.GausPcgcNet(cfg)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.2)
    rng = np.random.default_rng(0)
    xyz = np.unique(rng.integers(-60, 200, (4000, 3)), axis=0)[:2500]
    enc, dec = rans.encode_launches, rans.decode_launches
    path = str(tmp_path / "pc.bin")
    out = codec.compress_point_cloud(xyz, net.to(cuda_device), path, config=cfg)
    got = codec.decompress_point_cloud(path, net, config=cfg)
    assert rans.encode_launches > enc and rans.decode_launches > dec
    assert out["num_points"] == got["num_points"] == xyz.shape[0]
    np.testing.assert_array_equal(
        np.unique(got["point_cloud"].astype(np.int64), axis=0), xyz)


@pytest.mark.cuda
def test_scene_roundtrip_on_the_card(cuda_device, tmp_path):
    """A small seeded HAC state (the widths of tests/test_hac_codec.py)
    through conduct_encoding and conduct_decoding on the card, with seeded
    codec weights at NetConfig(16, 3): anchors, masks, hash signs and every
    decoded attribute equal to what the encoder coded, through both rANS
    kernels."""
    from gauspcc_tpu_torch.codecs.gauspcgc import model
    from gauspcc_tpu_torch.models.hac import codec as hac_codec
    from gauspcc_tpu_torch.models.hac import model as hac
    from gauspcc_tpu_torch.ops import rans
    cfg = hac.HACConfig(feat_dim=8, n_offsets=3, voxel_size=0.05,
                        resolutions_3d=(6, 10, 16), resolutions_2d=(16, 32),
                        log2_hashmap_size=13, log2_hashmap_size_2d=13)
    rng = np.random.default_rng(0)
    pts = hac.voxelize_points((rng.random((4000, 3)) * 2 - 1).astype(np.float32),
                              cfg.voxel_size)
    state = hac.update_anchor_bound(hac.init_state(cfg, pts, rng,
                                                   device=cuda_device))
    n = pts.shape[0]
    a = state["anchors"]
    for name, mu, sd in (("anchor_feat", 0, 0.5), ("offset", 0, 0.3),
                         ("mask", 1.0, 2.0)):
        a[name][:n] = torch.from_numpy(rng.normal(mu, sd, tuple(a[name][:n].shape))
                                       .astype(np.float32)).to(cuda_device)
    pcfg = model.NetConfig(channels=16, kernel_size=3)
    net = model.GausPcgcNet(pcfg)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.2)
    net = net.to(cuda_device)
    enc, dec_launches = rans.encode_launches, rans.decode_launches
    values = {}
    sizes, _ = hac_codec.conduct_encoding(state, cfg, str(tmp_path), net, pcfg,
                                          values=values)
    dec, _ = hac_codec.conduct_decoding(state, cfg, str(tmp_path), net, pcfg)
    assert rans.encode_launches > enc and rans.decode_launches > dec_launches
    data = hac_codec._gather_sorted_attributes(state, cfg)
    m = data["anchor_int"].shape[0]
    assert m > hac_codec.BATCH and int(dec["valid"].sum()) == m
    d = dec["anchors"]
    np.testing.assert_array_equal(
        d["anchor"][:m].cpu().numpy(),
        data["anchor_int"].astype(np.float32) * cfg.voxel_size)
    assert torch.equal(d["mask"][:m], data["mask"])
    assert torch.equal(dec["nets"].tables.flat(), hac.encoding_params_flat(state))
    for name, key in (("feat", "anchor_feat"), ("scaling", "scaling"),
                      ("offset", "offset")):
        assert torch.equal(d[key][:m], values[name]), name
    assert sizes["total"] > 0


@pytest.mark.cuda
def test_hac_plus_scene_roundtrip_on_the_card(cuda_device, tmp_path):
    """A small seeded HAC++ state (the widths of tests/test_hac_plus.py)
    through its conduct_encoding and conduct_decoding on the card, with
    seeded codec weights at NetConfig(16, 3): anchors, masks, hash signs
    and every decoded attribute, each feature chunk included, equal to what
    the encoder coded, through both rANS kernels."""
    from gauspcc_tpu_torch.codecs.gauspcgc import model
    from gauspcc_tpu_torch.models.hac import codec as hac_codec
    from gauspcc_tpu_torch.models.hac import model as hac
    from gauspcc_tpu_torch.models.hac_plus import codec as hacp_codec
    from gauspcc_tpu_torch.models.hac_plus import model as hacp
    from gauspcc_tpu_torch.ops import rans
    cfg = hacp.HACPlusConfig(feat_dim=10, n_offsets=3, voxel_size=0.05,
                             resolutions_3d=(6, 10, 16), resolutions_2d=(16, 32),
                             log2_hashmap_size=13, log2_hashmap_size_2d=13)
    rng = np.random.default_rng(0)
    pts = hac.voxelize_points((rng.random((4000, 3)) * 2 - 1).astype(np.float32),
                              cfg.voxel_size)
    state = hac.update_anchor_bound(hacp.init_state(cfg, pts, rng,
                                                    device=cuda_device))
    n = pts.shape[0]
    a = state["anchors"]
    for name, mu, sd in (("anchor_feat", 0, 0.5), ("offset", 0, 0.3),
                         ("mask", 1.0, 2.0)):
        a[name][:n] = torch.from_numpy(rng.normal(mu, sd, tuple(a[name][:n].shape))
                                       .astype(np.float32)).to(cuda_device)
    pcfg = model.NetConfig(channels=16, kernel_size=3)
    net = model.GausPcgcNet(pcfg)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.2)
    net = net.to(cuda_device)
    enc, dec_launches = rans.encode_launches, rans.decode_launches
    values = {}
    sizes, _ = hacp_codec.conduct_encoding(state, cfg, str(tmp_path), net, pcfg,
                                           values=values)
    dec, _ = hacp_codec.conduct_decoding(state, cfg, str(tmp_path), net, pcfg)
    assert rans.encode_launches > enc and rans.decode_launches > dec_launches
    data = hac_codec._gather_sorted_attributes(state, cfg.as_hac())
    m = data["anchor_int"].shape[0]
    assert m > hacp_codec.BATCH and int(dec["valid"].sum()) == m
    d = dec["anchors"]
    np.testing.assert_array_equal(
        d["anchor"][:m].cpu().numpy(),
        data["anchor_int"].astype(np.float32) * cfg.voxel_size)
    assert torch.equal(d["mask"][:m], data["mask"])
    assert torch.equal(dec["nets"].tables.flat(), hac.encoding_params_flat(state))
    for cc in range(hacp.N_CHUNKS):
        cols = slice(cc * cfg.chunk, (cc + 1) * cfg.chunk)
        assert torch.equal(d["anchor_feat"][:m, cols], values["feat"][:, cols]), cc
    for name, key in (("scaling", "scaling"), ("offset", "offset")):
        assert torch.equal(d[key][:m], values[name]), name
    assert sizes["total"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("knn", [False, True])
def test_tcgs_scene_roundtrip_on_the_card(cuda_device, tmp_path, knn):
    """A small seeded TC-GS state (the widths of tests/test_tcgs.py, in
    repeat and in knn mode) through its conduct_encoding and
    conduct_decoding on the card, with seeded codec weights at
    NetConfig(16, 3): anchors, masks, the f16 latent, the planes
    reconstructed from it and every decoded attribute equal to what the
    encoder coded, through both rANS kernels."""
    from gauspcc_tpu_torch.codecs.gauspcgc import model
    from gauspcc_tpu_torch.models.hac import codec as hac_codec
    from gauspcc_tpu_torch.models.hac import model as hac
    from gauspcc_tpu_torch.models.tcgs import codec as tcgs_codec
    from gauspcc_tpu_torch.models.tcgs import model as tcgs
    from gauspcc_tpu_torch.ops import rans
    cfg = tcgs.TCGSConfig(feat_dim=8, n_offsets=3, voxel_size=0.05, tri_feat=4,
                          tri_res=16, tri_samples=2, ae_compressed=4,
                          knn_sampling=knn)
    rng = np.random.default_rng(0)
    pts = hac.voxelize_points((rng.random((4000, 3)) * 2 - 1).astype(np.float32),
                              cfg.voxel_size)
    state = hac.update_anchor_bound(tcgs.init_state(cfg, pts, rng,
                                                    device=cuda_device))
    n = pts.shape[0]
    a = state["anchors"]
    for name, mu, sd in (("anchor_feat", 0, 0.5), ("offset", 0, 0.3),
                         ("mask", 1.0, 2.0)):
        a[name][:n] = torch.from_numpy(rng.normal(mu, sd, tuple(a[name][:n].shape))
                                       .astype(np.float32)).to(cuda_device)
    pcfg = model.NetConfig(channels=16, kernel_size=3)
    net = model.GausPcgcNet(pcfg)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.2)
    net = net.to(cuda_device)
    enc, dec_launches = rans.encode_launches, rans.decode_launches
    values = {}
    sizes, _ = tcgs_codec.conduct_encoding(state, cfg, str(tmp_path), net, pcfg,
                                           values=values)
    dec, _ = tcgs_codec.conduct_decoding(state, cfg, str(tmp_path), net, pcfg)
    assert rans.encode_launches > enc and rans.decode_launches > dec_launches
    data = hac_codec._gather_sorted_attributes(state, cfg.as_hac())
    m = data["anchor_int"].shape[0]
    assert m > tcgs_codec.BATCH and int(dec["valid"].sum()) == m
    d = dec["anchors"]
    np.testing.assert_array_equal(
        d["anchor"][:m].cpu().numpy(),
        data["anchor_int"].astype(np.float32) * cfg.voxel_size)
    assert torch.equal(d["mask"][:m], data["mask"])
    assert torch.equal(dec["nets"].planes, values["planes"])
    for name, key in (("feat", "anchor_feat"), ("scaling", "scaling"),
                      ("offset", "offset")):
        assert torch.equal(d[key][:m], values[name]), name
    assert sizes["triplane"] == values["latent"].numel() * 16


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [False, True])
def test_cat3dgs_scene_roundtrip_on_the_card(cuda_device, tmp_path, heads):
    """A small seeded CAT-3DGS state (the widths of tests/test_cat3dgs.py,
    with the chcm heads of the offsets and the scaling off and on, its PCA
    frame fitted) through its conduct_encoding and conduct_decoding on the
    card, with seeded codec weights at NetConfig(16, 3): anchors, masks,
    the integer planes, each feature slice, scaling and offsets equal to
    what the encoder coded, through both rANS kernels."""
    from gauspcc_tpu_torch.codecs.gauspcgc import model
    from gauspcc_tpu_torch.models.cat3dgs import codec as cat_codec
    from gauspcc_tpu_torch.models.cat3dgs import field as cat_field
    from gauspcc_tpu_torch.models.cat3dgs import model as cat
    from gauspcc_tpu_torch.models.hac import codec as hac_codec
    from gauspcc_tpu_torch.models.hac import model as hac
    from gauspcc_tpu_torch.ops import rans
    cfg = cat.CATConfig(feat_dim=8, n_offsets=3, voxel_size=0.05,
                        chcm_slices=(4, 4), tri_feat=1, base_resolution=16,
                        multiscale=(1, 2), chcm_for_offsets=heads,
                        chcm_for_scaling=heads)
    rng = np.random.default_rng(0)
    pts = hac.voxelize_points((rng.random((4000, 3)) * 2 - 1).astype(np.float32),
                              cfg.voxel_size)
    state = cat.set_pca_frame(hac.update_anchor_bound(cat.init_state(
        cfg, pts, rng, device=cuda_device)), cfg)
    n = pts.shape[0]
    a = state["anchors"]
    for name, mu, sd in (("anchor_feat", 0, 0.5), ("offset", 0, 0.3),
                         ("mask", 1.0, 2.0)):
        a[name][:n] = torch.from_numpy(rng.normal(mu, sd, tuple(a[name][:n].shape))
                                       .astype(np.float32)).to(cuda_device)
    pcfg = model.NetConfig(channels=16, kernel_size=3)
    net = model.GausPcgcNet(pcfg)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.2)
    net = net.to(cuda_device)
    enc, dec_launches = rans.encode_launches, rans.decode_launches
    values = {}
    sizes, _ = cat_codec.conduct_encoding(state, cfg, str(tmp_path), net, pcfg,
                                          values=values)
    dec, _ = cat_codec.conduct_decoding(state, cfg, str(tmp_path), net, pcfg)
    assert rans.encode_launches > enc and rans.decode_launches > dec_launches
    data = hac_codec._gather_sorted_attributes(state, cfg.as_hac())
    m = data["anchor_int"].shape[0]
    assert m > cat_codec.BATCH and int(dec["valid"].sum()) == m
    d = dec["anchors"]
    np.testing.assert_array_equal(
        d["anchor"][:m].cpu().numpy(),
        data["anchor_int"].astype(np.float32) * cfg.voxel_size)
    assert torch.equal(d["mask"][:m], data["mask"])
    for got, want in zip(cat_field.quantized_planes(dec["nets"].field),
                         values["planes"]):
        assert torch.equal(got, want)
    for i, cols in enumerate(cat_codec._slices(cfg)):
        assert torch.equal(d["anchor_feat"][:m, cols], values["feat"][:, cols]), i
    for name, key in (("scaling", "scaling"), ("offset", "offset")):
        assert torch.equal(d[key][:m], values[name]), name
    assert sizes["triplane"] > 3 * 4560 * 8


def _plane_cloud(seed: int, n: int) -> np.ndarray:
    """tests/test_train_gauspcgc.py:15 (plane-ish, learnable)."""
    base = np.random.default_rng(seed).integers(0, 64, size=(n, 3))
    base[:, 2] = (base[:, 0] // 4 + base[:, 1] // 4) % 32
    return np.unique(base, axis=0).astype(np.int64)


@pytest.mark.cuda
def test_codec_train_steps_on_the_card_match_the_cpu(cuda_device):
    """Three float32 codec training steps at NetConfig(8, 3) from the same
    weights on the card and on the CPU (cuBLAS in full precision): each
    step's bpp within rtol 1e-5, the first step's gradients within 1e-4 of
    each leaf's largest magnitude (the embeddings' scatter-add sums in
    another order there), every weight after three Adam steps within 1e-4
    of its leaf's largest magnitude plus 1e-5."""
    from gauspcc_tpu_torch.codecs.gauspcgc import codec, model, train
    cfg = train.TrainConfig(channels=8, kernel_size=3)
    ncfg = model.NetConfig(8, 3, "f32")
    runs = {}
    with codec._exact_gemms():
        for dev in (torch.device("cpu"), cuda_device):
            net = model.init_net(ncfg, 11).to(dev)
            opt = train.make_optimizer(cfg)
            state = opt.init(dict(net.named_parameters()))
            bpps, first = [], None
            for step in range(3):
                prepared = train.pyramid_batches_sib(_plane_cloud(step, 1500), dev)
                if step == 0:
                    for b in prepared[0]:
                        train._batch_bits(net, ncfg, b)[0].backward()
                    first = {k: p.grad.cpu() for k, p in net.named_parameters()}
                state, bpp = train.train_step(net, opt, state, ncfg, None,
                                              prepared=prepared)
                bpps.append(bpp)
            runs[dev.type] = (bpps, first, {k: p.detach().cpu()
                                            for k, p in net.named_parameters()})
    (bc, gc, wc), (bg, gg, wg) = runs["cpu"], runs["cuda"]
    np.testing.assert_allclose(bg, bc, rtol=1e-5)
    for k in gc:
        scale = float(gc[k].abs().max())
        assert float((gg[k] - gc[k]).abs().max()) <= 1e-4 * scale, k
        assert float((wg[k] - wc[k]).abs().max()) <= 1e-4 * float(wc[k].abs().max()) + 1e-5, k


@pytest.mark.cuda
def test_codec_trained_then_coded_on_the_card(cuda_device, tmp_path):
    """`train.train` on the card (4 steps, validated, best_model.npz), the
    weights loaded back through convert, then a cloud coded and decoded on
    the card losslessly through both rANS kernels."""
    from gauspcc_tpu_torch import convert
    from gauspcc_tpu_torch.codecs.gauspcgc import codec, data, train
    from gauspcc_tpu_torch.ops import rans
    paths = []
    for i in range(2):
        paths.append(str(tmp_path / f"c{i}.npy"))
        np.save(paths[-1], _plane_cloud(10 + i, 3000).astype(np.float32))
    cfg = train.TrainConfig(channels=8, kernel_size=3, max_steps=4, val_interval=2,
                            model_dir=str(tmp_path / "m"))
    train.train(cfg, data.PatchDataset(paths, seed=0, max_num=2000),
                data.WholeCloudDataset(paths[:1]), device=cuda_device)
    net = convert.load_codec_npz(str(tmp_path / "m" / "best_model.npz"), cfg.net,
                                 device=cuda_device)
    xyz = _plane_cloud(10, 3000)
    enc, dec = rans.encode_launches, rans.decode_launches
    out = codec.compress_point_cloud(xyz, net, str(tmp_path / "c.bin"),
                                     config=cfg.net, device=cuda_device)
    got = codec.decompress_point_cloud(str(tmp_path / "c.bin"), net, config=cfg.net,
                                       device=cuda_device)
    assert rans.encode_launches > enc and rans.decode_launches > dec
    assert out["num_points"] == got["num_points"] == xyz.shape[0]
    np.testing.assert_array_equal(
        np.unique(got["point_cloud"].astype(np.int64), axis=0), xyz)


@pytest.mark.cuda
def test_dp_under_nccl_with_one_rank(cuda_device, tmp_path):
    """NCCL with one rank on the card: the dry run (one DP scene step at
    phase 2 and one DP codec step, both finite, in a spawned rank), then in
    this process a mean- and a sum-reduce that leave the tensors exact and
    a one-rank DP codec step whose reduced gradients are the patch's own,
    within 2x the spread of three single-process gradients plus 1e-6 of
    each leaf's largest value (the card's atomics in the gathers'
    backward make two runs differ)."""
    from gauspcc_tpu_torch.codecs.gauspcgc import model as pcc
    from gauspcc_tpu_torch.parallel import dist as pdist, dp, dryrun

    loss, bpp = dryrun.run(1, "nccl", "cuda")
    assert np.isfinite(loss) and np.isfinite(bpp)
    dev = pdist.init(0, 1, "nccl", "cuda", str(tmp_path / "rdzv"))
    try:
        t = {"a": torch.randn((5, 3), device=dev), "b": torch.ones((), device=dev)}
        want = {k: v.clone() for k, v in t.items()}
        pdist.all_reduce_mean_(t)
        pdist.all_reduce_sum_(t)
        for k in t:
            assert torch.equal(t[k], want[k]), k
        cfg = pcc.NetConfig(8, 3)
        net = pcc.init_net(cfg, 0).to(dev)
        rng = np.random.default_rng(0)
        pts = np.unique(rng.integers(0, 32, size=(800, 3)), axis=0)[:400]
        patch = dp.pack_patch(pts.astype(np.int64),
                              dp.default_capacity_schedule(512, 3))
        levels = [tuple(torch.as_tensor(patch[k][i], device=dev)
                        for k in ("pc", "po", "pm", "gt")) for i in range(3)]
        runs = [dp.patch_gradients(net, cfg, levels, patch["n_points"])
                for _ in range(3)]
        opt = dp.adam(1e-3)
        step = dp.make_dp_train_step(opt, cfg)
        _, got_bpp, got = step(net, opt.init(dict(net.named_parameters())),
                               dp.stack_patches([patch], dev))
        assert got_bpp == pytest.approx(float(runs[0][1]), rel=1e-6)
        chip_smoke.hold_within_spread("one-rank DP codec step", {"grad": got},
                                      [{"grad": g} for g, _ in runs])
    finally:
        torch.distributed.destroy_process_group()


def _k3_against_plain(idx, w, g, rows):
    """K3's gradient twice (bit-identical, two launches) and within
    kernel_grad_tolerance of the exact gradient (the plain version in
    float64): K3 rounds each term along a path of at most 5 + CHUNK / 32
    + ceil(n / CHUNK) additions. Returns K3's gradient and the tolerance."""
    before = hashgrid.backward_launches
    got = hashgrid.table_grad(idx, w, g, rows)
    again = hashgrid.table_grad(idx, w, g, rows)
    torch.cuda.synchronize()
    assert hashgrid.backward_launches == before + 2
    assert torch.equal(got, again)
    exact = hashgrid.table_grad_reference(idx, w.double(), g.double(), rows)
    tol = hashgrid.kernel_grad_tolerance(idx, w, g, rows)
    assert got.shape == exact.shape and bool(torch.isfinite(got).all())
    assert float(((got.double() - exact).abs() - tol).max()) <= 0.0
    return got, tol


@pytest.mark.cuda
def test_table_grad_kernel_matches_plain_version_at_the_cell_shape(cuda_device):
    """K3 at the hac.train_rd cell's shape: 262,144 points (159,990 anchors
    and the bucket's padding rows at anchor 0), HACConfig's full spec, each
    of the four tables."""
    lookups = chip_smoke.grid_lookups(
        hashgrid.make_mixed_spec(), chip_smoke.hac_grid_points(0, cuda_device),
        torch.Generator(device=cuda_device).manual_seed(0))
    for s, idx, w, g in lookups.values():
        got, tol = _k3_against_plain(idx, w, g, s.n_rows)
        counts = torch.bincount(idx.reshape(-1).long(), minlength=s.n_rows)
        # the padding rows' cell
        assert int(counts.max()) >= chip_smoke.GRID_BUCKET - chip_smoke.GRID_ANCHORS
        assert bool((got[counts == 0] == 0).all())
        # the tolerance sees one chunk of that row left out
        n, excess = chip_smoke.dropped_chunk_excess(idx, w, g, s.n_rows, got, tol)
        assert n == int(counts.max()) and excess > 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["one_row", "aligned_runs", "ragged",
                                    "single_lookup", "four_features"])
def test_table_grad_kernel_at_chunk_edges(cuda_device, layout):
    """Runs that start, end or lie exactly on K3's chunk edges, one run over
    many chunks, a partial last chunk, unhit rows, one lookup, F = 4."""
    gen = torch.Generator().manual_seed(len(layout))
    chunk, corners, f, rows = hashgrid.CHUNK, 8, 2, 5000
    if layout == "one_row":  # every lookup in one row: 3 chunks and a bit
        keys = torch.full((3 * chunk + 40,), 17)
    elif layout == "aligned_runs":  # runs of exactly one chunk, then 32
        keys = torch.cat([torch.full((chunk,), r) for r in (3, 9, 4000)]
                         + [torch.full((32,), r) for r in range(100, 164)])
    elif layout == "single_lookup":
        corners, keys = 1, torch.tensor([rows - 1])
    else:  # random rows, a few of them hot, in random order
        if layout == "four_features":
            f = 4
        keys = torch.randint(0, rows, (7 * chunk + 8 * 129,), generator=gen)
        hot = torch.rand(keys.shape, generator=gen) < 0.4
        keys = torch.where(hot, torch.randint(0, 3, keys.shape, generator=gen), keys)
    m = keys.numel() - keys.numel() % corners
    keys = keys[torch.randperm(keys.numel(), generator=gen)][:m]
    n = m // corners
    idx = keys.reshape(n, 1, corners).to(torch.int32).to(cuda_device)
    w = torch.rand((n, 1, corners), generator=gen).to(cuda_device)
    g = torch.randn((n, f), generator=gen).to(cuda_device)
    got, tol = _k3_against_plain(idx, w, g, rows)
    if layout == "one_row":  # a dropped chunk lies outside the tolerance
        n, excess = chip_smoke.dropped_chunk_excess(idx, w, g, rows, got, tol)
        assert n == m and excess > 0.0


@pytest.mark.cuda
def test_grid_on_card_takes_k3_for_the_table_gradient(cuda_device):
    """MixedTables on a CUDA table under grad: the forward bit-identical to
    the no-grad call's (the plain path), one K3 launch a table, each table's
    gradient within table_grad_tolerance of autograd's through the plain
    gather (the STE passing it through) and within kernel_grad_tolerance of
    the exact one, and the same bits a second time."""
    kw = dict(n_features=2, resolutions_3d=(18, 44, 130, 300),
              log2_hashmap_size=15, resolutions_2d=(130, 514),
              log2_hashmap_size_2d=13)
    spec = hashgrid.make_mixed_spec(**kw)
    mod = hashgrid.MixedTables(spec).init_uniform(np.random.default_rng(1),
                                                  std=1.5).to(cuda_device)
    x = torch.rand((20_000, 3), generator=torch.Generator().manual_seed(2))
    x[:9000] = x[0]  # long runs: past a chunk in every level
    x[-2:] = torch.tensor([[-0.2, 0.5, 0.5], [0.5, 1.3, 0.5]])
    x = x.to(cuda_device)
    with torch.no_grad():
        plain = mod(x)
    params = [getattr(mod, n) for n in hashgrid.TABLE_NAMES]
    g = torch.randn(plain.shape, generator=torch.Generator().manual_seed(3)
                    ).to(cuda_device)
    grads = []
    for _ in range(2):
        before = hashgrid.backward_launches
        out = mod(x)
        assert torch.equal(out, plain)
        grads.append(torch.autograd.grad(out, params, g))
        torch.cuda.synchronize()
        assert hashgrid.backward_launches == before + 4
    at = 0
    for p, a, b, (s, xs) in zip(params, *grads,
                                chip_smoke.grid_slices(spec, x).values()):
        assert torch.equal(a, b)
        idxs, ws = zip(*hashgrid._level_lookups(s, xs))
        oob = ((xs < 0.0) | (xs > 1.0)).any(-1)
        g_t = torch.where(oob[:, None], 0.0, g[:, at:at + s.output_dim])
        at += s.output_dim
        leaf = p.detach().requires_grad_(True)
        tb = ste_binary(leaf)
        ref = torch.cat([hashgrid._interpolate(tb, i, w_l)
                         for i, w_l in zip(idxs, ws)], -1)
        want, = torch.autograd.grad(ref, leaf, g_t)
        idx = torch.stack([i.to(torch.int32) for i in idxs], 1)
        w = torch.stack(ws, 1)
        tol = hashgrid.table_grad_tolerance(idx, w, g_t, s.n_rows)
        assert float(((a - want).abs() - tol).max()) <= 0.0
        exact = (hashgrid.table_grad_reference(idx, w.double(), g_t.double(),
                                               s.n_rows)
                 * (p.detach().abs() <= 1.0))  # the STE's pass-through
        tol = hashgrid.kernel_grad_tolerance(idx, w, g_t, s.n_rows)
        assert float(((a.double() - exact).abs() - tol).max()) <= 0.0


@pytest.mark.cuda
def test_traced_grid_backward_counts_k3_inside_its_span(cuda_device,
                                                         monkeypatch):
    """Under a profiler the recorder counts one grid_bwd_launches a table in
    the backward, in the span open around it (backward spans take no
    counts), and every launch falls inside the span hac.grid.bwd."""
    spec = hashgrid.make_mixed_spec(
        n_features=2, resolutions_3d=(18, 44), log2_hashmap_size=14,
        resolutions_2d=(130,), log2_hashmap_size_2d=12)
    mod = hashgrid.MixedTables(spec).init_uniform(np.random.default_rng(0),
                                                  std=1.5).to(cuda_device)
    x = torch.rand((5000, 3), generator=torch.Generator().manual_seed(0)
                   ).to(cuda_device)
    params = [getattr(mod, n) for n in hashgrid.TABLE_NAMES]
    at_launch = []
    launch = hashgrid.launch_table_grad

    def marked(*args):
        at_launch.append(profiling.mark().ns)
        return launch(*args)

    monkeypatch.setattr(hashgrid, "launch_table_grad", marked)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        profiling.reset()
        with profiling.span("step"):
            out = mod(x)
            with profiling.span("backward"):
                torch.autograd.grad(out, params, torch.ones_like(out))
        torch.cuda.synchronize()
    spans = profiling.spans()
    grid = [sp for sp in spans if sp.name == "hac.grid.bwd"]
    assert len(grid) == 1 and grid[0].device_ms > 0.0
    assert len(at_launch) == 4
    assert all(grid[0].start_ns <= t <= grid[0].end_ns for t in at_launch)
    by_name = {sp.name: sp.counters for sp in spans}
    assert by_name["backward"].get("grid_bwd_launches") == 4
    assert profiling.counters()["grid_bwd_launches"] == 4


# the cat3dgs.train_rd cell's field: planes of one channel at 67, 134 and
# 268 (282,807 pixels), read at a bucket of 262,144 rows whose last 102,154
# (padding) all sit at the first anchor
CAT_RESOLUTIONS, CAT_BUCKET, CAT_ANCHORS = (67, 134, 268), 262_144, 159_990


def _cat_anchors(device, seed: int) -> torch.Tensor:
    """[CAT_BUCKET, 3] anchors about the identity frame, the padding rows
    at anchor 0."""
    x = torch.randn((CAT_BUCKET, 3), generator=torch.Generator(
        device=device).manual_seed(seed), device=device) * 1.5
    x[CAT_ANCHORS:] = x[0]
    return x


@pytest.mark.cuda
def test_table_grad_kernel_at_the_triplane_shape(cuda_device):
    """K3 on the CAT cell's planes: 282,807 rows of one float, 36 taps a
    point (3 scales, 3 planes, 4 taps), each of the padding rows' taps one
    run of ~100k lookups into one pixel; within kernel_grad_tolerance of
    the exact gradient, bit-identical over two calls, and that tolerance
    sees one chunk of the longest run dropped."""
    cfg = cfield.FieldConfig(base_resolution=CAT_RESOLUTIONS[0])
    field = cfield.Field(cfg).to(cuda_device)
    with torch.no_grad():
        z = cfield.normalize(field, cfg, _cat_anchors(cuda_device, 0))
    idx, inside, wx, wy = tri.triplane_taps(list(field.scales), z)
    idx, w = idx.to(torch.int32), tri.tap_weights(inside, wx, wy)
    rows = 3 * sum(r * r for r in CAT_RESOLUTIONS)
    assert rows == 282_807 and tuple(idx.shape) == (CAT_BUCKET, 9, 4)
    g = torch.randn((CAT_BUCKET, 9), generator=torch.Generator(
        device=cuda_device).manual_seed(1), device=cuda_device)
    got, tol = _k3_against_plain(idx, w, g, rows)
    counts = torch.bincount(idx.reshape(-1).long(), minlength=rows)
    assert int(counts.max()) >= CAT_BUCKET - CAT_ANCHORS
    assert bool((got[counts == 0] == 0).all())
    n, excess = chip_smoke.dropped_chunk_excess(idx, w, g, rows, got, tol)
    assert n == int(counts.max()) and excess > 0.0


@pytest.mark.cuda
def test_cat_field_step_launches_k3_once_inside_its_span(cuda_device):
    """A CAT training sample at the cell's shape, forward and backward: one
    K3 launch a step, counted as grid_bwd_launches in the span open around
    the backward and inside the span cat.field.bwd; each scale's gradient
    (gains 1, 2, 4 divide and multiply exactly) within kernel_grad_tolerance
    of the exact one and the same bits in a second step."""
    cfg = cfield.FieldConfig(base_resolution=CAT_RESOLUTIONS[0])
    field = cfield.Field(cfg).init_seeded(np.random.default_rng(0)).to(
        cuda_device)
    x = _cat_anchors(cuda_device, 2)
    g = torch.randn((CAT_BUCKET, 9), generator=torch.Generator(
        device=cuda_device).manual_seed(3), device=cuda_device)
    grads = []
    for traced in (False, True):
        before = hashgrid.backward_launches
        if traced:
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]):
                profiling.reset()
                with profiling.span("step"):
                    out = cfield.sample(field, cfg, x)
                    with profiling.span("backward"):
                        grads.append(torch.autograd.grad(out, list(field.scales), g))
                torch.cuda.synchronize()
        else:
            out = cfield.sample(field, cfg, x)
            grads.append(torch.autograd.grad(out, list(field.scales), g))
            torch.cuda.synchronize()
        assert hashgrid.backward_launches == before + 1
    spans = profiling.spans()
    bwd = [sp for sp in spans if sp.name == "cat.field.bwd"]
    assert len(bwd) == 1 and bwd[0].device_ms > 0.0
    assert {sp.name: sp.counters for sp in spans}["backward"].get(
        "grid_bwd_launches") == 1
    assert all(torch.equal(a, b) for a, b in zip(*grads))
    with torch.no_grad():
        z = cfield.normalize(field, cfg, x)
        planes = [p / cfield.gain(field, i)
                  for i, p in enumerate(cfield.quantized_planes(field))]
        idx, inside, wx, wy = tri.triplane_taps(planes, z)
        idx, w = idx.to(torch.int32), tri.tap_weights(inside, wx, wy)
    rows = 3 * sum(r * r for r in CAT_RESOLUTIONS)
    exact = hashgrid.table_grad_reference(idx, w.double(), g.double(), rows)
    tol = hashgrid.kernel_grad_tolerance(idx, w, g, rows)
    got = tri.triplane_rows(list(grads[0])).double()
    assert float(((got - exact).abs() - tol).max()) <= 0.0
