"""Tests of the port that need an NVIDIA GPU: a CUDA kernel has no CPU mode.

Marked `cuda`; without a card they skip. This file imports no JAX, so it
also runs on the machine with the card, which has none:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(`--noconftest` because tests/conftest.py sets JAX up.)"""

import numpy as np
import pytest
import torch

import chip_smoke
from gauspcc_tpu_torch.render import raster, tile_blend


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
    before = tile_blend.launches
    got = tile_blend.blend_tiles(*args, **kw)
    torch.cuda.synchronize()
    assert tile_blend.launches == before + 1
    want = tile_blend.blend_tiles_reference(*args, **kw)
    rtol, atol = tile_blend.kernel_tolerance(args[6], args[5])
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


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
