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
