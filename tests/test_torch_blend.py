"""Port parity: per-tile blend (gauspcc_tpu_torch.render.tile_blend).

The plain PyTorch version is held against the JAX package's Pallas kernel
in interpret mode on the same tile lists, at rtol 2e-4 / atol 2e-5 (the
tolerance of the JAX package's own Pallas test). The CUDA kernel itself
runs only on the card: see tests/test_torch_cuda.py."""

import re
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import chip_smoke
from gauspcc_tpu.render import pallas_blend
from gauspcc_tpu_torch.render import tile_blend

RTOL, ATOL = 2e-4, 2e-5


def _tile_lists(seed, tiles_x, tiles_y, k):
    """Random lists with an empty tile, short ones and ones over K; the
    Gaussians of each tile lie around it, stored in shuffled order."""
    rng = np.random.default_rng(seed)
    n_tiles = tiles_x * tiles_y
    counts = rng.integers(1, 2 * k, n_tiles)
    counts[0] = 0
    counts[1] = k + 5
    n = int(counts.sum())
    tile_of = np.repeat(np.arange(n_tiles), counts)
    origin = np.stack([tile_of % tiles_x, tile_of // tiles_x], -1) * 16.0
    mean2d = origin + rng.uniform(-8, 24, (n, 2))
    conic = np.stack([rng.uniform(0.02, 0.3, n), rng.uniform(-0.01, 0.01, n),
                      rng.uniform(0.02, 0.3, n)], -1)
    opacity = rng.uniform(0.05, 0.9, n)
    colors = rng.uniform(0, 1, (n, 3))
    perm = rng.permutation(n)

    def shuffled(v):
        out = np.empty_like(v)
        out[perm] = v
        return torch.from_numpy(out.astype(np.float32))

    tile_start = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return (torch.from_numpy(tile_start),
            torch.from_numpy(perm.astype(np.int32)),
            shuffled(mean2d), shuffled(conic), shuffled(opacity),
            shuffled(colors),
            torch.tensor([0.1, 0.2, 0.3]))


def _pallas_blend(args, tiles_x, k):
    """The JAX package's Pallas path on the same lists: gather the [T, K, 8]
    records as raster.py:317-337 does, blend in interpret mode."""
    tile_start, pair_gauss, mean2d, conic, opacity, colors, bg = (
        a.numpy() for a in args)
    n_tiles = tile_start.shape[0] - 1
    kc = pallas_blend.KCHUNK
    k_pad = -(-k // kc) * kc
    starts = tile_start[:-1]
    take = np.minimum(tile_start[1:] - starts, k)
    gidx = pair_gauss[np.clip(starts[:, None] + np.arange(k)[None, :], 0,
                              pair_gauss.shape[0] - 1)]
    gmask = np.arange(k)[None, :] < take[:, None]
    records = np.zeros((n_tiles, k_pad, 8), np.float32)
    records[:, :k, 0:2] = mean2d[gidx]
    records[:, :k, 2:5] = conic[gidx]
    records[:, :k, 5] = np.where(gmask, opacity[gidx], 0.0)
    cols4 = np.zeros((n_tiles, k_pad, 4), np.float32)
    cols4[:, :k, :3] = colors[gidx]
    tids = np.arange(n_tiles)
    origins = np.stack([tids % tiles_x, tids // tiles_x], -1).astype(np.float32) * 16
    out = pallas_blend.blend_tiles(
        jnp.asarray(origins), jnp.asarray(records), jnp.asarray(cols4),
        jnp.asarray(np.concatenate([bg, [0.0]]).astype(np.float32)),
        interpret=True)
    return torch.from_numpy(np.asarray(out)[:, :, :3].copy())


@pytest.mark.parametrize("k", [32, 64])
def test_reference_matches_pallas_interpret(k):
    tiles_x, tiles_y = 3, 2
    args = _tile_lists(k, tiles_x, tiles_y, k)
    kw = dict(tiles_x=tiles_x, height=32, width=48, max_k=k)
    got = tile_blend.blend_tiles_reference(*args, **kw)
    want = tile_blend.tiles_to_image(_pallas_blend(args, tiles_x, k), tiles_x,
                                     32, 48)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL, atol=ATOL)


def test_wrapper_on_cpu_takes_the_plain_version_without_launching():
    args = _tile_lists(5, 2, 2, 32)
    kw = dict(tiles_x=2, height=30, width=25, max_k=32)
    before = tile_blend.launches
    got = tile_blend.blend_tiles(*args, **kw)
    assert tile_blend.launches == before
    assert got.shape == (3, 30, 25)
    np.testing.assert_array_equal(
        got.numpy(), tile_blend.blend_tiles_reference(*args, **kw).numpy())


@pytest.mark.parametrize("bad", ["dtype", "shape", "tiles"])
def test_wrapper_rejects_malformed_inputs(bad):
    args = list(_tile_lists(6, 2, 2, 32))
    kw = dict(tiles_x=2, height=32, width=32, max_k=32)
    if bad == "dtype":
        args[1] = args[1].long()
    elif bad == "shape":
        args[3] = args[3][:, :2]
    else:
        kw["height"] = 40  # 2 rows of tiles cannot cover 40 rows
    with pytest.raises(ValueError):
        tile_blend.blend_tiles(*args, **kw)


def test_entries_evaluated_counts_until_saturation():
    """Against a per-pixel loop: an entry is evaluated while T_before is
    still at or above 1e-4, and blended if its alpha is also >= 1/255."""
    args = _tile_lists(8, 2, 1, 48)
    tile_start, pair_gauss, mean2d, conic, opacity = (a.numpy() for a in args[:5])
    want_eval = want_blend = 0
    for t in range(2):
        start = tile_start[t]
        ids = pair_gauss[start:start + min(tile_start[t + 1] - start, 48)]
        for p in range(256):
            px, py = 16 * t + p % 16, p // 16
            trans = 1.0
            for g in ids:
                if trans < 1e-4:
                    break
                want_eval += 1
                dx, dy = px - mean2d[g, 0], py - mean2d[g, 1]
                a, b, c = conic[g]
                power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
                alpha = min(0.99, opacity[g] * np.exp(min(power, 0.0)))
                if alpha >= 1 / 255:
                    want_blend += 1
                    trans *= 1 - alpha
    evaluated, blended = chip_smoke.entries_evaluated(*args[:5], tiles_x=2,
                                                      max_k=48)
    assert 0 < blended < evaluated
    # a T within rounding of 1e-4 may differ
    assert abs(evaluated - want_eval) <= 2
    assert abs(blended - want_blend) <= 2


def test_entries_per_tile_sum_to_entries_evaluated():
    args = _tile_lists(9, 3, 2, 40)
    ev_tile, bl_tile = chip_smoke.entries_per_tile(*args[:5], tiles_x=3,
                                                   max_k=40)
    assert ev_tile.shape == bl_tile.shape == (6,)
    assert int(ev_tile[0]) == 0  # the empty tile
    assert bool((bl_tile <= ev_tile).all())
    assert (int(ev_tile.sum()), int(bl_tile.sum())) == chip_smoke.entries_evaluated(
        *args[:5], tiles_x=3, max_k=40)


def test_tile_order_reference_is_longest_first():
    """The plain version of the kernel's schedule: a permutation of the
    tiles by descending bucket of min(count, K); bucket 0 only for empty
    tiles, the top bucket for a full one, buckets growing with length."""
    rng = np.random.default_rng(11)
    k = 300
    counts = rng.integers(0, 2 * k, 200)
    counts[:3] = [0, k, 1]
    tile_start = torch.from_numpy(
        np.concatenate([[0], np.cumsum(counts)]).astype(np.int32))
    bucket, order = tile_blend.tile_order_reference(tile_start, k)
    length = torch.from_numpy(np.minimum(counts, k))
    assert torch.equal(torch.sort(order).values, torch.arange(200))
    assert bool((bucket[order][:-1] >= bucket[order][1:]).all())
    assert torch.equal(bucket == 0, length == 0)
    assert int(bucket[1]) == tile_blend.ORDER_BUCKETS - 1 and int(bucket[2]) == 1
    by_len = bucket[torch.argsort(length)]
    assert bool((by_len[:-1] <= by_len[1:]).all())


@pytest.mark.parametrize("n_tiles", [0, 1, 1024])
def test_schedule_words_hold_every_part_of_the_schedule(n_tiles):
    """The counter, the sorted tiles, a claim per tile, and a rank counter
    for each SM id the kernel deals to (it clamps %nsmid to them)."""
    words = tile_blend.schedule_words(n_tiles)
    assert words == 1 + n_tiles + n_tiles + tile_blend.SCHED_SM_IDS
    assert tile_blend.SCHED_SM_IDS >= 132  # an H100 SXM's SMs


def test_wrapper_constants_match_the_kernel_source():
    """The wrapper sizes the schedule's scratch, and its plain version
    buckets the lists, with the kernel's own constants."""
    src = (Path(tile_blend.__file__).parents[1] / "csrc" / "tile_blend.cu"
           ).read_text()

    def constant(name):
        found = re.findall(rf"constexpr int {name} = (\d+);", src)
        assert len(found) == 1, name
        return int(found[0])

    assert constant("kMaxSmIds") == tile_blend.SCHED_SM_IDS
    assert constant("kBuckets") == tile_blend.ORDER_BUCKETS
    assert constant("kTile") == tile_blend.TILE
