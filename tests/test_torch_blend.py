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


def test_wrapper_packed_gradient_layout_matches_the_kernel_source():
    """The wrapper's views of the backward's packed gradient use the
    kernel's own stride and part offsets; the parts tile the kernel's
    partials without overlap, and a row is whole 16-byte vectors."""
    src = (Path(tile_blend.__file__).parents[1] / "csrc" / "tile_blend.cu"
           ).read_text()

    def constant(name):
        found = re.findall(rf"constexpr int {name} = (\d+);", src)
        assert len(found) == 1, name
        return int(found[0])

    assert constant("kGradStride") == tile_blend.GRAD_STRIDE
    assert tile_blend.GRAD_STRIDE % 4 == 0
    for name, kernel_name in (("colors", "kGradColors"),
                              ("opacity", "kGradOpacity"),
                              ("mean2d", "kGradMean"),
                              ("conic", "kGradConic")):
        assert tile_blend.GRAD_PARTS[name][0] == constant(kernel_name), name
    covered = sorted(i for at, width in tile_blend.GRAD_PARTS.values()
                     for i in range(at, at + width))
    assert covered == list(range(constant("kPartials")))


@pytest.mark.parametrize("n", [1, 5, 7])
def test_unpack_gradients_gives_views_in_autograd_shapes(n):
    """The packed [N, 12] buffer's views are the gradients of mean2d [N, 2],
    conic [N, 3], opacity [N] and colors [N, 3], each at its part's offset,
    sharing the buffer; autograd takes them as a Function's gradients."""
    packed = torch.arange(n * tile_blend.GRAD_STRIDE, dtype=torch.float32
                          ).reshape(n, tile_blend.GRAD_STRIDE)
    mean2d, conic, opacity, colors = tile_blend.unpack_gradients(packed)
    assert (mean2d.shape, conic.shape, opacity.shape, colors.shape) == (
        (n, 2), (n, 3), (n,), (n, 3))
    for got, name in ((mean2d, "mean2d"), (conic, "conic"),
                      (opacity, "opacity"), (colors, "colors")):
        at, width = tile_blend.GRAD_PARTS[name]
        want = packed[:, at:at + width].reshape(got.shape)
        assert torch.equal(got, want), name
        assert got.untyped_storage().data_ptr() == packed.untyped_storage(
        ).data_ptr(), name

    class Packed(torch.autograd.Function):
        @staticmethod
        def forward(ctx, m, c, o, col):
            return m.sum() + c.sum() + o.sum() + col.sum()

        @staticmethod
        def backward(ctx, grad):
            return tile_blend.unpack_gradients(packed * grad)

    leaves = [torch.zeros(s, requires_grad=True)
              for s in ((n, 2), (n, 3), (n,), (n, 3))]
    Packed.apply(*leaves).backward()
    for leaf, want in zip(leaves, (mean2d, conic, opacity, colors)):
        assert torch.equal(leaf.grad, want)


def _halving_schedule(values):
    """The backward's warp reduction (tile_blend.cu, ReducePipe and
    reduced_part) replayed on 32 lanes' vectors [32, 9] in float64: halving
    at lane offsets 16, 8, 4, 2 (9 -> 5 -> 3 -> 2 -> 1 values), then a
    butterfly at 1. Returns each lane's value and the partial it stores
    (-1 for none)."""
    v = [list(map(float, row)) for row in values]
    lengths = [len(v[0])]
    for off in (16, 8, 4, 2):
        n = len(v[0])
        h = (n + 1) // 2
        nxt = []
        for lane in range(32):
            mine, theirs = v[lane], v[lane ^ off]
            row = []
            for j in range(h):
                lo, hi = mine[j], mine[j + h] if j + h < n else 0.0
                p_lo, p_hi = theirs[j], theirs[j + h] if j + h < n else 0.0
                row.append(hi + p_hi if lane & off else lo + p_lo)
            nxt.append(row)
        v = nxt
        lengths.append(h)
    lengths.append(1)
    got = [v[lane][0] + v[lane ^ 1][0] for lane in range(32)]
    parts = []
    for lane in range(32):
        pos = 0
        for step in range(4, -1, -1):
            if lane & (16 >> step):
                pos += (lengths[step] + 1) // 2
            if pos >= lengths[step]:
                pos = -1
                break
        parts.append(pos)
    return got, parts


def test_recursive_halving_leaves_each_partial_summed_in_one_lane():
    """The schedule of the backward's transposed warp reduction of a
    record's 9 partials, 12 shuffles (5 + 3 + 2 + 1 + 1): each partial's
    warp sum is stored by exactly one lane, which holds it."""
    vals = np.random.default_rng(0).normal(size=(32, 9))
    got, parts = _halving_schedule(vals)
    assert sorted(p for p in parts if p >= 0) == list(range(9))
    want = vals.sum(0)
    for lane in range(32):
        if parts[lane] >= 0:
            assert abs(got[lane] - want[parts[lane]]) < 1e-12


def _quadrant_blended(tile_start, pair_gauss, mean2d, conic, opacity, *,
                     tiles_x: int, max_k: int) -> torch.Tensor:
    """[entries, 4] bool in chip_smoke.quadrant_reach's order: whether some
    pixel of the quadrant blends the entry, by the plain version."""
    counts = (tile_start[1:] - tile_start[:-1]).clamp_max(max_k)
    pix = torch.arange(tile_blend.PIX, device=mean2d.device)
    quad = (pix // tile_blend.TILE // 8) * 2 + pix % tile_blend.TILE // 8
    out = []
    for c0, c1, alpha, t_before, _, _ in tile_blend._alpha_chunks(
            tile_start, pair_gauss, mean2d, conic, opacity, tiles_x, max_k):
        blended = (t_before >= tile_blend.T_MIN) & (alpha > 0)  # [C, 256, K]
        per_q = torch.stack([blended[:, quad == q].any(1) for q in range(4)],
                            -1)  # [C, K, 4]
        keep = torch.arange(max_k, device=mean2d.device)[None, :] < counts[
            c0:c1, None]
        out.append(per_q[keep])
    return torch.cat(out) if out else torch.zeros((0, 4), dtype=torch.bool)


@pytest.mark.parametrize("lists", ["random", "thin at the cut"])
def test_quadrant_bound_keeps_every_quadrant_an_entry_is_blended_in(lists):
    """The backward leaves an entry out of a quadrant's walk only where its
    alpha cannot reach 1/255 (tile_blend.cu, quadrant_mask, mirrored by
    chip_smoke.quadrant_reach): every (entry, quadrant) that the plain
    version blends is inside the bound, which also leaves some out."""
    if lists == "random":
        args = chip_smoke.random_tiles(torch.Generator().manual_seed(4), "cpu",
                                       4, 3, 64)
        kw = dict(tiles_x=4, max_k=64)
    else:
        args = chip_smoke.cut_lists("cpu", 6, 4)
        kw = dict(tiles_x=6, max_k=4)
    reach = chip_smoke.quadrant_reach(*args[:5], **kw)
    blended = _quadrant_blended(*args[:5], **kw)
    assert reach.shape == blended.shape and bool(blended.any())
    assert not bool((blended & ~reach).any())
    if lists == "random":
        assert not bool(reach.all())


def _walk_gradients(args, grad_out, tiles_x, height, width, max_k):
    """The backward kernel's arithmetic, per pixel in float64: the forward
    with its early stop, then each list front to back with S_j and G = out
    . g (csrc/tile_blend.cu, backward_records)."""
    ts, pg = args[0].numpy(), args[1].numpy()
    m, cn, o, c, bg = (a.numpy().astype(np.float64) for a in args[2:])
    g = grad_out.numpy().astype(np.float64)
    n = m.shape[0]
    gm, gc, go, gcol = (np.zeros((n, 2)), np.zeros((n, 3)), np.zeros(n),
                        np.zeros((n, 3)))
    for tile in range(len(ts) - 1):
        ids = pg[ts[tile]:ts[tile] + min(ts[tile + 1] - ts[tile], max_k)]
        for p in range(256):
            x = (tile % tiles_x) * 16 + p % 16
            y = (tile // tiles_x) * 16 + p // 16
            if x >= width or y >= height:
                continue
            ent = []
            for i in ids:
                dx, dy = x - m[i, 0], y - m[i, 1]
                a, b, cc = cn[i]
                power = -0.5 * (a * dx * dx + cc * dy * dy) - b * dx * dy
                e = np.exp(min(power, 0.0))
                alpha = min(0.99, o[i] * e)
                ent.append((i, dx, dy, e, alpha if alpha >= 1 / 255 else 0.0))
            t, rgb = 1.0, np.zeros(3)
            for i, _, _, _, alpha in ent:
                if t >= 1e-4:
                    rgb += alpha * t * c[i]
                    t *= 1 - alpha
            gp = g[:, y, x]
            big_g = (rgb + t * bg) @ gp
            t, s = 1.0, 0.0
            for i, dx, dy, e, alpha in ent:
                live = t >= 1e-4
                w = alpha * t if live else 0.0
                s += w * (c[i] @ gp)
                dal = (t * (c[i] @ gp) - (big_g - s) / (1 - alpha)
                       if live and 0 < alpha < 0.99 else 0.0)
                t = t * (1 - alpha) if live else t
                dpow = dal * alpha if e < 1 else 0.0
                a, b, cc = cn[i]
                gcol[i] += w * gp
                go[i] += dal * e
                gm[i] += dpow * np.array([a * dx + b * dy, cc * dy + b * dx])
                gc[i] += dpow * np.array([-0.5 * dx * dx, -dx * dy, -0.5 * dy * dy])
    return gm, gc, go, gcol


@pytest.mark.parametrize("saturating", [False, True])
def test_backward_arithmetic_matches_autograd_within_gradient_tolerance(
        saturating):
    """The backward kernel's front-to-back gradient (emulated on the CPU:
    the kernel itself runs only on the card) against autograd of the plain
    version, within gradient_tolerance; with opacities near 0.99 most
    pixels stop early, where the two differ by the T_final term the
    tolerance derives."""
    args = list(_tile_lists(10 + saturating, 2, 2, 24))
    if saturating:  # wide, nearly opaque Gaussians
        args[3] = args[3] * 0.02
        args[4] = torch.full_like(args[4], 0.97)
    kw = dict(tiles_x=2, height=30, width=25, max_k=24)
    g = torch.from_numpy(np.random.default_rng(3).normal(
        size=(3, 30, 25)).astype(np.float32))
    want = tile_blend.blend_backward_reference(*args, g, **kw)
    got = _walk_gradients(args, g, **kw)
    tol = tile_blend.gradient_tolerance(*args, g, **kw)
    for name, a, b in zip(("mean2d", "conic", "opacity", "colors"), got, want):
        assert np.abs(b.numpy()).max() > 0, name
        assert (np.abs(a - b.numpy()) <= tol[name].numpy()).all(), name
    stopped = sum(int((torch.exp(log1ma.sum(-1)) < tile_blend.T_MIN).sum())
                  for *_, log1ma, _ in tile_blend._alpha_chunks(
                      *args[:5], kw["tiles_x"], kw["max_k"]))
    assert (stopped > 500) == saturating
