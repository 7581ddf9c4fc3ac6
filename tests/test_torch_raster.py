"""Port parity: tile rasterizer (gauspcc_tpu_torch.render.raster against
gauspcc_tpu.render.raster) on the same numpy Gaussians.

Tolerances: project's float outputs rtol 1e-5, atol 1e-6; radii, tile
starts and the sorted Gaussian ids exact (the tile lists are built from
JAX's own Projected arrays, so float rounding in project cannot move a
tile boundary); a whole render against JAX's float32 XLA blend atol 1e-4."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gauspcc_tpu.render import raster as jr
from gauspcc_tpu_torch.render import raster as tr

RTOL, ATOL = 1e-5, 1e-6
H, W = 48, 64


def _gaussians(seed, n=120, big=False):
    rng = np.random.default_rng(seed)
    means = (rng.random((n, 3)) * 1.4 - 0.7).astype(np.float32)
    means[:, 2] += 3.0
    means[:5, 2] = -1.0  # behind the camera
    colors = rng.random((n, 3)).astype(np.float32)
    opac = rng.uniform(0.2, 0.95, (n, 1)).astype(np.float32)
    scales = rng.uniform(0.02, 0.25 if big else 0.1, (n, 3)).astype(np.float32)
    rots = rng.normal(size=(n, 4)).astype(np.float32)
    valid = rng.random(n) > 0.1
    view = np.eye(4, dtype=np.float32)
    view[3, :3] = rng.normal(0, 0.05, 3)  # row-vector translation
    return means, colors, opac, scales, rots, valid, view


def _cfgs(d=32, k=64):
    j = jr.RasterConfig(H, W, 0.45, 0.35, max_tiles_per_gaussian=d,
                        max_gaussians_per_tile=k, blend_bf16=False)
    t = tr.RasterConfig(H, W, 0.45, 0.35, max_tiles_per_gaussian=d,
                        max_gaussians_per_tile=k)
    return j, t


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("seed", [0, 1])
def test_project_matches_jax(seed):
    means, _, _, scales, rots, valid, view = _gaussians(seed, big=True)
    jcfg, tcfg = _cfgs()
    want = jr.project(jnp.asarray(means), jnp.asarray(scales), jnp.asarray(rots),
                      jnp.asarray(view), jcfg, jnp.asarray(valid))
    got = tr.project(*_t(means, scales, rots, view), tcfg, torch.from_numpy(valid))
    for name in ("mean2d", "depth", "conic"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    np.testing.assert_array_equal(got.radius.numpy(), np.asarray(want.radius))
    assert got.radius.dtype == torch.int32
    np.testing.assert_array_equal(
        tr.visible_filter(*_t(means, scales, rots, view), tcfg,
                          torch.from_numpy(valid)).numpy(),
        np.asarray(jr.visible_filter(jnp.asarray(means), jnp.asarray(scales),
                                     jnp.asarray(rots), jnp.asarray(view), jcfg,
                                     jnp.asarray(valid))))
    assert int(tr.max_tile_footprint(*_t(means, scales, rots, view), tcfg,
                                     torch.from_numpy(valid))) == int(
        jr.max_tile_footprint(jnp.asarray(means), jnp.asarray(scales),
                              jnp.asarray(rots), jnp.asarray(view), jcfg,
                              jnp.asarray(valid)))


@pytest.mark.parametrize("d_max", [3, 4, 8])
def test_tile_lists_match_jax_exactly(d_max):
    """Same Projected arrays in, identical (tile_start, pair_gauss) out, with
    footprints over D (the centred window) and many equal depth keys (the
    stable sort)."""
    means, _, _, scales, rots, valid, view = _gaussians(2, n=150, big=True)
    means[100:120] = means[100]  # identical depths -> equal packed keys
    jcfg, tcfg = _cfgs(d=d_max)
    jp = jr.project(jnp.asarray(means), jnp.asarray(scales), jnp.asarray(rots),
                    jnp.asarray(view), jcfg, jnp.asarray(valid))
    fp = np.asarray(jr._footprints(jp, jcfg))
    assert fp.max() > d_max  # the window really is exercised
    want = jr._build_tile_lists(jp, jcfg)
    tp = tr.Projected(*(torch.from_numpy(np.array(a)) for a in jp))
    got = tr._build_tile_lists(tp, tcfg)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].dtype == got[1].dtype == torch.int32


@pytest.mark.parametrize("k", [32, 64])
def test_rasterize_matches_jax(k):
    means, colors, opac, scales, rots, valid, view = _gaussians(4)
    jcfg, tcfg = _cfgs(k=k)
    bg = np.array([0.2, 0.1, 0.9], np.float32)
    want, wr = jr.rasterize(
        means3d=jnp.asarray(means), colors=jnp.asarray(colors),
        opacities=jnp.asarray(opac), scales=jnp.asarray(scales),
        rotations=jnp.asarray(rots), viewmatrix=jnp.asarray(view),
        bg_color=jnp.asarray(bg), cfg=jcfg, valid=jnp.asarray(valid))
    m, c, o, s, r, v, b = _t(means, colors, opac, scales, rots, view, bg)
    got, gr = tr.rasterize(means3d=m, colors=c, opacities=o, scales=s,
                           rotations=r, viewmatrix=v, bg_color=b, cfg=tcfg,
                           valid=torch.from_numpy(valid))
    assert got.shape == (3, H, W)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(gr.numpy(), np.asarray(wr))


def test_depth_key_is_monotone_bitcast():
    d = torch.tensor([1e-9, 1e-6, 0.5, 1.0, 3.0, 100.0])
    k = tr._depth_key(d)
    assert k.dtype == torch.int32
    assert k[0] == k[1] and bool((k[1:].diff() > 0).all())
    np.testing.assert_array_equal(
        k.numpy(), np.asarray(jr._depth_key(jnp.asarray(d.numpy()))))
