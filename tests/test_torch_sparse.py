"""The port's general sparse conv and its geometry
(gauspcc_tpu_torch/ops/sparse.py, ops/hostmap.py `build_map_packed`)
against the JAX package's (gauspcc_tpu/ops/sparse.py, ops/hostmap.py), on
the same seeded numpy inputs, on the CPU.

Tolerances, each with its reason:
- the geometry (`lex_sort`, `fcg_expand`, `kernel_offsets`,
  `build_neighbor_map`, `nmap_from_host`, `build_map_packed`,
  `pack_lo_np`, `expand_lo`, `nmap_from_packed`): exact, padding included,
  it is integer work;
- `sparse_conv_apply` in float32: atol 1e-5 (the same products summed in
  another order by another GEMM);
- its dx, dw and db against `jax.grad` under a seeded upstream gradient:
  1e-5 of each leaf's largest magnitude (the port's scatter-free backward
  sums each gradient in another order than JAX's scatter-add).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gauspcc_tpu.ops import hostmap as jhostmap, sparse as jsparse
from gauspcc_tpu_torch.ops import hostmap, sparse

from test_torch_native_libs import ensure_jax_native_libs

ensure_jax_native_libs()  # before any test here loads one

CONV_ATOL = 1e-5
GRAD_REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op torch thread for the module (the lane runs 6 workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _voxels(rng, n, extent, low=0):
    """n unique voxels in [low, low + extent)^3, lex-sorted, int32."""
    pts = rng.integers(low, low + extent, size=(n * 2, 3))
    pts = np.unique(pts, axis=0)[:n]
    return pts[np.lexsort((pts[:, 0], pts[:, 1], pts[:, 2]))].astype(np.int32)


def _padded(coords, extra, rng):
    """coords with `extra` garbage rows after them and the validity mask."""
    pad = rng.integers(-4, 4, (extra, 3)).astype(np.int32)
    mask = np.arange(coords.shape[0] + extra) < coords.shape[0]
    return np.concatenate([coords, pad]), mask


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_lex_sort_and_fcg_expand_equal_jax():
    """Shuffled coords with negative values, duplicate garbage padding."""
    rng = np.random.default_rng(0)
    coords = _voxels(rng, 400, 30, low=-9)
    rng.shuffle(coords)
    pad, mask = _padded(coords, 60, rng)
    want = np.asarray(jsparse.lex_sort(jnp.asarray(pad), jnp.asarray(mask)))
    got = sparse.lex_sort(_t(pad), _t(mask))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not mask[got.numpy()][400:].any()
    occ = rng.integers(0, 256, pad.shape[0]).astype(np.int32)
    want = jsparse.fcg_expand(jnp.asarray(pad), jnp.asarray(occ), jnp.asarray(mask))
    got = sparse.fcg_expand(_t(pad), _t(occ), _t(mask))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for k in (3, 5):
        np.testing.assert_array_equal(hostmap.kernel_offsets(k).numpy(),
                                      jsparse.kernel_offsets(k))


def test_build_neighbor_map_equal_jax():
    """Queries and sources the same padded, shuffled set (the codec's
    self-maps) and a second query set against them; idx and valid equal
    JAX's, padding included."""
    rng = np.random.default_rng(1)
    src = _voxels(rng, 500, 24, low=-3)
    rng.shuffle(src)
    s_pad, s_mask = _padded(src, 40, rng)
    q_pad, q_mask = _padded(_voxels(rng, 300, 26, low=-4), 20, rng)
    for (cq, mq) in ((s_pad, s_mask), (q_pad, q_mask)):
        want = jsparse.build_neighbor_map(jnp.asarray(cq), jnp.asarray(mq),
                                          jnp.asarray(s_pad), jnp.asarray(s_mask), 3)
        got = sparse.build_neighbor_map(_t(cq), _t(mq), _t(s_pad), _t(s_mask), 3)
        assert got.idx.dtype == torch.int32 and got.valid.dtype == torch.bool
        np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
        np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
        assert got.valid.any()


def test_packed_maps_equal_jax_byte_for_byte():
    """build_map_packed (the port's copy of neighbor.cpp) equals JAX's
    bytes; pack_lo_np, expand_lo and nmap_from_packed equal JAX's, on the
    map and on a lo with jumps, negative values and padding garbage; the
    dense map of `nmap_from_host` too."""
    rng = np.random.default_rng(2)
    coords = _voxels(rng, 1200, 40)
    n = coords.shape[0]
    padded = np.zeros((n + 70, 3), np.int32)
    padded[:n] = coords
    want_lo, want_codes = jhostmap.build_map_packed(padded, n, 3, n + 70)
    lo, codes = hostmap.build_map_packed(padded, n, 3, n + 70)
    assert lo.dtype == want_lo.dtype and codes.dtype == want_codes.dtype
    assert lo.tobytes() == want_lo.tobytes()
    assert codes.tobytes() == want_codes.tobytes()

    wild = np.sort(rng.integers(0, 5000, (9, 1000)), axis=1).astype(np.int32)
    wild[:, 700:] = rng.integers(-3, 4, (9, 300))
    wild[2, 100] = 200_000
    for case in (lo, wild):
        want = jsparse.pack_lo_np(case)
        got = sparse.pack_lo_np(case)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        out = sparse.expand_lo(sparse.PackedLo(*map(_t, got)), case.shape[1])
        assert out.dtype == torch.int32
        np.testing.assert_array_equal(out.numpy(), case)

    want = jsparse.nmap_from_packed(
        jsparse.WindowMap(jnp.asarray(lo), jnp.asarray(codes)), 3)
    got = sparse.nmap_from_packed(
        sparse.WindowMap(_t(lo), _t(codes.astype(np.int32))), 3)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    dense = jhostmap.build_map(padded, n, 3, n + 70)
    want = jsparse.nmap_from_host(jnp.asarray(dense))
    got = sparse.nmap_from_host(hostmap.build_map(_t(padded), n, 3, n + 70))
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    with pytest.raises(ValueError, match="9 kernel rows .* kernel of size 5"):
        sparse.nmap_from_packed(sparse.WindowMap(_t(lo), _t(codes.astype(np.int32))), 5)


def _conv_case(rng, kernel_size, n, extent, cin, cout, extra=30):
    """A codec-like self-map (host-built, packed, expanded) with padding
    queries, features, weights, bias and an upstream gradient."""
    coords = _voxels(rng, n, extent)
    nv = coords.shape[0]
    padded = np.zeros((nv + extra, 3), np.int32)
    padded[:nv] = coords
    lo, codes = jhostmap.build_map_packed(padded, nv, kernel_size, nv + extra)
    x = rng.standard_normal((nv + extra, cin)).astype(np.float32)
    w = (0.3 * rng.standard_normal((kernel_size**3, cin, cout))).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    up = rng.standard_normal((nv + extra, cout)).astype(np.float32)
    return lo, codes, x, w, b, up


def _check_conv(kernel_size, lo, codes, x, w, b, up):
    jmap = jsparse.nmap_from_packed(
        jsparse.WindowMap(jnp.asarray(lo), jnp.asarray(codes)), kernel_size)
    nmap = sparse.nmap_from_packed(
        sparse.WindowMap(_t(lo), _t(codes.astype(np.int32))), kernel_size)

    def loss(x_, w_, b_):
        return jnp.sum(jsparse.sparse_conv_apply(x_, jmap, w_, b_) * up)

    want_y = jsparse.sparse_conv_apply(jnp.asarray(x), jmap, jnp.asarray(w),
                                       jnp.asarray(b))
    want_g = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w),
                                               jnp.asarray(b))
    leaves = [torch.tensor(a, requires_grad=True) for a in (x, w, b)]
    y = sparse.sparse_conv_apply(*leaves[:1], nmap, *leaves[1:])
    assert y.dtype == torch.float32 and y.shape == want_y.shape
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y), rtol=0,
                               atol=CONV_ATOL)
    (y * _t(up)).sum().backward()
    for name, leaf, want in zip("xwb", leaves, want_g):
        want = np.asarray(want)
        err = np.abs(leaf.grad.numpy() - want).max() / np.abs(want).max()
        assert err <= GRAD_REL, f"d{name}: {err:.3e} of its largest magnitude"


def test_sparse_conv_and_gradients_equal_jax(monkeypatch):
    """k = 3 (27 taps: 4 groups of 8, 5 absent taps appended), then with
    the gather budget cut so the group shrinks to 3 taps (as JAX's shrinks
    at large Nq): forward, dx, dw and db each time."""
    rng = np.random.default_rng(3)
    case = _conv_case(rng, 3, 900, 20, 16, 12)
    _check_conv(3, *case)
    nq, cin = case[2].shape
    monkeypatch.setattr(sparse, "GATHER_BUDGET", 3 * nq * cin)
    assert sparse.group_size(nq, cin) == 3
    _check_conv(3, *case)


def test_sparse_conv_k5_map_and_gradients_equal_jax():
    """The one k = 5 case, 8 channels: the device-built map equals JAX's
    and the host-built one's expansion; the conv over it (125 taps: 16
    groups, 3 absent taps) and its gradients equal JAX's."""
    rng = np.random.default_rng(4)
    lo, codes, x, w, b, up = _conv_case(rng, 5, 700, 16, 8, 8)
    nq = x.shape[0]
    nv = nq - 30
    coords = np.zeros((nq, 3), np.int32)
    coords[:nv] = _voxels(np.random.default_rng(4), 700, 16)
    mask = np.arange(nq) < nv
    want = jsparse.build_neighbor_map(jnp.asarray(coords), jnp.asarray(mask),
                                      jnp.asarray(coords), jnp.asarray(mask), 5)
    got = sparse.build_neighbor_map(_t(coords), _t(mask), _t(coords), _t(mask), 5)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    packed = sparse.nmap_from_packed(sparse.WindowMap(_t(lo), _t(codes.astype(np.int32))), 5)
    assert torch.equal(packed.valid, got.valid)
    assert torch.equal(torch.where(got.valid, packed.idx, 0), got.idx)
    _check_conv(5, lo, codes, x, w, b, up)
