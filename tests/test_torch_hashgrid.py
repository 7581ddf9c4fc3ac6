"""Port parity: hash-grid encoder (gauspcc_tpu_torch.fields.hashgrid
against gauspcc_tpu.fields.hashgrid) on the same numpy tables and points.

Tolerance: rtol 1e-5, atol 1e-6 (float32 weight products and sums taken
in another order); specs and layouts exact."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gauspcc_tpu.fields import hashgrid as jh
from gauspcc_tpu_torch.fields import hashgrid as th

RTOL, ATOL = 1e-5, 1e-6


def _points(rng, n, d):
    x = rng.random((n, d)).astype(np.float32)
    x[:3] = [[-0.1] * d, [1.2] * d, [1.0] * d]  # two outside [0, 1], one on the edge
    return x


@pytest.mark.parametrize("num_dim,resolutions,log2", [
    (3, (6, 10, 16), 13),        # dense levels
    (3, (18, 44, 130), 12),      # hashed levels (uint32 wrap)
    (2, (16, 130, 514), 10),     # plane grid, hashed
])
def test_encode_matches_jax(num_dim, resolutions, log2):
    rng = np.random.default_rng(num_dim + log2)
    jspec = jh.make_spec(num_dim, 2, resolutions, log2)
    tspec = th.make_spec(num_dim, 2, resolutions, log2)
    assert tuple(jspec) == tuple(tspec)
    table = rng.uniform(-1, 1, (tspec.n_rows, 2)).astype(np.float32)
    x = _points(rng, 300, num_dim)
    want = np.asarray(jh.encode(jspec, jnp.asarray(table), jnp.asarray(x)))
    got = th.encode(tspec, torch.from_numpy(table), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert np.all(got[:2] == 0.0)


def test_mixed_encode_and_flat_layout_match_jax():
    rng = np.random.default_rng(3)
    kw = dict(n_features=2, resolutions_3d=(6, 24, 60), log2_hashmap_size=12,
              resolutions_2d=(16, 130), log2_hashmap_size_2d=10)
    jspec = jh.make_mixed_spec(**kw)
    tables_np = {
        "xyz": rng.uniform(-1e-4, 1e-4, (jspec.xyz.n_rows, 2)),
        "xy": rng.uniform(-1e-4, 1e-4, (jspec.plane.n_rows, 2)),
        "xz": rng.uniform(-1e-4, 1e-4, (jspec.plane.n_rows, 2)),
        "yz": rng.uniform(-1e-4, 1e-4, (jspec.plane.n_rows, 2)),
    }
    tables_np = {k: v.astype(np.float32) for k, v in tables_np.items()}
    mod = th.MixedTables(th.make_mixed_spec(**kw))
    with torch.no_grad():
        for k, v in tables_np.items():
            getattr(mod, k).copy_(torch.from_numpy(v))
    x = _points(rng, 200, 3)
    jt = {k: jnp.asarray(v) for k, v in tables_np.items()}
    want = np.asarray(jh.mixed_encode(jspec, jt, jnp.asarray(x)))
    with torch.no_grad():
        got = mod(torch.from_numpy(x)).numpy()
    assert got.shape == (200, jspec.output_dim)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(mod.flat().detach().numpy(),
                                  np.asarray(jh.flat_tables(jt)))


def test_full_width_hac_spec_matches_jax():
    """HACConfig's published widths: 12 3-D levels to 514 at 2^19 rows and
    4 plane levels to 1026 at 2^17 rows."""
    j = jh.make_mixed_spec()
    t = th.make_mixed_spec()
    assert tuple(j.xyz) == tuple(t.xyz) and tuple(j.plane) == tuple(t.plane)
    assert t.xyz.n_rows + 3 * t.plane.n_rows == 5_040_744
