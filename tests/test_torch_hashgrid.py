"""Port parity: hash-grid encoder (gauspcc_tpu_torch.fields.hashgrid
against gauspcc_tpu.fields.hashgrid) on the same numpy tables and points.

Tolerance: rtol 1e-5, atol 1e-6 (float32 weight products and sums taken
in another order); specs and layouts exact.

The table's gradient (K3's plain version, `table_grad_reference`, which is
also the CPU's backward of a grad call) is held against autograd's gradient
of the plain encode within `table_grad_tolerance`: both sum each row's
rounded terms w * g, in other orders. Every call's output must stay the
plain encode's bit for bit. `kernel_grad_tolerance`, which the card's
checks hold K3 to, must see a chunk of a long row dropped or repeated."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gauspcc_tpu.fields import hashgrid as jh
from gauspcc_tpu_torch.core.quant import ste_binary
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


# ---------------------------------------------------------------------------
# the table's gradient: K3's plain version against autograd, and the paths
# that keep the plain forward
# ---------------------------------------------------------------------------

def _plain_encode(spec, table, x):
    """`encode` as it was before the table gradient had a kernel: the gather,
    weights and sum level by level, differentiated by autograd."""
    d = spec.num_dim
    i = torch.arange(2**d)
    corners = (i[:, None] >> torch.arange(d)) & 1
    oob = ((x < 0.0) | (x > 1.0)).any(-1)
    outs = []
    for lvl, r in enumerate(spec.resolutions):
        rows = spec.offsets[lvl + 1] - spec.offsets[lvl]
        pos = x * float(r - 2) + 0.5
        pos_grid = torch.floor(pos)
        frac = pos - pos_grid
        pos_grid = pos_grid.to(torch.int64)
        cg = torch.clamp_max(pos_grid[:, None, :] + corners[None], r - 1)
        w = torch.where(corners[None] == 0, 1.0 - frac[:, None, :],
                        frac[:, None, :]).prod(-1)
        border = ((cg == 0) | (cg == r - 1)).any(-1)
        w = torch.where(border, 0.0, w)
        w = w / (w.sum(-1, keepdim=True) + 1e-9)
        if r**d <= rows:
            idx = sum(cg[..., k] * r**k for k in range(d))
        else:
            h = torch.zeros(cg.shape[:2], dtype=torch.int64)
            for k in range(d):
                h = h ^ (((cg[..., k] & th._U32) * th._PRIMES[k]) & th._U32)
            idx = h % rows
        idx = (idx % rows) + spec.offsets[lvl]
        outs.append((table[idx] * w[..., None]).sum(1))
    return torch.where(oob[:, None], 0.0, torch.cat(outs, -1))


def _grad_case(case):
    """(spec, x [N, d]) of one case; seeded."""
    rng = np.random.default_rng(len(case) * 7 + sum(map(ord, case)))
    if case == "hac_full":  # HACConfig's published spec at a small N
        return th.make_mixed_spec().xyz, _points(rng, 64, 3)
    spec = {"dense_3d": th.make_spec(3, 2, (6, 10, 16), 13),
            "hashed_3d": th.make_spec(3, 2, (18, 44, 130), 12),
            "hashed_2d": th.make_spec(2, 2, (16, 130, 514), 10),
            "plane_full": th.make_mixed_spec().plane,
            "one_cell": th.make_spec(3, 2, (6, 24, 60), 12),
            "long_run": th.make_spec(2, 2, (16, 40), 9),
            "sparse_rows": th.make_spec(3, 2, (40, 60), 16),
            "four_features": th.make_spec(3, 4, (6, 18, 44), 11)}[case]
    d = spec.num_dim
    x = _points(rng, 300, d)
    if case == "one_cell":  # every point in one cell: the heaviest duplicates
        x = np.tile(np.full((1, d), 0.37, np.float32), (300, 1))
    if case == "long_run":  # a run of 2,600 lookups in one row: past a chunk
        x = np.concatenate([x, np.full((2600, d), 0.61, np.float32)])
    if case == "sparse_rows":  # 20 points into 62,208 rows: most rows unhit
        x = x[:20]
    return spec, x


GRAD_CASES = ["dense_3d", "hashed_3d", "hashed_2d", "plane_full", "hac_full",
              "one_cell", "long_run", "sparse_rows", "four_features"]


@pytest.mark.parametrize("case", GRAD_CASES)
def test_table_grad_reference_matches_autograd(case):
    """table_grad_reference against autograd's gradient of the plain encode,
    through the sign STE as HAC runs it, within table_grad_tolerance (the
    two sum each row's terms in other orders)."""
    spec, x_np = _grad_case(case)
    gen = torch.Generator().manual_seed(len(case))
    param = (torch.rand((spec.n_rows, spec.n_features), generator=gen) * 4 - 2
             ).requires_grad_(True)
    x = torch.from_numpy(x_np)
    out = _plain_encode(spec, ste_binary(param), x)
    g = torch.randn(out.shape, generator=gen)
    want, = torch.autograd.grad(out, param, g)

    idxs, ws = zip(*th._level_lookups(spec, x))
    idx = torch.stack([i.to(torch.int32) for i in idxs], 1)
    w = torch.stack(ws, 1)
    oob = ((x < 0.0) | (x > 1.0)).any(-1)
    g_in = torch.where(oob[:, None], 0.0, g)  # the mask's backward
    got = th.table_grad_reference(idx, w, g_in, spec.n_rows)
    got = got * (param.detach().abs() <= 1.0)  # the STE's pass-through
    tol = th.table_grad_tolerance(idx, w, g_in, spec.n_rows)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert float(((got - want).abs() - tol).max()) <= 0.0
    # table_grad on CPU tensors is the plain version
    assert torch.equal(th.table_grad(idx, w, g_in, spec.n_rows) *
                       (param.detach().abs() <= 1.0), got)
    counts = torch.bincount(idx.reshape(-1).long(), minlength=spec.n_rows)
    if case in ("sparse_rows", "one_cell", "hac_full"):
        assert bool((counts == 0).any()) and bool((got[counts == 0] == 0).all())
    if case == "long_run":
        assert int(counts.max()) > th.CHUNK
    if case == "one_cell":
        assert int((counts > 0).sum()) <= 8 * len(spec.resolutions)


@pytest.mark.parametrize("grad_x", [False, True])
def test_lookup_function_on_cpu_matches_plain_encode(grad_x):
    """`_Lookup` (the route of every table that needs its gradient) on CPU
    tensors, where its backward takes the plain version: the forward bit
    for bit, the table's and x's gradients within tolerance of autograd."""
    spec = th.make_spec(3, 2, (6, 18, 60), 11)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(_points(rng, 200, 3)).requires_grad_(grad_x)
    table = torch.from_numpy(rng.uniform(-1, 1, (spec.n_rows, 2)).astype(
        np.float32)).requires_grad_(True)
    want = _plain_encode(spec, table, x)
    idxs, ws = zip(*th._level_lookups(spec, x))
    oob = ((x < 0.0) | (x > 1.0)).any(-1)
    got = torch.where(oob[:, None], 0.0, th._Lookup.apply(table, idxs, *ws))
    assert torch.equal(got, want)
    g = torch.from_numpy(rng.standard_normal(want.shape).astype(np.float32))
    leaves = [table, x] if grad_x else [table]
    want_g = torch.autograd.grad(want, leaves, g)
    got_g = torch.autograd.grad(got, leaves, g)
    idx = torch.stack([i.to(torch.int32) for i in idxs], 1)
    tol = th.table_grad_tolerance(idx, torch.stack(ws, 1).detach(),
                                  torch.where(oob[:, None], 0.0, g), spec.n_rows)
    assert float(((got_g[0] - want_g[0]).abs() - tol).max()) <= 0.0
    if grad_x:  # the weights' gradient, summed over F in another order
        torch.testing.assert_close(got_g[1], want_g[1], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("grad", [True, False])
def test_grad_calls_take_the_lookup_and_no_grad_calls_the_plain_path(
        grad, monkeypatch):
    """A grad call on CPU tables goes through `_Lookup`, one table_grad a
    table in the backward, with the table's gradient within
    table_grad_tolerance of autograd's; a no-grad call takes the plain
    forward. Both give outputs bit-identical to the plain encode and
    launch no kernel."""
    kw = dict(n_features=2, resolutions_3d=(6, 24, 60), log2_hashmap_size=12,
              resolutions_2d=(16, 130), log2_hashmap_size_2d=10)
    spec = th.make_mixed_spec(**kw)
    mod = th.MixedTables(spec).init_uniform(np.random.default_rng(2), std=1.5)
    x = torch.from_numpy(_points(np.random.default_rng(4), 150, 3))
    calls = []
    table_grad = th.table_grad
    monkeypatch.setattr(th, "table_grad",
                        lambda *a: calls.append(a[3]) or table_grad(*a))
    before = th.backward_launches
    with torch.set_grad_enabled(grad):
        got = mod(x)
        tb = {n: ste_binary(getattr(mod, n)) for n in th.TABLE_NAMES}
        want = torch.cat([_plain_encode(spec.xyz, tb["xyz"], x),
                          _plain_encode(spec.plane, tb["xy"], x[:, 0:2]),
                          _plain_encode(spec.plane, tb["xz"], x[:, 0::2]),
                          _plain_encode(spec.plane, tb["yz"], x[:, 1:3])], -1)
    assert torch.equal(got, want) and got.requires_grad == grad
    if grad:
        g = torch.randn(got.shape, generator=torch.Generator().manual_seed(1))
        params = [getattr(mod, n) for n in th.TABLE_NAMES]
        slices = [(spec.xyz, x), (spec.plane, x[:, 0:2]),
                  (spec.plane, x[:, 0::2]), (spec.plane, x[:, 1:3])]
        at = 0
        for a, b, (s, xs) in zip(torch.autograd.grad(got, params, g),
                                 torch.autograd.grad(want, params, g), slices):
            idxs, ws = zip(*th._level_lookups(s, xs))
            oob = ((xs < 0.0) | (xs > 1.0)).any(-1)
            g_t = torch.where(oob[:, None], 0.0, g[:, at:at + s.output_dim])
            at += s.output_dim
            tol = th.table_grad_tolerance(
                torch.stack([i.to(torch.int32) for i in idxs], 1),
                torch.stack(ws, 1), g_t, s.n_rows)
            assert float(((a - b).abs() - tol).max()) <= 0.0
    assert sorted(calls) == (sorted([spec.xyz.n_rows] + 3 * [spec.plane.n_rows])
                             if grad else [])
    assert th.backward_launches == before


@pytest.mark.parametrize("fault", ["dropped_chunk", "repeated_chunk"])
def test_kernel_grad_tolerance_sees_a_faulty_chunk(fault):
    """kernel_grad_tolerance is (min(n - 1, 5 + CHUNK / 32 + ceil(n /
    CHUNK)) + 2) u sum|w g| a row (plus 2^-149 a lookup), so the exact
    gradient lies inside it and one chunk of a 3-chunk row's sorted lookups
    left out, or summed twice, lies outside it."""
    gen = torch.Generator().manual_seed(len(fault))
    rows, corners, long_n = 300, 8, 3 * th.CHUNK + 40
    keys = torch.cat([torch.full((long_n,), 7),
                      torch.randint(0, rows, (8 * 500,), generator=gen)])
    m = keys.numel() - keys.numel() % corners
    keys = keys[torch.randperm(keys.numel(), generator=gen)][:m]
    idx = keys.reshape(-1, 1, corners).to(torch.int32)
    w = torch.rand(idx.shape, generator=gen)
    g = torch.randn((idx.shape[0], 2), generator=gen)
    exact = th.table_grad_reference(idx, w.double(), g.double(), rows)
    tol = th.kernel_grad_tolerance(idx, w, g, rows)
    counts = torch.bincount(idx.reshape(-1).long(), minlength=rows).double()
    mags = th.table_grad_reference(idx, w.double().abs(), g.double().abs(), rows)
    depth = torch.minimum(counts - 1, 5 + th.CHUNK // 32 + torch.ceil(
        counts / th.CHUNK)).clamp_min(0)
    assert torch.allclose(tol, (depth + 2)[:, None] * th.F32_ULP * mags
                          + counts[:, None] * 2.0**-149, rtol=1e-12, atol=0)
    assert float(depth[7]) == 5 + th.CHUNK // 32 + 4  # 4 chunks, not n - 1
    assert bool(((th.table_grad_reference(idx, w, g, rows).double() - exact
                  ).abs()[counts <= 1] == 0).all())
    _, order = torch.sort(idx.reshape(-1), stable=True)
    start = int((idx.reshape(-1) < 7).sum())
    faulty = w.reshape(-1).clone()
    chunk = order[start + th.CHUNK:start + 2 * th.CHUNK]
    faulty[chunk] = 0.0 if fault == "dropped_chunk" else 2 * faulty[chunk]
    wrong = th.table_grad_reference(idx, faulty.view(w.shape).double(),
                                    g.double(), rows)
    assert float(((wrong[7] - exact[7]).abs() - tol[7]).max()) > 0.0
    assert float(((wrong - exact).abs() - tol)[torch.arange(rows) != 7].max()
                 ) <= 0.0


def test_table_grad_refuses_what_the_kernel_does_not_take():
    idx = torch.zeros((4, 2, 8), dtype=torch.int32)
    w = torch.ones((4, 2, 8))
    with pytest.raises(ValueError, match="idx"):
        th._check_grad_inputs(idx.long(), w, torch.ones((4, 4)), 10)
    with pytest.raises(ValueError, match="grad_out"):
        th._check_grad_inputs(idx, w, torch.ones((4, 5)), 10)
    with pytest.raises(ValueError, match="floats"):
        th._check_grad_inputs(idx, w, torch.ones((4, 6)), 10)
    assert th._check_grad_inputs(idx, w, torch.ones((4, 4)), 10) == 2
