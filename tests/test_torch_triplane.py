"""The triplane sample's lookup route (gauspcc_tpu_torch/fields/triplane.py
`sample_triplanes`, which CAT-3DGS's `field.sample` reads its scales
through) against the plain sample with autograd's gradient, on the CPU.

Under grad, at one of K3's widths, every plane's taps are read from the
planes' stacked pixel rows in one autograd function, and the planes'
gradient is `hashgrid.table_grad` (here its plain version, the sorted
segmented sum). Tolerances, each with its reason:
- the values: exactly (the route's forward is the plain sample's, op for
  op);
- the planes' gradient: `table_grad_tolerance` (each pixel's terms summed
  in another order) plus 4 u of sum |w g| for the terms' own rounding
  (autograd's g (1 - wy) (1 - wx) against g [(1 - wx)(1 - wy)]);
- the coordinates' and the frame's gradients: rtol 1e-5 and atol 1e-5 of
  the leaf's largest |gradient| (each a sum over the taps' weight
  gradients, in another order);
- every call the route does not take: the plain sample's outputs, bit for bit.
"""

import numpy as np
import pytest
import torch

from gauspcc_tpu_torch.fields import hashgrid as th
from gauspcc_tpu_torch.fields import triplane as tri
from gauspcc_tpu_torch.models.cat3dgs import field as cfield

RESOLUTIONS = (8, 16, 32)
LONG_RUN = 2600  # copies of one point: every tap's pixel past a K3 chunk


def _points(seed: int, n: int = 600) -> torch.Tensor:
    """[n + 2 * 40 + 10 + LONG_RUN, 3]: points inside and outside [-1, 1],
    on the pixel edges and centres of the coarsest plane, on the planes'
    borders, and one point repeated LONG_RUN times (the bucket's padding
    rows, which all sit at one anchor)."""
    rng = np.random.default_rng(seed)
    r = RESOLUTIONS[0]
    edges = (2 * rng.integers(0, r + 1, (40, 3)) / r - 1)
    centres = ((2 * rng.integers(0, r, (40, 3)) + 1) / r - 1)
    border = np.array([[-1, -1, -1], [1, 1, 1], [-1, 1, 0.3], [1, -1, -0.2],
                       [1 - 1 / r, 0, -1], [-1 + 1 / r, 1, 0], [0, 0, 0],
                       [5, 5, 5], [-5, 5, -5], [0.2, -1.2, 1.05]])
    x = np.concatenate([rng.uniform(-1.3, 1.3, (n, 3)), edges, centres, border,
                        np.tile(rng.uniform(-0.9, 0.9, (1, 3)), (LONG_RUN, 1))])
    return torch.from_numpy(x.astype(np.float32))


def _plain(planes: list, x: torch.Tensor) -> torch.Tensor:
    """The plain sample of every triplane, as CAT read its scales before
    the lookup route."""
    return torch.cat([tri.sample_triplane(p, x, apply_contract=False)
                      for p in planes], -1)


def _lookup_inputs(planes: list, x: torch.Tensor):
    """(idx [N, L, 4] int32, w [N, L, 4], rows) of the route's taps."""
    idx, inside, wx, wy = tri.triplane_taps(planes, x.detach())
    rows = sum(3 * p.shape[2] * p.shape[3] for p in planes)
    return idx.to(torch.int32), tri.tap_weights(inside, wx, wy), rows


def _planes_grad_tolerance(planes, x, g):
    """Per-pixel atol of the planes' gradient, as `triplane_rows` lays
    them out (see the module's docstring)."""
    idx, w, rows = _lookup_inputs(planes, x)
    mags = th.table_grad_reference(idx, w.double().abs(), g.double().abs(),
                                   rows)
    return (th.table_grad_tolerance(idx, w, g, rows)
            + (4 * th.F32_ULP * mags).to(torch.float32))


def _assert_leaf_close(got, want):
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("channels", [1, 2])
def test_lookup_route_matches_the_plain_sample(channels):
    """Values, the planes' gradient and the coordinates' gradient of the
    route against the plain sample's, at points inside, outside and on the
    planes' edges and one long run of a point."""
    gen = torch.Generator().manual_seed(channels)
    planes = [torch.randn((3, channels, r, r), generator=gen).requires_grad_()
              for r in RESOLUTIONS]
    x = _points(channels).requires_grad_()
    got = tri.sample_triplanes(planes, x)
    want = _plain(planes, x)
    assert got.shape == want.shape == (x.shape[0], 9 * channels)
    assert torch.equal(got, want)
    # far outside every plane reads zeros on both routes
    assert not got[-LONG_RUN - 3:-LONG_RUN - 1].detach().any()

    g = torch.randn(want.shape, generator=gen)
    got_g = torch.autograd.grad(got, planes + [x], g)
    want_g = torch.autograd.grad(want, planes + [x], g)
    tol = _planes_grad_tolerance(planes, x, g)
    diff = tri.triplane_rows(got_g[:-1]) - tri.triplane_rows(want_g[:-1])
    assert float((diff.abs() - tol).max()) <= 0.0
    _assert_leaf_close(got_g[-1], want_g[-1])
    # the long run lands past a chunk on some pixel of every plane
    idx, _, rows = _lookup_inputs(planes, x)
    counts = torch.bincount(idx.reshape(-1).long(), minlength=rows)
    assert int(counts.max()) > th.CHUNK


def _field(channels: int, seed: int) -> tuple[cfield.Field, cfield.FieldConfig]:
    cfg = cfield.FieldConfig(n_feat=channels, base_resolution=RESOLUTIONS[0])
    field = cfield.Field(cfg).init_seeded(np.random.default_rng(seed))
    with torch.no_grad():  # a frame other than the identity
        field.rotation.copy_(torch.linalg.qr(torch.randn(
            (3, 3), generator=torch.Generator().manual_seed(seed)))[0])
        field.pca_mean.copy_(torch.tensor([0.1, -0.2, 0.05]))
        field.pca_std.copy_(torch.tensor([0.6, 0.4, 0.3]))
    return field, cfg


@pytest.mark.parametrize("case", ["grad_one_channel", "grad_two_channels",
                                  "no_grad", "sixteen_channels"])
def test_cat_sample_takes_one_table_grad_or_the_plain_path(case, monkeypatch):
    """CAT's training sample (grad, planes of 1 or 2 channels) calls
    table_grad once over the three scales' rows, launches nothing on the
    CPU, and its every leaf's gradient lies within tolerance of the plain
    sample's; a no-grad call and planes of 16 channels (TC-GS's width, no
    K3 kernel) take the plain path: its outputs bit for bit, no
    table_grad."""
    channels = {"grad_two_channels": 2, "sixteen_channels": 16}.get(case, 1)
    field, cfg = _field(channels, seed=channels)
    x = _points(3) * 1.5
    calls = []
    table_grad = th.table_grad
    monkeypatch.setattr(th, "table_grad",
                        lambda *a: calls.append(a[3]) or table_grad(*a))
    before = th.backward_launches
    planes_q = cfield.quantized_planes(field)
    with torch.set_grad_enabled(case != "no_grad"):
        got = cfield.sample(field, cfg, x, planes_q)
        z = cfield.normalize(field, cfg, x)
        planes = [p / cfield.gain(field, i) for i, p in enumerate(planes_q)]
        want = _plain(planes, z)
    assert got.shape == (x.shape[0], 9 * channels)
    if case == "no_grad":
        assert torch.equal(got, want) and not got.requires_grad
        assert calls == []
        return
    leaves = list(field.scales) + [field.gains, field.rotation, field.pca_mean,
                                   field.pca_std]
    g = torch.randn(want.shape, generator=torch.Generator().manual_seed(7))
    got_g = torch.autograd.grad(got, leaves, g, retain_graph=True)
    assert calls == ([] if case == "sixteen_channels"
                     else [3 * sum(r * r for r in cfg.resolutions())])
    assert th.backward_launches == before
    want_g = torch.autograd.grad(want, leaves, g)
    # both routes' forward is the plain one; autograd's index_put_ may sum
    # a pixel's terms in another order from call to call, so the plain
    # route's gradients too are held to the tolerances below
    assert torch.equal(got, want)
    # gains 2^0, 2^1, 2^2 divide and multiply exactly, so each scale's
    # gradient is its dequantised planes' as the two routes sum it
    assert [float(cfield.gain(field, i).detach()) for i in range(3)] == [
        1.0, 2.0, 4.0]
    tol = _planes_grad_tolerance(planes, z, g)
    diff = tri.triplane_rows([a - b for a, b in zip(got_g[:3], want_g[:3])])
    assert float((diff.abs() - tol).max()) <= 0.0
    for a, b in zip(got_g[3:], want_g[3:]):
        _assert_leaf_close(a, b)
