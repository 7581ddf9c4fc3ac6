"""The port's GausPcgc codec (gauspcc_tpu_torch/codecs/gauspcgc) against
the JAX package's sib engine (gauspcc_tpu/codecs/gauspcgc), on the same
seeded numpy clouds and the same weights, on the CPU.

Tolerances, each with its reason:
- geometry (pyramid, children, cell maps, sibling packing): exact, it is
  integer work;
- one sib conv in float32: atol 1e-5 (the same products summed in
  another order by another GEMM);
- the context features and the four stages' probabilities in float32,
  through weights carried by `convert`: atol 2e-5 (a stack of 5 convs,
  then 2 more and the head);
- CDF tables from the same probabilities: at most 1 count of 2^16 (the
  cumulative sum rounds in another order, which can move a value across a
  rounding boundary);
- bpp at full width with the r5 weights in float32: within 0.01 of the
  JAX package's, from those tables;
- the port's own round trips: lossless.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gauspcc_tpu.codecs.gauspcgc import codec as jcodec, model as jmodel
from gauspcc_tpu.core import cdf as jcdf
from gauspcc_tpu.ops import hostmap as jhostmap, sibconv as jsibconv, sparse as jsparse
from gauspcc_tpu_torch import convert
from gauspcc_tpu_torch.codecs.gauspcgc import codec, model
from gauspcc_tpu_torch.core import cdf
from gauspcc_tpu_torch.ops import hostmap, sibconv, sparse

from test_torch_native_libs import ensure_jax_native_libs

R5 = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                  "model", "gauspcgc_r5", "best_model.npz")
SMALL = model.NetConfig(channels=16, kernel_size=3)  # tests/test_gauspcgc.py:11
J_SMALL = jmodel.NetConfig(channels=16, kernel_size=3)
FULL_F32 = model.NetConfig(dtype="f32")
J_FULL_F32 = jmodel.NetConfig(dtype="f32")
CONV_ATOL = 1e-5
NET_ATOL = 2e-5
BPP_ATOL = 0.01


ensure_jax_native_libs()  # before any test here loads one


def _cloud(rng, n, extent=64, offset=(0, 0, 0)):
    """tests/test_gauspcgc.py:18."""
    pts = rng.integers(0, extent, size=(n * 2, 3)) + np.asarray(offset)
    pts = np.unique(pts, axis=0)
    return pts[:n].astype(np.int32)


def _clustered(seed, n=3000, n_centers=20, extent=400, sigma=8.0):
    """A small cloud shaped like bench.py's `_bench_cloud`."""
    rng = np.random.default_rng(seed)
    centers = rng.integers(0, extent, size=(n_centers, 3))
    pts = centers[rng.integers(0, n_centers, n)] + rng.normal(0, sigma, (n, 3))
    return np.unique(np.round(pts), axis=0).astype(np.int64)


def _levels(xyz):
    """The pyramid as compress_point_cloud builds it: shift, dedupe, build."""
    xyz = np.asarray(xyz, np.int64)
    xyz0 = jsparse.dedupe_lex_np(xyz - xyz.min(axis=0))
    return jsparse.build_occupancy_pyramid(xyz0, min_points=64, sorted_unique=True)


def _sorted_rows(a):
    return np.asarray(sorted(map(tuple, np.asarray(a).astype(np.int64).tolist())))


@pytest.fixture(scope="module")
def r5_flat():
    with np.load(R5) as data:
        return {k: data[k] for k in data.files}


@pytest.fixture(scope="module")
def small_params():
    jparams = jmodel.init_params(jax.random.PRNGKey(0), J_SMALL)
    return jparams, convert.codec_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), SMALL, "cpu")


# ---------------------------------------------------------------------------
# geometry: exact
# ---------------------------------------------------------------------------

def test_pyramid_and_dedupe_equal_jax():
    rng = np.random.default_rng(0)
    xyz = rng.integers(-300, 300, (4000, 3))  # negative coords, duplicates
    shifted = xyz - xyz.min(axis=0)
    np.testing.assert_array_equal(sparse.dedupe_lex(shifted),
                                  jsparse.dedupe_lex_np(shifted))
    np.testing.assert_array_equal(sparse.lex_key(shifted, (600, 600)),
                                  jsparse.lex_key_np(shifted, (600, 600)))
    got = sparse.build_occupancy_pyramid(shifted)
    want = jsparse.build_occupancy_pyramid(shifted)
    assert len(got) == len(want) > 3
    for (gc, go), (wc, wo) in zip(got, want):
        assert gc.dtype == wc.dtype and go.dtype == wo.dtype
        np.testing.assert_array_equal(gc, wc)
        np.testing.assert_array_equal(go, wo)


def test_expand_children_equal_jax():
    """Coords, octant, parent_idx and count, padding included, on every
    level of a shifted cloud with negative offsets."""
    levels = _levels(_cloud(np.random.default_rng(1), 800, 96, (-50, -7, -300)))
    for pc, po in levels:
        n = int(np.unpackbits(po[:, None], axis=1).sum())
        ccap = n + 37
        want = jhostmap.expand_children(pc, po, ccap)
        got = hostmap.expand_children(torch.from_numpy(pc), torch.from_numpy(po), ccap)
        assert got[3] == want[3] == n
        for g, w in zip(got[:3], want[:3]):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), w)
    with pytest.raises(ValueError, match="overflow"):
        hostmap.expand_children(torch.from_numpy(pc), torch.from_numpy(po), n - 1)


@pytest.mark.parametrize("kernel_size", [3, 5])
def test_build_map_equal_jax(kernel_size):
    coords = jsparse.dedupe_lex_np(
        np.random.default_rng(2).integers(0, 30, (1500, 3))).astype(np.int32)
    n = coords.shape[0]
    padded = np.zeros((n + 100, 3), np.int32)
    padded[:n] = coords
    want = jhostmap.build_map(padded, n, kernel_size, ncap=n + 100)
    got = hostmap.build_map(torch.from_numpy(padded), n, kernel_size, ncap=n + 100)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_tap_table_sib_pos_and_dedupe_equal_jax():
    for k in (3, 5):
        np.testing.assert_array_equal(sibconv.tap_table(k), jsibconv.tap_table(k))
    coords = jsparse.dedupe_lex_np(
        np.random.default_rng(3).integers(0, 50, (2000, 3))).astype(np.int32)
    groups = jsparse.dedupe_lex_np(coords.astype(np.int64) >> 1)
    got_groups = hostmap.dedupe(torch.from_numpy(coords).to(torch.int64) >> 1)
    np.testing.assert_array_equal(got_groups.numpy(), groups)
    np.testing.assert_array_equal(
        sibconv.sib_pos(torch.from_numpy(coords), got_groups).numpy(),
        jsibconv.sib_pos_np(coords, groups))


def test_level_geometry_equals_jax():
    """Every array of _SibLevelGeometry, on each level of a shifted cloud."""
    levels = _levels(_cloud(np.random.default_rng(4), 1500, 128))
    for depth in range(len(levels) - 1):
        pc, po = levels[depth]
        n_child = levels[depth + 1][0].shape[0]
        want = jcodec._SibLevelGeometry(pc, po, n_child)
        got = codec._SibLevelGeometry(torch.from_numpy(pc),
                                      torch.from_numpy(po.astype(np.int64)), n_child)
        assert got.ccap == want.ccap
        np.testing.assert_array_equal(got.child_coords.numpy(), want.child_coords)
        for name in ("cpos", "inv", "pocc", "pmask", "ppos", "cmask8",
                     "p_gmapT", "c_gmapT"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(want, name)), name)


# ---------------------------------------------------------------------------
# conv and network, float32
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel_size", [3, 5])
@pytest.mark.parametrize("masked", [False, True])
def test_sibconv_equal_jax(kernel_size, masked):
    rng = np.random.default_rng(kernel_size + 10 * masked)
    coords = jsparse.dedupe_lex_np(rng.integers(0, 40, (900, 3))).astype(np.int32)
    groups = jsparse.dedupe_lex_np(coords.astype(np.int64) >> 1).astype(np.int32)
    pos = jsibconv.sib_pos_np(coords, groups)
    gmapT = np.ascontiguousarray(jhostmap.build_map(groups, groups.shape[0], 3).T)
    slotmask = np.zeros(groups.shape[0] * 8, bool)
    slotmask[pos] = True
    cin, cout = 16, 24
    x = np.zeros((groups.shape[0] * 8, cin), np.float32)
    x[pos] = rng.standard_normal((coords.shape[0], cin))
    w = rng.standard_normal((kernel_size**3, cin, cout)).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    mask = slotmask if masked else None
    want = jsibconv.sibconv_apply(jnp.asarray(x), jnp.asarray(gmapT),
                                  jnp.asarray(gmapT[:, ::-1]), jnp.asarray(w),
                                  jnp.asarray(b),
                                  slotmask=None if mask is None else jnp.asarray(mask))
    got = sibconv.sibconv_apply(torch.from_numpy(x), torch.from_numpy(gmapT),
                                torch.from_numpy(w), torch.from_numpy(b),
                                slotmask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=CONV_ATOL)


def _geometry_pair(levels, depth):
    pc, po = levels[depth]
    n_child = levels[depth + 1][0].shape[0]
    jg = jcodec._SibLevelGeometry(pc, po, n_child)
    tg = codec._SibLevelGeometry(torch.from_numpy(pc),
                                 torch.from_numpy(po.astype(np.int64)), n_child)
    return jg, tg


def test_context_and_stage_probs_equal_jax(r5_flat):
    """sib_context and all four sib_stage_probs at full width through the
    r5 weights carried by `convert`, float32, on the finest level of a
    clustered cloud, with teacher-forced earlier bits."""
    jparams = jax.tree_util.tree_map(jnp.asarray, _nest(r5_flat))
    net = convert.codec_params_from_numpy(r5_flat, FULL_F32, "cpu")
    levels = _levels(_clustered(5, n=800))
    depth = len(levels) - 2
    jg, tg = _geometry_pair(levels, depth)
    want_cf = jmodel.sib_context(jparams, J_FULL_F32, jg.pocc, jg.pmask, jg.p_gmapT,
                                 jg.p_gmapfT, jg.ppos, jg.c_gmapT, jg.c_gmapfT,
                                 jg.cmask8)
    with torch.no_grad():
        got_cf = codec._context_sib(net, FULL_F32, tg)
    np.testing.assert_allclose(got_cf.numpy(), np.asarray(want_cf), rtol=0,
                               atol=NET_ATOL)
    gt = np.zeros(tg.cmask8.shape[0], np.int32)
    gt[tg.cpos[: tg.n_child].numpy()] = levels[depth + 1][1]
    s = model.split_occupancy(torch.from_numpy(gt))
    assert torch.equal(model.merge_occupancy(*s), torch.from_numpy(gt))
    prevs = [torch.zeros_like(s[0]), s[0], s[0] * 2 + s[1], (s[0] * 2 + s[1]) * 4 + s[2]]
    for stage in range(4):
        want = jmodel.sib_stage_probs(jparams, stage, want_cf, jg.c_gmapT,
                                      jg.c_gmapfT, jg.cmask8,
                                      jnp.asarray(prevs[stage].numpy()))
        with torch.no_grad():
            got = model.sib_stage_probs(net, stage, got_cf, tg.c_gmapT, tg.cmask8,
                                        prevs[stage])
        assert got.shape == (tg.cmask8.shape[0], model.STAGE_SIZES[stage])
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=NET_ATOL)


def test_tables_from_jax_probabilities_within_one_count():
    rng = np.random.default_rng(6)
    for n_sym in model.STAGE_SIZES:
        probs = rng.dirichlet(np.full(n_sym, 0.5), size=20000).astype(np.float32)
        want = np.asarray(jcdf.probs_to_cdf_int16(jnp.asarray(probs))).astype(np.int64)
        got = cdf.probs_to_cdf_int16(torch.from_numpy(probs))
        assert got.dtype == torch.int32 and got.shape == want.shape
        diff = np.abs(got.numpy().astype(np.int64) - want)
        diff = np.minimum(diff, 65536 - diff)  # the last column wraps
        print(f"{n_sym} symbols: {int((diff > 0).sum())} of {diff.size} "
              f"entries differ, largest {int(diff.max())}")
        assert diff.max() <= 1
        assert not got[:, -1].any()  # 2^16 wraps to 0


# ---------------------------------------------------------------------------
# compress and decompress
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["plain", "negative", "posq2"])
def test_roundtrip_lossless(tmp_path, small_params, case):
    """The three clouds of tests/test_gauspcgc.py:25-55 at NetConfig(16, 3)
    (bf16 conv stacks), the JAX package's seeded weights carried over."""
    _, net = small_params
    posq = 1.0
    if case == "plain":
        xyz = _cloud(np.random.default_rng(0), 1500, extent=128)
    elif case == "negative":
        xyz = _cloud(np.random.default_rng(1), 800, extent=96, offset=(-50, -7, -300))
    else:
        xyz, posq = _cloud(np.random.default_rng(2), 500, extent=64) * 2, 2.0
    path = str(tmp_path / "pc.bin")
    out = codec.compress_point_cloud(xyz, net, path, posQ=posq, config=SMALL,
                                     device="cpu")
    assert out["num_points"] == xyz.shape[0] and out["output_path"] == path
    assert out["file_size_bits"] == 8 * open(path, "rb").seek(0, 2)
    assert 1.0 < out["bpp"] < 50.0
    dec = codec.decompress_point_cloud(path, net, config=SMALL, device="cpu")
    assert dec["num_points"] == xyz.shape[0]
    assert dec["point_cloud"].dtype == np.float32
    np.testing.assert_array_equal(_sorted_rows(dec["point_cloud"]), _sorted_rows(xyz))


def test_full_width_r5_bpp_matches_jax(tmp_path, r5_flat):
    """C 32, k 5, the r5 weights, float32: the port's bpp within 0.01 of
    the JAX sib engine's on a clustered cloud, and a lossless decode."""
    xyz = _clustered(0)
    jparams = jax.tree_util.tree_map(jnp.asarray, _nest(r5_flat))
    want = jcodec.compress_point_cloud(xyz, jparams, str(tmp_path / "jax.bin"),
                                       config=J_FULL_F32, geom="sib")
    net = convert.codec_params_from_numpy(r5_flat, FULL_F32, "cpu")
    path = str(tmp_path / "port.bin")
    got = codec.compress_point_cloud(xyz, net, path, config=FULL_F32, device="cpu")
    print(f"{xyz.shape[0]} points: port {got['bpp']:.5f} bpp, JAX {want['bpp']:.5f}")
    assert abs(got["bpp"] - want["bpp"]) <= BPP_ATOL
    dec = codec.decompress_point_cloud(path, net, config=FULL_F32, device="cpu")
    np.testing.assert_array_equal(_sorted_rows(dec["point_cloud"]), _sorted_rows(xyz))


def test_level_bits_tracks_actual_rate(tmp_path, small_params):
    """The teacher-forced estimate against the coded size, with the bounds
    of tests/test_gauspcgc.py:68."""
    _, net = small_params
    xyz = _cloud(np.random.default_rng(4), 2000, extent=128)
    levels = _levels(xyz)
    est = 0.0
    with torch.no_grad():
        for depth in range(len(levels) - 1):
            pc, po = levels[depth]
            g = codec._SibLevelGeometry(torch.from_numpy(pc),
                                        torch.from_numpy(po.astype(np.int64)),
                                        levels[depth + 1][0].shape[0])
            gt = torch.zeros(g.cmask8.shape[0], dtype=torch.int32)
            gt[g.cpos[: g.n_child]] = torch.from_numpy(levels[depth + 1][1].astype(np.int32))
            bits, n = model.level_bits_sib(net, SMALL, g.pocc, g.pmask, g.p_gmapT,
                                           g.ppos, g.c_gmapT, g.cmask8, gt)
            assert int(n) == g.n_child
            est += float(bits)
    out = codec.compress_point_cloud(xyz, net, str(tmp_path / "pc.bin"),
                                     config=SMALL, device="cpu")
    assert out["file_size_bits"] >= est * 0.98
    assert out["file_size_bits"] <= est * 1.1 + 5000


def test_decoder_refuses_a_jax_stream(tmp_path, small_params):
    jparams, net = small_params
    path = str(tmp_path / "jax.bin")
    jcodec.compress_point_cloud(_cloud(np.random.default_rng(0), 300), jparams,
                                path, config=J_SMALL, geom="sib")
    with pytest.raises(ValueError, match="version 4 .*reads only version 5"):
        codec.decompress_point_cloud(path, net, config=SMALL, device="cpu")


def test_unported_engines_batch_coding_and_oversized_clouds_raise(tmp_path, small_params):
    """What the codec refuses: an unknown engine; a cloud, or a merged batch
    of clouds, spanning more than the geometry's keys hold; and a stream of
    any version but the port's 5, 6 and 7 (the JAX package's 2, 3 and 4
    too), single or batch."""
    _, net = small_params
    xyz = _cloud(np.random.default_rng(0), 100)
    with pytest.raises(ValueError, match="the engines are"):
        codec.compress_point_cloud(xyz, net, str(tmp_path / "a.bin"),
                                   config=SMALL, geom="window", device="cpu")
    with pytest.raises(ValueError, match="spans"):
        codec.compress_point_cloud(np.array([[0, 0, 0], [1 << 20, 5, 5]]), net,
                                   str(tmp_path / "c.bin"), config=SMALL,
                                   device="cpu")
    wide = [np.array([[0, 0, 0], [1 << 17, 1, 1]])] * 8  # 8 << 18 > 2^20
    with pytest.raises(ValueError, match="merged batch of 8 clouds spans"):
        codec.compress_point_cloud_batch(wide, net, str(tmp_path / "w.binb"),
                                         config=SMALL, device="cpu")
    for fn, comp, name in ((codec.decompress_point_cloud,
                            codec.compress_point_cloud, "s.bin"),
                           (codec.decompress_point_cloud_batch,
                            codec.compress_point_cloud_batch, "b.binb")):
        path = str(tmp_path / name)
        comp(xyz if name == "s.bin" else [xyz, xyz], net, path, config=SMALL,
             geom="host", device="cpu")
        raw = bytearray(open(path, "rb").read())
        assert raw[4] == 6
        for version in (2, 3, 4, 0, 8, 255):
            raw[4] = version
            open(path, "wb").write(bytes(raw))
            with pytest.raises(ValueError, match=f"version {version} .*reads "
                               "only version 5 .*, 6 .* and 7"):
                fn(path, net, config=SMALL, device="cpu")


def test_codec_entry_points_default_to_cuda_and_raise_without_it(
        monkeypatch, tmp_path, small_params, r5_flat):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, net = small_params
    xyz = _cloud(np.random.default_rng(0), 100)
    calls = [
        lambda: codec.compress_point_cloud(xyz, net, str(tmp_path / "a.bin"),
                                           config=SMALL),
        lambda: codec.decompress_point_cloud(str(tmp_path / "a.bin"), net,
                                             config=SMALL),
        lambda: convert.codec_params_from_numpy(r5_flat),
        lambda: convert.load_codec_npz(R5),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_codec_params_carry_every_weight(r5_flat):
    """All 57 r5 arrays land in the network (dense weights transposed);
    a missing or an unknown key raises."""
    assert len(r5_flat) == 57
    net = convert.codec_params_from_numpy(_nest(r5_flat), model.NetConfig(), "cpu")
    params = dict(net.named_parameters())
    assert len(params) == 57
    np.testing.assert_array_equal(net.head_s3.fc1.weight.detach().numpy(),
                                  r5_flat["head_s3/fc1/w"].T)
    np.testing.assert_array_equal(net.target_resnet.res1.conv0.w.detach().numpy(),
                                  r5_flat["target_resnet/res1/conv0/w"])
    np.testing.assert_array_equal(net.cond_emb_s2.detach().numpy(),
                                  r5_flat["cond_emb_s2"])
    missing = dict(r5_flat)
    del missing["spatial_s1/conv0/b"]
    with pytest.raises(KeyError, match="spatial_s1/conv0/b"):
        convert.codec_params_from_numpy(missing, device="cpu")
    with pytest.raises(KeyError, match="extra"):
        convert.codec_params_from_numpy(dict(r5_flat, extra=np.zeros(1)),
                                        device="cpu")


def _nest(flat):
    """Flat "a/b/c" keys -> nested dicts, the JAX package's params tree."""
    tree = {}
    for key, v in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree
