"""The port's general-conv codec engines (gauspcc_tpu_torch/codecs/gauspcgc:
version 6, host-built geometry; version 7, device-built geometry), the
merged-pyramid batch entry points, the general conv's network functions and the
legacy training levels, against the JAX package's (gauspcc_tpu/codecs/
gauspcgc: v2, v3, the batch entry points, model.py, train.py), on the same
seeded numpy clouds and the same weights, on the CPU.

Tolerances, each with its reason:
- geometry (`_LevelGeometry`, `sparse.sorted_children`, the header's counts):
  exact, it is integer work;
- `level_context_packed` and the four `stage_probs` in float32: atol 2e-5
  (a stack of 5 convs, then 2 more and the head, summed in another order);
- `level_bits` and `level_bits_packed` in float32: rtol 1e-5; every
  gradient of `level_bits_packed` within 1e-5 of the leaf's largest
  magnitude (18 convs and 4 heads, each gradient summed in another order);
- bpp of engines 6 and 7 in float32: within 0.01 of the JAX v2 / v3
  engine's on the same cloud and weights (CDF tables from probabilities
  within 2e-5 may differ by a count);
- round trips, single and batch, in every engine: lossless; a batch
  stream below 1.1x the bits of its clouds' single streams
  (tests/test_gauspcgc.py:117);
- a legacy train step against one through the sib levels, float32: the
  step's bpp and every weight after it within rtol 1e-4 of the leaf's
  largest magnitude (two convs over one net; the sib engine's is held to
  JAX's in tests/test_torch_codec_train.py).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gauspcc_tpu.codecs.gauspcgc import codec as jcodec, model as jmodel
from gauspcc_tpu.codecs.gauspcgc import train as jtrain
from gauspcc_tpu.ops import sparse as jsparse
from gauspcc_tpu_torch import convert
from gauspcc_tpu_torch.codecs.gauspcgc import codec, model, train
from gauspcc_tpu_torch.ops import sparse

from test_torch_native_libs import ensure_jax_native_libs

ensure_jax_native_libs()  # before any test here loads one

SMALL = model.NetConfig(channels=16, kernel_size=3)
NET_ATOL = 2e-5
BITS_RTOL = 1e-5
GRAD_REL = 1e-5
BPP_ATOL = 0.01
BATCH_RATIO = 1.1
STEP_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op torch thread for the module (the lane runs 6 workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(cfg: model.NetConfig, seed=0):
    """JAX params at cfg and the port's net with the same weights."""
    jcfg = jmodel.NetConfig(*cfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, jparams, convert.codec_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), cfg, "cpu")


@pytest.fixture(scope="module")
def small_bf16():
    return _pair(SMALL)


@pytest.fixture(scope="module")
def small_f32():
    return _pair(SMALL._replace(dtype="f32"))


def _cloud(rng, n, extent=64, offset=(0, 0, 0)):
    """tests/test_gauspcgc.py:18."""
    pts = rng.integers(0, extent, size=(n * 2, 3)) + np.asarray(offset)
    return np.unique(pts, axis=0)[:n].astype(np.int32)


def _levels(xyz):
    xyz = np.asarray(xyz, np.int64)
    xyz0 = jsparse.dedupe_lex_np(xyz - xyz.min(axis=0))
    return jsparse.build_occupancy_pyramid(xyz0, min_points=64, sorted_unique=True)


def _rows(a):
    return np.unique(np.asarray(a).astype(np.int64), axis=0)


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


# ---------------------------------------------------------------------------
# geometry: exact
# ---------------------------------------------------------------------------

def test_level_geometry_and_device_children_equal_jax():
    """Every array of engine 6's `_LevelGeometry` (the packed maps too,
    with the map reuse of `_level_geometries`), and engine 7's children
    (`sparse.sorted_children`), equal to JAX's (`_device_children`) on
    each level of a shifted cloud; the device-built children are the host
    geometry's, in its order (tests/test_gauspcgc.py:150)."""
    levels = _levels(_cloud(np.random.default_rng(8), 1500, 128, (-9, 3, -17)))
    want_geos = jcodec._level_geometries(levels, 3)
    got_geos = list(codec._level_geometries(levels, 3, torch.device("cpu")))
    assert len(got_geos) == len(want_geos) == len(levels) - 1
    for depth, (got, want) in enumerate(zip(got_geos, want_geos)):
        assert (got.ccap, got.n_child) == (want.ccap, want.n_child)
        np.testing.assert_array_equal(got.child_coords, want.child_coords)
        for name in ("po", "pm", "octant", "parent_idx", "child_mask"):
            np.testing.assert_array_equal(_np(getattr(got, name)),
                                          np.asarray(getattr(want, name)), name)
        for side in ("p_map", "c_map"):
            g, w = getattr(got, side), getattr(want, side)
            np.testing.assert_array_equal(g.lo.numpy(), np.asarray(w.lo))
            np.testing.assert_array_equal(g.codes.numpy(),
                                          np.asarray(w.codes).astype(np.int32))
        if depth and got.p_map is got_geos[depth - 1].c_map:
            assert want.p_map is want_geos[depth - 1].c_map
        pc, po = levels[depth]
        n_child = levels[depth + 1][0].shape[0]
        jp = jcodec._pad_parents(pc, po)
        tp = codec._pad_parents(pc, po, torch.device("cpu"))
        ccap = min(codec._bucket(n_child), tp[0].shape[0] * 8)
        want_c = jcodec._device_children(*jp, ccap)
        got_c = sparse.sorted_children(*tp, ccap)
        for g, w in zip(got_c, want_c):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(got_c[0][:n_child].numpy(), levels[depth + 1][0])
        assert got_c[1][:n_child].all() and not got_c[1][n_child:].any()


# ---------------------------------------------------------------------------
# the general conv's network, float32
# ---------------------------------------------------------------------------

def test_context_stage_probs_and_level_bits_equal_jax(small_f32):
    """`level_context_packed` and the four `stage_probs` (teacher-forced)
    on engine 6's geometry of the finest level, and the device-built
    `level_bits`, against JAX's."""
    jcfg, jparams, net = small_f32
    cfg = SMALL._replace(dtype="f32")
    levels = _levels(_cloud(np.random.default_rng(5), 1200, 96))
    depth = len(levels) - 2
    jg = jcodec._level_geometries(levels, 3)[depth]
    tg = list(codec._level_geometries(levels, 3, torch.device("cpu")))[depth]
    want = jmodel.level_context_packed(jparams, jcfg, jg.po, jg.pm, jg.p_map,
                                       jg.octant, jg.parent_idx, jg.child_mask,
                                       jg.c_map)
    with torch.no_grad():
        got = model.level_context_packed(net, cfg, tg.po, tg.pm, tg.p_map,
                                         tg.octant, tg.parent_idx,
                                         tg.child_mask, tg.c_map)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=NET_ATOL)
    gt = np.zeros(tg.ccap, np.int32)
    gt[: tg.n_child] = levels[depth + 1][1]
    s = model.split_occupancy(torch.from_numpy(gt))
    prevs = [torch.zeros_like(s[0]), s[0], s[0] * 2 + s[1], (s[0] * 2 + s[1]) * 4 + s[2]]
    for stage in range(4):
        w = jmodel.stage_probs(jparams, stage, want, jg.c_map,
                               jnp.asarray(prevs[stage].numpy()))
        with torch.no_grad():
            g = model.stage_probs(net, stage, got, tg.c_map, prevs[stage])
        assert g.shape == (tg.ccap, model.STAGE_SIZES[stage])
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=NET_ATOL)

    pc, po = levels[depth]
    jp = jcodec._pad_parents(pc, po)
    tp = codec._pad_parents(pc, po, torch.device("cpu"))
    want_bits, want_n = jmodel.level_bits(jparams, jcfg, *jp, jnp.asarray(gt))
    with torch.no_grad():
        got_bits, got_n = model.level_bits(net, cfg, *tp, torch.from_numpy(gt))
    assert int(got_n) == int(want_n) == tg.n_child
    np.testing.assert_allclose(float(got_bits), float(want_bits), rtol=BITS_RTOL)


def test_level_bits_packed_gradients_equal_jax():
    """Every leaf's gradient of one legacy level's bits, NetConfig(8, 3,
    f32), through the general conv's scatter-free backward, against JAX's
    `_level_bits_grad`."""
    cfg = model.NetConfig(8, 3, "f32")
    jcfg, jparams, net = _pair(cfg, seed=1)
    xyz = _cloud(np.random.default_rng(6), 1000, 80)
    jb, _ = jtrain.pyramid_batches(xyz.astype(np.int64), 3)
    tb, _ = train.pyramid_batches(xyz.astype(np.int64), 3, "cpu")
    (jg, jgt), (tg, tgt) = jb[-1], tb[-1]
    want_bits, want_n, want_grads = jtrain._level_bits_grad(
        jparams, jcfg, jg.po, jg.pm, jg.p_map, jg.octant, jg.parent_idx,
        jg.child_mask, jg.c_map, jgt)
    bits, n = train._batch_bits(net, cfg, (tg, tgt))
    bits.backward()
    assert int(n) == int(want_n)
    np.testing.assert_allclose(bits.item(), float(want_bits), rtol=BITS_RTOL)
    want = _flat(want_grads)
    got = {}
    for name, p in net.named_parameters():
        got[convert._codec_key(name)] = (p.grad.T if name.endswith(".weight")
                                         else p.grad).numpy()
    assert got.keys() == want.keys() and len(got) == 57
    for key, w in want.items():
        err = np.abs(got[key] - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= GRAD_REL, f"{key}: {err:.3e} of its largest magnitude"


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


# ---------------------------------------------------------------------------
# the engines and batch coding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("geom", ["host", "device"])
def test_engine_round_trip_and_bpp_match_jax(tmp_path, small_f32, geom):
    """Engine 6 (7) against JAX's v2 (v3) at NetConfig(16, 3, f32) on a
    shifted cloud: lossless, the version byte, bpp within 0.01 of JAX's;
    engine 7's header counts equal JAX's v3 counts."""
    jcfg, jparams, net = small_f32
    cfg = SMALL._replace(dtype="f32")
    xyz = _cloud(np.random.default_rng(7), 1500, 128, (-9, 3, -17))
    jpath, path = str(tmp_path / "jax.bin"), str(tmp_path / "port.bin")
    want = jcodec.compress_point_cloud(xyz, jparams, jpath, config=jcfg, geom=geom)
    got = codec.compress_point_cloud(xyz, net, path, config=cfg, geom=geom,
                                     device="cpu")
    print(f"{geom}: port {got['bpp']:.5f} bpp, JAX {want['bpp']:.5f}")
    assert abs(got["bpp"] - want["bpp"]) <= BPP_ATOL
    raw, jraw = open(path, "rb").read(), open(jpath, "rb").read()
    assert raw[4] == {"host": 6, "device": 7}[geom]
    # the header up to the streams (the counts for engine 7) is JAX's
    n_base = int(np.frombuffer(raw[19:23], np.int32)[0])
    head = 23 + 13 * n_base
    if geom == "device":
        n_levels = raw[head]
        counts = np.frombuffer(raw[head + 1:head + 5 + 4 * n_levels], np.int32)
        want_counts = np.frombuffer(jraw[head + 1:head + 5 + 4 * n_levels], np.int32)
        assert jraw[head] == n_levels
        np.testing.assert_array_equal(counts, want_counts)
        levels = _levels(xyz)
        assert list(counts[:-1]) == [lv[0].shape[0] for lv in levels[1:]]
        assert counts[-1] == xyz.shape[0]
        head += 5 + 4 * n_levels
    assert raw[5:head] == jraw[5:head]
    dec = codec.decompress_point_cloud(path, net, config=cfg, device="cpu")
    assert dec["num_points"] == xyz.shape[0]
    np.testing.assert_array_equal(_rows(dec["point_cloud"]), _rows(xyz))


@pytest.mark.parametrize("geom", ["sib", "host", "device"])
def test_batch_round_trip_and_rate(tmp_path, small_bf16, geom):
    """Three clouds (tests/test_gauspcgc.py:92) as one merged stream in each
    engine at NetConfig(16, 3, bf16): the version byte, every cloud
    lossless, and below 1.1x its clouds' single streams."""
    _, _, net = small_bf16
    rng = np.random.default_rng(3)
    clouds = [_cloud(rng, 700, extent=100),
              _cloud(rng, 400, extent=60, offset=(-20, 5, -90)),
              _cloud(rng, 1000, extent=128)]
    path = str(tmp_path / "batch.binb")
    out = codec.compress_point_cloud_batch(clouds, net, path, config=SMALL,
                                           geom=geom, device="cpu")
    assert open(path, "rb").read(5)[4] == codec.ENGINES[geom]
    assert out["num_clouds"] == 3
    assert out["num_points"] == sum(c.shape[0] for c in clouds)
    solo = sum(codec.compress_point_cloud(c, net, str(tmp_path / f"s{i}.bin"),
                                          config=SMALL, geom=geom,
                                          device="cpu")["file_size_bits"]
               for i, c in enumerate(clouds))
    print(f"{geom}: batch {out['file_size_bits']} bits, single streams {solo}")
    assert out["file_size_bits"] < BATCH_RATIO * solo
    dec = codec.decompress_point_cloud_batch(path, net, config=SMALL, device="cpu")
    assert dec["num_points"] == out["num_points"] and len(dec["point_clouds"]) == 3
    for got, want in zip(dec["point_clouds"], clouds):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(_rows(got), _rows(want))


# ---------------------------------------------------------------------------
# the legacy training levels
# ---------------------------------------------------------------------------

def test_legacy_train_step_equals_sib_step():
    """One float32 train step at NetConfig(8, 3) from the same weights on
    the same patch, through `pyramid_batches` and `pyramid_batches_sib`:
    the same bpp and the same weights after it."""
    cfg = model.NetConfig(8, 3, "f32")
    _, _, net_a = _pair(cfg, seed=2)
    _, _, net_b = _pair(cfg, seed=2)
    rng = np.random.default_rng(9)
    base = rng.integers(0, 64, size=(1400, 3))
    base[:, 2] = (base[:, 0] // 4 + base[:, 1] // 4) % 32
    xyz = np.unique(base, axis=0).astype(np.int64)
    tcfg = train.TrainConfig(channels=8, kernel_size=3)
    results = []
    for net, prepared in ((net_a, train.pyramid_batches(xyz, 3, "cpu")),
                          (net_b, train.pyramid_batches_sib(xyz, "cpu"))):
        opt = train.make_optimizer(tcfg)
        state = opt.init(dict(net.named_parameters()))
        state, bpp = train.train_step(net, opt, state, cfg, None, prepared=prepared)
        results.append(bpp)
    print(f"legacy {results[0]:.6f} bpp, sib {results[1]:.6f}")
    np.testing.assert_allclose(results[0], results[1], rtol=STEP_RTOL)
    pb = dict(net_b.named_parameters())
    for name, p in net_a.named_parameters():
        want = pb[name].detach().numpy()
        err = np.abs(p.detach().numpy() - want).max() / np.abs(want).max()
        assert err <= STEP_RTOL, f"{name}: {err:.3e}"
