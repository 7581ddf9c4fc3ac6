"""The port's GausPcgc codec training (gauspcc_tpu_torch/ops/sibconv.py's
backward, codecs/gauspcgc/model.py and train.py) against the JAX package's
(gauspcc_tpu/ops/sibconv.py, codecs/gauspcgc/model.py and train.py), on
the same seeded numpy clouds and the same weights, on the CPU, at
NetConfig(8, 3) as tests/test_train_gauspcgc.py trains.

Tolerances, each with its reason:
- the sib conv's dx, dw and db in float32: atol 1e-5 of the leaf's
  largest magnitude (the same products summed in another order);
- in bf16: 2e-2 of the leaf's largest magnitude (one bf16 rounding of
  sums taken in another order);
- level_bits_sib in float32: rtol 1e-6, every gradient within 1e-5 of the
  leaf's largest magnitude (a stack of 18 convs and 4 heads);
- in bf16: bits rtol 1e-5; every gradient within 2e-2 of the leaf's
  largest magnitude. A conv's bias may miss that only where JAX's own
  bf16 gradient is off the float32 gradient by more than 2e-2: JAX's XLA
  sums a bias's gradient over the slots in bf16 (a 4,000-term sum of 0.01
  gives 39.25), the port in float32. There the port's must be no farther
  from the float32 gradient than JAX's, and within 0.25 of JAX's. At
  NetConfig(8, 3) one bias of 54 misses 2e-2: level 0's spatial_s0/conv1
  reads 0.162 against JAX's, with JAX 0.149 and the port 0.037 off the
  float32 gradient; every other bias reads at most 0.0115. A bias
  gradient scaled by 0.8 reads 0.19 to 0.33 against JAX's, and its
  distance from the float32 gradient grows past JAX's;
- the geometry (pyramid_batches_sib): exact, it is integer work;
- cloud_bits in float32: rtol 1e-6; capacity padding: rtol 1e-6, as JAX's
  own test;
- the learning rate: exact (float32 on both sides);
- three float32 train steps: each step's bpp rtol 1e-5, every weight after
  them within 1e-5 of the leaf's largest magnitude plus 1e-6 absolute
  (Adam's first steps move a weight by about its rate whatever its
  gradient's size, so a difference near 0 in a gradient shows);
- resume: bit-equal on the CPU.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from gauspcc_tpu.codecs.gauspcgc import model as jmodel
from gauspcc_tpu.codecs.gauspcgc import train as jtrain
from gauspcc_tpu.ops import hostmap as jhostmap, sibconv as jsibconv, sparse as jsparse
from gauspcc_tpu_torch import convert
from gauspcc_tpu_torch.codecs.gauspcgc import data, model, train
from gauspcc_tpu_torch.ops import sibconv
from gauspcc_tpu_torch.utils import checkpoint

from test_torch_native_libs import ensure_jax_native_libs

ensure_jax_native_libs()  # before any test here loads one

CONV_F32_ATOL = 1e-5
BF16_REL = 2e-2
BIAS_BF16_REL = 0.25
BITS_F32_RTOL = 1e-6
BITS_BF16_RTOL = 1e-5
STEP_BPP_RTOL = 1e-5
STEP_W_REL, STEP_W_ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op torch thread for the module: the lane runs 6 workers
    on a few cores, where torch's thread pool oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _make_cloud(rng, n=1200, extent=64):
    """tests/test_train_gauspcgc.py:15: plane-ish, learnable structure."""
    base = rng.integers(0, extent, size=(n, 3))
    base[:, 2] = (base[:, 0] // 4 + base[:, 1] // 4) % (extent // 2)
    return np.unique(base, axis=0).astype(np.float32)


def _pair(dtype="f32", seed=1):
    """JAX params at NetConfig(8, 3, dtype) and the port's net with them."""
    jcfg = jmodel.NetConfig(8, 3, dtype)
    cfg = model.NetConfig(8, 3, dtype)
    jparams = jmodel.init_params(jax.random.PRNGKey(seed), jcfg)
    net = convert.codec_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), cfg, "cpu")
    return jcfg, cfg, jparams, net


def _flat(tree) -> dict:
    return checkpoint.flatten(jax.tree_util.tree_map(np.asarray, tree))


def _port_grads(net) -> dict:
    """{JAX key: gradient in JAX's layout} of the net's .grad."""
    out = {}
    for name, p in net.named_parameters():
        g = p.grad.T if name.endswith(".weight") else p.grad
        out[convert._codec_key(name)] = g.numpy()
    return out


def _rel_to_max(got, want) -> float:
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# the sib conv's backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kernel_size", [3, 5])
def test_sibconv_gradients_equal_jax(kernel_size, dtype):
    """dx, dw and db of a masked conv under a seeded upstream gradient
    against jax.grad, with pad groups past the valid ones."""
    rng = np.random.default_rng(kernel_size)
    coords = jsparse.dedupe_lex_np(rng.integers(0, 30, (700, 3))).astype(np.int32)
    groups = jsparse.dedupe_lex_np(coords.astype(np.int64) >> 1).astype(np.int32)
    pos = jsibconv.sib_pos_np(coords, groups)
    g = groups.shape[0] + 5
    gmapT = np.ascontiguousarray(
        jhostmap.build_map(groups, groups.shape[0], 3, ncap=g).T)
    slotmask = np.zeros(g * 8, bool)
    slotmask[pos] = True
    cin, cout = 8, 6
    x = np.zeros((g * 8, cin), np.float32)
    x[pos] = rng.standard_normal((coords.shape[0], cin))
    w = (0.3 * rng.standard_normal((kernel_size**3, cin, cout))).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    up = rng.standard_normal((g * 8, cout)).astype(np.float32)
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
                else (jnp.float32, torch.float32))

    def loss(x_, w_, b_):
        y = jsibconv.sibconv_apply(x_.astype(jdt), jnp.asarray(gmapT),
                                   jnp.asarray(gmapT[:, ::-1]), w_, b_,
                                   slotmask=jnp.asarray(slotmask))
        return jnp.sum(y.astype(jnp.float32) * up)

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w),
                                             jnp.asarray(b))
    leaves = [torch.tensor(a, requires_grad=True) for a in (x, w, b)]
    y = sibconv.sibconv_apply(leaves[0].to(tdt), torch.from_numpy(gmapT),
                              leaves[1], leaves[2],
                              slotmask=torch.from_numpy(slotmask))
    (y.float() * torch.from_numpy(up)).sum().backward()
    for name, got, ref in zip("xwb", leaves, want):
        ref = np.asarray(ref, np.float32)
        rel = _rel_to_max(got.grad.numpy(), ref)
        print(f"d{name}: {rel:.3e} of the leaf's largest magnitude")
        if dtype == "f32":
            np.testing.assert_allclose(got.grad.numpy(), ref, rtol=0,
                                       atol=CONV_F32_ATOL * np.abs(ref).max())
        else:
            assert rel <= BF16_REL


def test_conv_matrix_carries_the_gradient_to_w():
    """SibConv builds its conv matrix in the graph when w needs a gradient
    (w and b get JAX's gradient), and caches it under no_grad until w
    changes."""
    rng = np.random.default_rng(3)
    coords = jsparse.dedupe_lex_np(rng.integers(0, 20, (300, 3))).astype(np.int32)
    groups = jsparse.dedupe_lex_np(coords.astype(np.int64) >> 1).astype(np.int32)
    pos = jsibconv.sib_pos_np(coords, groups)
    gmapT = np.ascontiguousarray(jhostmap.build_map(groups, groups.shape[0], 3).T)
    slotmask = np.zeros(groups.shape[0] * 8, bool)
    slotmask[pos] = True
    x = np.zeros((groups.shape[0] * 8, 4), np.float32)
    x[pos] = rng.standard_normal((coords.shape[0], 4))
    w = rng.standard_normal((27, 4, 5)).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)

    def loss(w_, b_):
        y = jsibconv.sibconv_apply(jnp.asarray(x), jnp.asarray(gmapT),
                                   jnp.asarray(gmapT[:, ::-1]), w_, b_,
                                   slotmask=jnp.asarray(slotmask))
        return jnp.sum(jnp.tanh(y))

    jw, jb = jax.grad(loss, argnums=(0, 1))(jnp.asarray(w), jnp.asarray(b))
    conv = sibconv.SibConv(4, 5, 3)
    with torch.no_grad():
        conv.w.copy_(torch.from_numpy(w))
        conv.b.copy_(torch.from_numpy(b))
    gm = sibconv.group_map(torch.from_numpy(gmapT))
    sm = torch.from_numpy(slotmask)
    torch.tanh(conv(torch.from_numpy(x), gm, sm)).sum().backward()
    for got, want in ((conv.w.grad, jw), (conv.b.grad, jb)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=CONV_F32_ATOL * np.abs(want).max())
    with torch.no_grad():
        first = conv.conv_matrix(torch.float32)
        assert conv.conv_matrix(torch.float32) is first  # cached
        conv.w.add_(1.0)
        assert conv.conv_matrix(torch.float32) is not first  # w changed
        assert not first.requires_grad


# ---------------------------------------------------------------------------
# level bits and every gradient
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_level_bits_and_every_gradient_equal_jax(dtype):
    """Every coded level of a 2,500-point cloud: the bits, the child count
    and the gradient of every leaf against JAX's `_level_bits_sib_grad`."""
    jcfg, cfg, jparams, net = _pair(dtype)
    jcfg32 = jmodel.NetConfig(8, 3, "f32")
    xyz = _make_cloud(np.random.default_rng(5), 2500).astype(np.int64)
    jb, jn = jtrain.pyramid_batches_sib(xyz, 3)
    tb, tn = train.pyramid_batches_sib(xyz, "cpu")
    assert jn == tn and len(jb) == len(tb) >= 3
    for a, b in zip(jb, tb):
        jbits, jcount, jgrads = jtrain._level_bits_sib_grad(
            jparams, jcfg, a.pocc, a.pmask, a.p_gmapT, a.p_gmapfT, a.ppos,
            a.c_gmapT, a.c_gmapfT, a.cmask, a.gt)
        net.zero_grad(set_to_none=True)
        bits, count = train._batch_bits(net, cfg, b)
        bits.backward()
        assert int(count) == int(jcount)
        np.testing.assert_allclose(
            float(bits.detach()), float(jbits),
            rtol=BITS_F32_RTOL if dtype == "f32" else BITS_BF16_RTOL)
        got, want = _port_grads(net), _flat(jgrads)
        assert got.keys() == want.keys()
        f32 = None
        for key, ref in want.items():
            rel = _rel_to_max(got[key], ref)
            if dtype == "f32":
                assert rel <= CONV_F32_ATOL, (key, rel)
                continue
            bias = key.endswith("/b") and "head" not in key
            if rel <= BF16_REL or not bias:
                assert rel <= BF16_REL, (key, rel)
                continue
            if f32 is None:  # the float32 gradient, from the same weights
                f32 = _flat(jtrain._level_bits_sib_grad(
                    jparams, jcfg32, a.pocc, a.pmask, a.p_gmapT, a.p_gmapfT,
                    a.ppos, a.c_gmapT, a.c_gmapfT, a.cmask, a.gt)[2])
            port_off, jax_off = (_rel_to_max(got[key], f32[key]),
                                 _rel_to_max(ref, f32[key]))
            assert jax_off > BF16_REL, (key, rel, jax_off)
            print(f"{key}: {rel:.4f} of JAX's; off the float32 gradient: "
                  f"port {port_off:.4f}, JAX {jax_off:.4f}")
            assert rel <= BIAS_BF16_REL and port_off <= jax_off, (
                key, rel, port_off, jax_off)


def test_pyramid_batches_sib_equal_jax_and_share_maps():
    """Every array of every SibLevel equals JAX's exactly (the group maps
    as their gather rows and flips), and a level's child map is the next
    level's parent map, one object."""
    xyz = (_make_cloud(np.random.default_rng(7), 2500).astype(np.int64)
           + np.array([-40, 3, 900]))
    jb, jn = jtrain.pyramid_batches_sib(xyz, 3)
    tb, tn = train.pyramid_batches_sib(xyz, "cpu")
    assert jn == tn and len(jb) == len(tb) >= 3
    for a, b in zip(jb, tb):
        for name in ("pocc", "pmask", "ppos", "cmask", "gt"):
            np.testing.assert_array_equal(getattr(b, name).numpy(),
                                          np.asarray(getattr(a, name)), name)
        for side in ("p", "c"):
            gm = getattr(b, f"{side}_maps")
            for attr, jname in (("index", "gmapT"), ("flipped", "gmapfT")):
                want = sibconv.gather_index(torch.from_numpy(
                    np.array(getattr(a, f"{side}_{jname}"))))
                assert torch.equal(getattr(gm, attr), want), (side, attr)
    for lo, hi in zip(tb, tb[1:]):
        assert lo.c_maps is hi.p_maps


def test_cloud_bits_equal_jax_and_padding_invariant(monkeypatch):
    """cloud_bits against JAX's in float32, and unchanged when every
    capacity doubles (tests/test_train_gauspcgc.py
    test_train_bucket_pad_invariance)."""
    jcfg, cfg, jparams, net = _pair("f32", seed=2)
    xyz = _make_cloud(np.random.default_rng(11), 2500).astype(np.int64)
    want, jn = jtrain.cloud_bits(jparams, jcfg, xyz)
    bits_a, n_a = train.cloud_bits(net, cfg, xyz)
    assert n_a == jn
    np.testing.assert_allclose(bits_a, want, rtol=BITS_F32_RTOL)
    orig = train._bucket_train
    monkeypatch.setattr(train, "_bucket_train",
                        lambda n, minimum=256: 2 * orig(n, minimum))
    bits_b, n_b = train.cloud_bits(net, cfg, xyz)
    assert n_a == n_b
    np.testing.assert_allclose(bits_a, bits_b, rtol=1e-6)


def test_geo_cache_byte_accounting():
    """_prepared_nbytes counts each shared group map once."""
    xyz = _make_cloud(np.random.default_rng(12), 2500).astype(np.int64)
    prepared = train.pyramid_batches_sib(xyz, "cpu")
    nb = train._prepared_nbytes(prepared)
    naive = 0
    for b in prepared[0]:
        for name in b.__slots__:
            a = getattr(b, name)
            naive += (a.nbytes if isinstance(a, sibconv.GroupMap)
                      else a.numel() * a.element_size())
    maps = {id(m): m for b in prepared[0] for m in (b.p_maps, b.c_maps)}
    arrays = sum(getattr(b, n).numel() * getattr(b, n).element_size()
                 for b in prepared[0] for n in ("pocc", "pmask", "ppos", "cmask", "gt"))
    assert nb == arrays + sum(m.nbytes for m in maps.values())
    assert nb < naive
    assert all(m._flipped is not None for m in maps.values())


def test_legacy_levels_raise_naming_the_item():
    _, cfg, _, net = _pair()
    with pytest.raises(NotImplementedError, match="Queue 1 item 7e"):
        train.pyramid_batches(np.zeros((10, 3), np.int64), 3)
    with pytest.raises(NotImplementedError, match="Queue 1 item 7e"):
        train.cloud_bits(net, cfg, None, prepared=([(None, None)], 10))


# ---------------------------------------------------------------------------
# the optimizer and the step
# ---------------------------------------------------------------------------

def test_learning_rate_at_the_boundary_equals_optax():
    """Adam under lr_decay_steps=(2,): updates 1, 2 and 3 (counts b-1, b
    and b+1 before the update) against optax.adam with the same schedule,
    on the same gradients: the rate, and the moved weights exactly."""
    cfg = train.TrainConfig(lr_decay_steps=(2,))
    sched = train.lr_schedule(cfg)
    want_sched = optax.piecewise_constant_schedule(
        cfg.learning_rate, {2: cfg.lr_decay})
    for count in range(5):
        assert sched(count) == float(np.float32(want_sched(count)))
    assert sched(1) == float(np.float32(5e-4)) and sched(2) == float(
        np.float32(np.float32(0.1) * np.float32(5e-4)))
    rng = np.random.default_rng(0)
    w0 = rng.standard_normal(64).astype(np.float32)
    opt = jtrain.make_optimizer(cfg)
    jw = jnp.asarray(w0)
    jstate = opt.init(jw)
    port = train.make_optimizer(cfg)
    tw = torch.from_numpy(w0.copy())
    tstate = port.init({"w": tw})
    for _ in range(4):
        g = rng.standard_normal(64).astype(np.float32)
        upd, jstate = opt.update(jnp.asarray(g), jstate, jw)
        jw = optax.apply_updates(jw, upd)
        tstate = port.update({"w": torch.from_numpy(g)}, tstate, {"w": tw})
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))


def test_three_train_steps_equal_jax():
    """Three float32 steps from the same weights on three clouds: each
    step's bpp and every weight after them against JAX's train_step."""
    jcfg, cfg, jparams, net = _pair("f32", seed=4)
    tcfg = train.TrainConfig(channels=8, kernel_size=3)
    jopt = jtrain.make_optimizer(tcfg)
    jstate = jopt.init(jparams)
    update = jtrain.make_update_fn(jopt)
    zero = jax.tree_util.tree_map(jnp.zeros_like, jparams)
    opt = train.make_optimizer(tcfg)
    state = opt.init(dict(net.named_parameters()))
    rng = np.random.default_rng(9)
    for step in range(3):
        xyz = _make_cloud(rng, 1500).astype(np.int64)
        jparams, jstate, jbpp = jtrain.train_step(
            jparams, jstate, update, jcfg, xyz, zero)
        state, bpp = train.train_step(net, opt, state, cfg, xyz)
        print(f"step {step}: bpp {bpp:.6f} (JAX {jbpp:.6f})")
        np.testing.assert_allclose(bpp, jbpp, rtol=STEP_BPP_RTOL)
    want = _flat(jparams)
    got = checkpoint.flatten(net)
    for key, ref in want.items():
        np.testing.assert_allclose(
            got[key], ref, rtol=0,
            atol=STEP_W_REL * np.abs(ref).max() + STEP_W_ATOL, err_msg=key)


def _corpus(tmp_path, n_files=1, n=3000, seed=5):
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n_files):
        p = str(tmp_path / f"c{i}.npy")
        np.save(p, _make_cloud(rng, n))
        paths.append(p)
    return paths


def test_resume_continues_bit_equal(tmp_path):
    """Two steps, the snapshot, then a resumed run to four: every weight,
    Adam's moments and the count bit-equal to four straight steps (one
    cloud, so the dataset's generator is where the straight run's is)."""
    paths = _corpus(tmp_path)

    def cfg(d):
        return train.TrainConfig(channels=8, kernel_size=3, max_steps=4,
                                 val_interval=100, model_dir=str(tmp_path / d),
                                 lr_decay_steps=(3,))

    straight = train.train(cfg("a"), data.PatchDataset(paths, seed=0, max_num=2000),
                           None, state_every=1, device="cpu")
    ds = data.PatchDataset(paths, seed=0, max_num=2000)
    train.train(cfg("b"), ds, None, max_steps=2, state_every=1, device="cpu")
    state_path = str(tmp_path / "b" / "train_state.pkl")
    assert checkpoint.load_training_checkpoint(state_path)["iteration"] == 2
    resumed = train.train(cfg("b"), ds, None, resume_state=state_path,
                          state_every=1, device="cpu")
    for (name, a), (_, b) in zip(straight.named_parameters(),
                                 resumed.named_parameters()):
        assert torch.equal(a, b), name
    snap_a = checkpoint.load_training_checkpoint(str(tmp_path / "a" / "train_state.pkl"))
    snap_b = checkpoint.load_training_checkpoint(state_path)
    assert snap_a["iteration"] == snap_b["iteration"] == 4
    assert snap_a["opt_state"]["count"] == snap_b["opt_state"]["count"] == 4
    for part in ("mu", "nu"):
        for k, v in snap_a["opt_state"][part].items():
            np.testing.assert_array_equal(v, snap_b["opt_state"][part][k])
    assert os.path.exists(state_path + ".prev")
    assert not os.path.exists(state_path + ".tmp")


def test_train_zero_geo_cache_budget_and_outputs(tmp_path):
    """geo_cache_bytes=0 only disables the cache; validation writes
    best_model.npz, the run final_model.npz, both in JAX's keys."""
    paths = _corpus(tmp_path, n_files=2, n=2000, seed=13)
    cfg = train.TrainConfig(channels=8, kernel_size=3, max_steps=3,
                            val_interval=3, model_dir=str(tmp_path / "m"),
                            lr_decay_steps=(50,))
    ds = data.PatchDataset(paths, seed=0, max_num=1500)
    val = data.WholeCloudDataset(paths[:1])
    net = train.train(cfg, ds, val, state_every=1, geo_cache_bytes=0,
                      device="cpu")
    snap = checkpoint.load_training_checkpoint(
        str(tmp_path / "m" / "train_state.pkl"))
    assert snap["iteration"] == 3 and np.isfinite(snap["best_val"])
    bits, n = train.cloud_bits(net, cfg.net, val.get(0))
    assert snap["best_val"] == pytest.approx(bits / n, rel=1e-6)
    for name in ("best_model.npz", "final_model.npz"):
        loaded = convert.load_codec_npz(str(tmp_path / "m" / name), cfg.net, "cpu")
        for a, b in zip(loaded.parameters(), net.parameters()):
            assert torch.equal(a, b)
    log = open(tmp_path / "m" / "train.log").read()
    assert "first step done" in log and "val_bpp" in log


def test_a_failing_step_dumps_the_weights(tmp_path, monkeypatch):
    paths = _corpus(tmp_path, n=1500)
    cfg = train.TrainConfig(channels=8, kernel_size=3, max_steps=3,
                            model_dir=str(tmp_path / "m"))
    calls = []
    real = train.train_step

    def flaky(*args, **kw):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("device lost")
        return real(*args, **kw)

    monkeypatch.setattr(train, "train_step", flaky)
    with pytest.raises(RuntimeError, match="device lost"):
        train.train(cfg, data.PatchDataset(paths, seed=0), None, device="cpu")
    assert os.path.exists(tmp_path / "m" / "error_model_1.npz")


def test_training_reduces_bpp():
    """tests/test_train_gauspcgc.py test_training_reduces_bpp: 50 steps at
    lr 5e-4 over three plane-ish clouds lower the bpp by 8% or more."""
    rng = np.random.default_rng(5)
    cfg = train.TrainConfig(channels=8, kernel_size=3)
    net = model.init_net(cfg.net, cfg.seed)
    opt = train.make_optimizer(cfg)
    state = opt.init(dict(net.named_parameters()))
    clouds = [_make_cloud(rng).astype(np.int64) for _ in range(3)]
    prepared = [train.pyramid_batches_sib(c, "cpu") for c in clouds]
    first = last = None
    for step in range(50):
        state, bpp = train.train_step(net, opt, state, cfg.net, None,
                                      prepared=prepared[step % 3])
        first = bpp if first is None else first
        last = bpp
    print(f"bpp {first:.4f} -> {last:.4f}")
    assert last < first * 0.92, f"bpp did not improve: {first} -> {last}"


def test_init_net_draws_jax_distributions():
    """init_net: every leaf in JAX's range (embeddings N(0, 1), convs and
    dense layers U(+-1/sqrt(fan_in))), the same weights for one seed."""
    cfg = model.NetConfig(8, 3)
    net = model.init_net(cfg, 11)
    again = model.init_net(cfg, 11)
    want = _flat(jmodel.init_params(jax.random.PRNGKey(0), jmodel.NetConfig(8, 3)))
    got = checkpoint.flatten(net)
    assert got.keys() == want.keys()
    for key, ref in want.items():
        assert got[key].shape == ref.shape
        if "emb" in key:
            assert abs(float(got[key].std()) - 1.0) < 0.35
            continue
        w = want[key[: key.rfind("/") + 1] + "w"]
        fan_in = w.shape[0] * w.shape[1] if w.ndim == 3 else w.shape[0]
        bound = 1.0 / np.sqrt(fan_in)
        assert np.abs(got[key]).max() <= bound, key
        if ref.size >= 16:
            assert np.abs(got[key]).max() > 0.5 * bound, key
    for a, b in zip(net.parameters(), again.parameters()):
        assert torch.equal(a, b)
