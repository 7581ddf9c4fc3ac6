"""The last of the JAX package's functions to reach the port, on the CPU on
the same seeded numpy inputs: `core/quant.py` quantize_to_symbols and
quantize_anchor, `core/entropy.py` bernoulli_bits and the fully factorized
model, `ops/entropy_coding.py` encode_factorized / decode_factorized, and
`ops/sparse.py` sparse_conv_window.

Tolerances, each with its reason:
- the quantizers: exact (the same float32 operations, element by element);
- bernoulli_bits: abs 1e-6 (log2 in two libraries);
- the factorized model: abs 1e-5 on logits and bits (a few float32 layers
  of softplus, matmul and tanh in two libraries), gradients rel 1e-4 of
  each leaf's largest magnitude;
- the factorized coder: its uint16 tables within one count of JAX's
  (XLA's and torch's float32 tanh and softplus differ by an ulp, and a CDF
  beside a rounding step of 2^16 rounds either way); where the tables
  agree, the `.b` bytes exact; every decode exact;
- sparse_conv_window in float32: atol 1e-5 (the same products summed in
  another order); in bf16: one bf16 step of the result, rtol 2^-7 (both
  accumulate in float32 and round once to bf16, so a sum that lands beside
  a rounding boundary can round either way) plus atol 1e-6.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gauspcc_tpu.core import cdf as jcdf
from gauspcc_tpu.core import entropy as jentropy
from gauspcc_tpu.core import quant as jquant
from gauspcc_tpu.ops import entropy_coding as jec
from gauspcc_tpu.ops import hostmap as jhostmap
from gauspcc_tpu.ops import sparse as jsparse
from gauspcc_tpu.utils import checkpoint as jcheckpoint
from gauspcc_tpu_torch import convert
from gauspcc_tpu_torch.core import entropy, quant
from gauspcc_tpu_torch.ops import entropy_coding as ec
from gauspcc_tpu_torch.ops import sparse

from test_torch_native_libs import ensure_jax_native_libs

ensure_jax_native_libs()  # before any test here loads one

BF16_RTOL, BF16_ATOL = 2.0**-7, 1e-6
CHANNELS = 4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_quantize_to_symbols_equals_jax():
    x = np.random.default_rng(0).normal(0, 40, 5000).astype(np.float32)
    x[:4] = [0.5, 1.5, -0.5, -2.5]  # ties round to even on both sides
    for q in (1.0, 0.37):
        got = quant.quantize_to_symbols(torch.from_numpy(x), q)
        want = np.asarray(jquant.quantize_to_symbols(jnp.asarray(x), q))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_quantize_anchor_equals_jax_with_identity_gradient():
    rng = np.random.default_rng(1)
    anchors = rng.uniform(-3, 5, (700, 3)).astype(np.float32)
    anchors[:3] = [[-9, 0, 0], [9, 9, 9], [-3, -3, -3]]  # clipped at both ends
    lo, hi = np.float32([-3, -2, -2.5]), np.float32([5, 4, 4.5])
    up = rng.standard_normal(anchors.shape).astype(np.float32)
    assert quant.Q_ANCHOR == jquant.Q_ANCHOR
    assert quant.ANCHOR_ROUND_DIGITS == jquant.ANCHOR_ROUND_DIGITS
    want_q, want_v = jquant.quantize_anchor(jnp.asarray(anchors), jnp.asarray(lo),
                                            jnp.asarray(hi))
    want_g = jax.grad(lambda a: jnp.sum(
        jquant.quantize_anchor(a, jnp.asarray(lo), jnp.asarray(hi))[0] * up))(
            jnp.asarray(anchors))
    a = torch.tensor(anchors, requires_grad=True)
    lo_t = torch.tensor(lo, requires_grad=True)
    got_q, got_v = quant.quantize_anchor(a, lo_t, torch.from_numpy(hi))
    np.testing.assert_array_equal(got_q.detach().numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    assert float(got_v.max()) == 2**16 - 1 and float(got_v.min()) == 0
    (got_q * torch.from_numpy(up)).sum().backward()
    np.testing.assert_array_equal(a.grad.numpy(), np.asarray(want_g))
    np.testing.assert_array_equal(a.grad.numpy(), up)
    assert lo_t.grad is None


def test_bernoulli_bits_match_jax():
    rng = np.random.default_rng(2)
    x = np.where(rng.random(3000) < 0.3, 1.0, -1.0).astype(np.float32)
    p = rng.random(3000).astype(np.float32)
    p[:2] = [0.0, 1.0]  # clipped to 1e-6, 1 - 1e-6
    got = entropy.bernoulli_bits(torch.from_numpy(x), torch.from_numpy(p))
    want = jentropy.bernoulli_bits(jnp.asarray(x), jnp.asarray(p))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def _jax_params(seed=0):
    """JAX's factorized parameters, moved off their initial constants so
    every layer (the tanh factors too) does work."""
    params = jentropy.init_factorized_params(jax.random.PRNGKey(seed), CHANNELS)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda v: jnp.asarray(np.asarray(v) + rng.normal(0, 0.3, v.shape)
                              .astype(np.float32)), params)


def _port_params(jparams, requires_grad=False):
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    params = convert.factorized_params_from_numpy(tree, device="cpu")
    for leaves in params.values():
        for v in leaves:
            v.requires_grad_(requires_grad)
    return params


def test_init_factorized_params_layout():
    gen = torch.Generator().manual_seed(0)
    got = entropy.init_factorized_params(CHANNELS, generator=gen)
    want = jentropy.init_factorized_params(jax.random.PRNGKey(0), CHANNELS)
    for name in ("matrices", "biases", "factors"):
        assert len(got[name]) == len(want[name])
        for g, w in zip(got[name], want[name]):
            assert tuple(g.shape) == w.shape and g.dtype == torch.float32
    for g, w in zip(got["matrices"], want["matrices"]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g in got["factors"]:
        assert not g.any()
    for g in got["biases"]:
        assert float(g.min()) >= -0.5 and float(g.max()) < 0.5


def test_factorized_params_load_from_a_jax_checkpoint(tmp_path):
    jparams = _jax_params(3)
    path = str(tmp_path / "f.npz")
    jcheckpoint.save_pytree(path, jparams)
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    got = convert.factorized_params_from_numpy(flat, device="cpu")
    for name in ("matrices", "biases", "factors"):
        assert len(got[name]) == len(jparams[name])
        for g, w in zip(got[name], jparams[name]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("q_kind", ["scalar", "per_element"])
def test_factorized_model_and_gradients_match_jax(q_kind):
    rng = np.random.default_rng(4)
    jparams = _jax_params(1)
    n = 300
    x = np.round(rng.normal(0, 3, (n, CHANNELS))).astype(np.float32)
    up = rng.standard_normal((n, CHANNELS)).astype(np.float32)
    q = 1.0 if q_kind == "scalar" else rng.uniform(0.5, 2, (n, CHANNELS)).astype(np.float32)
    jq = q if q_kind == "scalar" else jnp.asarray(q)
    tq = q if q_kind == "scalar" else torch.from_numpy(q)

    logits = x.T[:, None, :]
    want_l = jentropy.factorized_logits_cumulative(jparams, jnp.asarray(logits))
    params = _port_params(jparams, requires_grad=True)
    got_l = entropy.factorized_logits_cumulative(params, torch.from_numpy(logits))
    np.testing.assert_allclose(got_l.detach().numpy(), np.asarray(want_l),
                               rtol=0, atol=1e-5)

    def jloss(p, xx):
        return jnp.sum(jentropy.factorized_bits(p, xx, jq) * up)

    want_b = jentropy.factorized_bits(jparams, jnp.asarray(x), jq)
    want_gp, want_gx = jax.grad(jloss, argnums=(0, 1))(jparams, jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    got_b = entropy.factorized_bits(params, xt, tq)
    np.testing.assert_allclose(got_b.detach().numpy(), np.asarray(want_b),
                               rtol=0, atol=1e-5)
    (got_b * torch.from_numpy(up)).sum().backward()
    pairs = [(xt.grad, want_gx)] + [
        (g.grad, w) for name in ("matrices", "biases", "factors")
        for g, w in zip(params[name], want_gp[name])]
    for got_g, w in pairs:
        w = np.asarray(w)
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(got_g.numpy(), w, rtol=0, atol=1e-4 * scale)


def _jax_table(jparams, min_v, max_v, q):
    """The uint16 rows JAX's encode_factorized builds
    (gauspcc_tpu/ops/entropy_coding.py:181-190)."""
    lp = max_v - min_v + 2
    samples = (jnp.arange(lp, dtype=jnp.float32) + (min_v - 0.5)) * q
    cdf = jax.nn.sigmoid(jentropy.factorized_logits_cumulative(
        jparams, jnp.broadcast_to(samples[None, None, :], (CHANNELS, 1, lp))))[:, 0, :]
    cdf = jnp.clip((cdf - cdf[:, :1]) / jnp.maximum(cdf[:, -1:] - cdf[:, :1], 1e-9),
                   0.0, 1.0)
    return np.asarray(jcdf.normalize_cdf_int16(cdf)).astype(np.uint16)


def _coder_case(q):
    x = (np.random.default_rng(5).laplace(0, 4, (2000, CHANNELS)) * q).astype(np.float32)
    sym = np.round(x / q).astype(np.int32)
    return x, sym, int(sym.min()), int(sym.max())


def test_factorized_coder_bytes_equal_jax(tmp_path):
    """At q 1 the port's tables equal JAX's entry for entry, and so do the
    .b files, byte for byte; each package decodes the other's file."""
    q = 1.0
    jparams = _jax_params(2)
    params = _port_params(jparams)
    x, sym, min_v, max_v = _coder_case(q)
    np.testing.assert_array_equal(ec.factorized_table(params, min_v, max_v, q),
                                  _jax_table(jparams, min_v, max_v, q))
    bits = ec.encode_factorized(params, torch.from_numpy(x), q, str(tmp_path / "t.b"))
    jbits = jec.encode_factorized(jparams, x, q, str(tmp_path / "j.b"))
    assert bits == jbits
    assert (tmp_path / "t.b").read_bytes() == (tmp_path / "j.b").read_bytes()
    got = ec.decode_factorized(params, x.shape[0], CHANNELS, q, str(tmp_path / "j.b"))
    want = np.asarray(jec.decode_factorized(jparams, x.shape[0], CHANNELS, q,
                                            str(tmp_path / "t.b")))
    assert got.dtype == torch.float32 and tuple(got.shape) == x.shape
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), sym.astype(np.float32))


@pytest.mark.parametrize("q", [1.0, 0.5, 0.25, 2.0])
def test_factorized_coder_tables_and_round_trip(tmp_path, q):
    """The port's tables within one count of JAX's (XLA's and torch's
    float32 tanh and softplus differ by an ulp, and a CDF that lands beside
    a rounding step of 2^16 rounds either way: at q 0.5, one entry of 368),
    and the port's own stream decodes exactly."""
    jparams = _jax_params(2)
    params = _port_params(jparams)
    x, sym, min_v, max_v = _coder_case(q)
    got = ec.factorized_table(params, min_v, max_v, q).astype(np.int64)
    want = _jax_table(jparams, min_v, max_v, q).astype(np.int64)
    diff = np.abs((got - want + 2**15) % 2**16 - 2**15)  # the last column wraps
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.01
    ec.encode_factorized(params, torch.from_numpy(x), q, str(tmp_path / "t.b"))
    dec = ec.decode_factorized(params, x.shape[0], CHANNELS, q, str(tmp_path / "t.b"))
    np.testing.assert_array_equal(dec.numpy(), sym.astype(np.float32) * np.float32(q))


def test_factorized_coder_empty(tmp_path):
    params = _port_params(_jax_params(0))
    empty = torch.zeros((0, CHANNELS))
    bits = ec.encode_factorized(params, empty, 1.0, str(tmp_path / "t.b"))
    assert bits == jec.encode_factorized(_jax_params(0), np.zeros((0, CHANNELS), np.float32),
                                         1.0, str(tmp_path / "j.b"))
    assert (tmp_path / "t.b").read_bytes() == (tmp_path / "j.b").read_bytes()
    assert tuple(ec.decode_factorized(params, 0, CHANNELS, 1.0,
                                      str(tmp_path / "t.b")).shape) == (0, CHANNELS)


def _window_case(kernel_size, seed, n=400, extent=12, cin=8, cout=16, extra=30):
    """A codec-like self-map, packed by the JAX package's host code, with
    padding queries, features, weights and bias."""
    rng = np.random.default_rng(seed)
    pts = np.unique(rng.integers(0, extent, (n * 2, 3)), axis=0)[:n]
    pts = pts[np.lexsort((pts[:, 0], pts[:, 1], pts[:, 2]))].astype(np.int32)
    nv = pts.shape[0]
    padded = np.zeros((nv + extra, 3), np.int32)
    padded[:nv] = pts
    lo, codes = jhostmap.build_map_packed(padded, nv, kernel_size, nv + extra)
    x = rng.standard_normal((nv + extra, cin)).astype(np.float32)
    w = (0.3 * rng.standard_normal((kernel_size**3, cin, cout))).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    return lo, codes, x, w, b


@pytest.mark.parametrize("kernel_size", [3, 5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sparse_conv_window_matches_jax_and_the_dense_conv(kernel_size, dtype):
    lo, codes, x, w, b = _window_case(kernel_size, seed=kernel_size)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jsparse.sparse_conv_window(
        jnp.asarray(x).astype(jdt), jsparse.WindowMap(jnp.asarray(lo), jnp.asarray(codes)),
        jnp.asarray(w), jnp.asarray(b))
    wmap = sparse.WindowMap(torch.from_numpy(lo), torch.from_numpy(codes.astype(np.int32)))
    xt = torch.from_numpy(x).to(tdt)
    got = sparse.sparse_conv_window(xt, wmap, torch.from_numpy(w), torch.from_numpy(b))
    dense = sparse.sparse_conv_apply(xt, sparse.nmap_from_packed(wmap, kernel_size),
                                     torch.from_numpy(w), torch.from_numpy(b))
    assert got.dtype == tdt and tuple(got.shape) == (x.shape[0], w.shape[2])
    got32 = got.to(torch.float32).numpy()
    want32 = np.asarray(want.astype(jnp.float32))
    dense32 = dense.to(torch.float32).numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got32, want32, rtol=0, atol=1e-5)
        np.testing.assert_allclose(got32, dense32, rtol=0, atol=1e-5)
    else:
        np.testing.assert_allclose(got32, want32, rtol=BF16_RTOL, atol=BF16_ATOL)
        np.testing.assert_allclose(got32, dense32, rtol=BF16_RTOL, atol=BF16_ATOL)


def test_sparse_conv_window_refuses_a_mismatched_map():
    lo, codes, x, w, b = _window_case(3, seed=0)
    wmap = sparse.WindowMap(torch.from_numpy(lo), torch.from_numpy(codes.astype(np.int32)))
    with pytest.raises(ValueError, match="kernel rows"):
        sparse.sparse_conv_window(torch.from_numpy(x), wmap,
                                  torch.zeros(125, x.shape[1], 4))
