"""The port's native arithmetic coder (gauspcc_tpu_torch/ops/coder.py over
its own copy of the C++ source) and its file-level coding
(ops/entropy_coding.py) against the JAX package's (gauspcc_tpu/ops/coder.py,
gauspcc_tpu/ops/entropy_coding.py), on the same seeded inputs.

Tolerances, each with its reason:
- streams and `.b` files: byte for byte (the same source built with the
  same flags on one machine, fed the same numbers);
- round trips: exact symbols and values;
- discretized-Gaussian CDF tables: at most 1 count of 2^16 (erfc and the
  rounding of a float32 product in two libraries).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gauspcc_tpu.core import cdf as jcdf
from gauspcc_tpu.ops import coder as jcoder
from gauspcc_tpu.ops import entropy_coding as jec
from gauspcc_tpu_torch import native
from gauspcc_tpu_torch.core import cdf
from gauspcc_tpu_torch.ops import coder
from gauspcc_tpu_torch.ops import entropy_coding as ec

from test_torch_native_libs import ensure_jax_native_libs


ensure_jax_native_libs()  # before any test here loads one


def _cdf_case(seed, n, lp):
    """Seeded uint16 CDF rows (the JAX package's normalization) and symbols
    drawn from them, a few at the rows' least likely symbols."""
    rng = np.random.default_rng(seed)
    probs = rng.dirichlet(np.full(lp - 1, 0.5), size=n).astype(np.float32)
    table = np.asarray(jcdf.probs_to_cdf_int16(jnp.asarray(probs)))
    syms = np.minimum((rng.random((n, 1)) > probs.cumsum(1)).sum(1), lp - 2)
    rare = rng.choice(n, n // 50, replace=False)
    syms[rare] = probs[rare].argmin(1)
    return table.astype(np.uint16), syms.astype(np.int16)


def _gauss_case(seed, n, k):
    """Residual-space mixtures of k Gaussians and symbols with outliers far
    in the tails."""
    rng = np.random.default_rng(seed)
    mu = rng.normal(0, 1.5, (n, k)).astype(np.float32)
    sigma = np.exp(rng.normal(0, 1, (n, k))).astype(np.float32)
    w = rng.dirichlet(np.ones(k), n).astype(np.float32)
    res = np.round(mu[:, 0] + sigma[:, 0] * rng.normal(size=n)).astype(np.int32)
    res[rng.choice(n, 20, replace=False)] = rng.choice([-300, 250], 20)
    rmin, rmax = int(res.min()), int(res.max())
    return mu, sigma, w, (res - rmin).astype(np.int16), rmin, rmax


@pytest.mark.parametrize("chunk_size", [coder.DEFAULT_CHUNK_SIZE, 997])
@pytest.mark.parametrize("lp", [3, 17])
def test_int16_cdf_stream_equals_jax_and_round_trips(chunk_size, lp):
    table, syms = _cdf_case(lp, 5000, lp)
    got = coder.encode_int16_cdf(table, syms, chunk_size)
    assert got == jcoder.encode_int16_cdf(table, syms, chunk_size)
    assert np.frombuffer(got[:4], np.uint32)[0] == -(-5000 // chunk_size)
    np.testing.assert_array_equal(coder.decode_int16_cdf(table, got, chunk_size),
                                  syms)


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("chunk_size", [coder.DEFAULT_CHUNK_SIZE, 1500])
def test_gauss_stream_equals_jax_and_round_trips(k, chunk_size):
    mu, sigma, w, syms, rmin, rmax = _gauss_case(k, 6000, k)
    w = None if k == 1 else w
    got = coder.encode_gauss(mu, sigma, syms, rmin, rmax, w=w,
                             chunk_size=chunk_size)
    assert got == jcoder.encode_gauss(mu, sigma, syms, rmin, rmax, w=w,
                                      chunk_size=chunk_size)
    np.testing.assert_array_equal(
        coder.decode_gauss(mu, sigma, got, rmin, rmax, w=w,
                           chunk_size=chunk_size), syms)


def test_incremental_decoder_equals_batch_decode():
    table, syms = _cdf_case(5, 4000, 5)
    stream = coder.encode_int16_cdf(table, syms, chunk_size=1000)
    dec = coder.IncrementalDecoder(stream, 4000, chunk_size=1000)
    parts = [dec.decode(table[a:b]) for a, b in ((0, 1), (1, 1700), (1700, 4000))]
    dec.close()
    np.testing.assert_array_equal(np.concatenate(parts),
                                  coder.decode_int16_cdf(table, stream, 1000))
    with pytest.raises(ValueError):
        coder.IncrementalDecoder(stream, 5000, chunk_size=1000)


def test_empty_input_and_mismatched_stream():
    assert coder.encode_int16_cdf(np.zeros((0, 3), np.uint16),
                                  np.zeros(0, np.int16)) == np.uint32(0).tobytes()
    table, syms = _cdf_case(1, 300, 3)
    stream = coder.encode_int16_cdf(table, syms, chunk_size=100)
    with pytest.raises(ValueError, match="chunks"):
        coder.decode_int16_cdf(table[:150], stream, chunk_size=100)
    assert coder.seconds > 0.0


def test_a_failed_host_build_raises_with_the_compiler_output(tmp_path):
    bad = tmp_path / "broken.cpp"
    bad.write_text("int f( {\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native._build(bad, lambda out, src: ["g++", *native.GXX_FLAGS, str(src),
                                             "-o", str(out)], "g++", b"")


@pytest.mark.parametrize("residual", [False, True])
def test_gaussian_cdf_tables_match_jax(residual):
    rng = np.random.default_rng(11)
    n = 400
    mean = rng.normal(0, 3, n).astype(np.float32)
    scale = np.exp(rng.normal(-1, 1, n)).astype(np.float32)
    scale[:5] = 0.0  # clamped to 1e-9
    q = rng.uniform(0.2, 2.0, n).astype(np.float32)
    fn, jfn = ((cdf.gaussian_cdf_table_residual, jcdf.gaussian_cdf_table_residual)
               if residual else (cdf.gaussian_cdf_table, jcdf.gaussian_cdf_table))
    got = fn(torch.from_numpy(mean), torch.from_numpy(scale),
             torch.from_numpy(q), -7, 9).numpy()
    want = np.asarray(jfn(jnp.asarray(mean), jnp.asarray(scale), jnp.asarray(q),
                          -7, 9)).astype(np.int32)
    assert got.shape == want.shape == (n, 18)
    diff = np.abs(got - want)
    assert ((diff <= 1) | (diff == 0xFFFF)).all()  # the wrapped last column


def _attributes(seed, n):
    rng = np.random.default_rng(seed)
    mean = rng.normal(0, 2, n).astype(np.float32)
    scale = np.exp(rng.normal(-0.5, 0.7, n)).astype(np.float32)
    q = rng.uniform(0.1, 1.0, n).astype(np.float32)
    x = (mean + scale * rng.normal(size=n) * 1.5).astype(np.float32)
    x[:3] = [40.0, -55.0, 0.0]
    return x, mean, scale, q


def test_encode_gaussian_file_equals_jax_and_decodes(tmp_path):
    x, mean, scale, q = _attributes(3, 7000)
    t = [torch.from_numpy(v) for v in (x, mean, scale, q)]
    bits = ec.encode_gaussian(*t, str(tmp_path / "t.b"))
    jbits = jec.encode_gaussian(x, mean, scale, jnp.asarray(q), str(tmp_path / "j.b"))
    assert bits == jbits
    assert (tmp_path / "t.b").read_bytes() == (tmp_path / "j.b").read_bytes()
    got = ec.decode_gaussian(t[1], t[2], t[3], str(tmp_path / "j.b"))
    want = np.asarray(jec.decode_gaussian(mean, scale, jnp.asarray(q),
                                          str(tmp_path / "j.b")))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(),
                                  ec.gaussian_values(*t).numpy())


def test_encode_gaussian_scalar_q_and_empty(tmp_path):
    x, mean, scale, _ = _attributes(4, 500)
    t = [torch.from_numpy(v) for v in (x, mean, scale)]
    ec.encode_gaussian(*t, 0.5, str(tmp_path / "t.b"))
    jec.encode_gaussian(x, mean, scale, 0.5, str(tmp_path / "j.b"))
    assert (tmp_path / "t.b").read_bytes() == (tmp_path / "j.b").read_bytes()
    np.testing.assert_array_equal(
        ec.decode_gaussian(t[1], t[2], 0.5, str(tmp_path / "t.b")).numpy(),
        np.asarray(jec.decode_gaussian(mean, scale, 0.5, str(tmp_path / "t.b"))))
    empty = torch.zeros(0)
    assert ec.encode_gaussian(empty, empty, empty, 1.0, str(tmp_path / "e.b")) == 96
    assert ec.decode_gaussian(empty, empty, 1.0, str(tmp_path / "e.b")).numel() == 0


@pytest.mark.parametrize("p", [0.0, 0.03, 0.5, 1.0])
def test_encode_binary_file_equals_jax_and_decodes(tmp_path, p):
    x = (np.random.default_rng(7).random(70_000) < p).astype(np.float32)
    bits = ec.encode_binary(torch.from_numpy(x), str(tmp_path / "t.b"))
    assert bits == jec.encode_binary(x, str(tmp_path / "j.b"))
    assert (tmp_path / "t.b").read_bytes() == (tmp_path / "j.b").read_bytes()
    np.testing.assert_array_equal(
        ec.decode_binary(x.size, str(tmp_path / "j.b")).numpy(), x)


def test_factorized_coder_round_trips(tmp_path):
    """The factorized coder (parity with JAX's tables and bytes:
    tests/test_torch_leftovers.py) on parameters of the port's own
    initialisation: the 8-byte header of the symbols' range, then the
    payload, and an exact decode."""
    from gauspcc_tpu_torch.core import entropy

    params = entropy.init_factorized_params(
        3, generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(8).laplace(
        0, 5, (4000, 3)).astype(np.float32))
    path = str(tmp_path / "f.b")
    bits = ec.encode_factorized(params, x, 1.0, path)
    raw = open(path, "rb").read()
    assert bits == 8 * len(raw)
    sym = torch.round(x)
    assert np.frombuffer(raw[:8], np.float32).tolist() == [sym.min(), sym.max()]
    np.testing.assert_array_equal(
        ec.decode_factorized(params, 4000, 3, 1.0, path).numpy(), sym.numpy())
