"""The port's rANS coder (gauspcc_tpu_torch/ops/rans.py) against the JAX
package's (gauspcc_tpu/ops/rans.py) on the same seeded tables and symbols.

Tolerance: none. rANS is integer arithmetic, so the port's plain version
(which the CUDA kernels are held against on the card, tests/test_torch_cuda.py)
must give the JAX package's stream byte for byte and decode every symbol.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gauspcc_tpu.core import cdf as jcdf
from gauspcc_tpu.ops import rans as jrans
from gauspcc_tpu_torch.ops import rans

STAGE_LP = (3, 3, 5, 17)  # columns of the four stage tables


def _tables(rng, cap, skew=1.0):
    """Seeded CDF tables (from the JAX package's normalization) and
    symbols drawn from them, one per stage."""
    tables, syms = [], []
    for lp in STAGE_LP:
        probs = rng.dirichlet(np.full(lp - 1, skew), size=cap).astype(np.float32)
        tables.append(np.asarray(jcdf.probs_to_cdf_int16(jnp.asarray(probs)))
                      .astype(np.int32))
        cum = probs.cumsum(1)
        u = rng.random((cap, 1))
        syms.append(np.minimum((u > cum).sum(1), lp - 2).astype(np.int32))
    return tables, syms


def _jax_stream(tables, syms, cap, n_valid):
    carry = jrans.enc_init(cap)
    for stage in (3, 2, 1, 0):
        carry = jrans.encode_stage(carry, jnp.asarray(tables[stage], jnp.uint16),
                                   jnp.asarray(syms[stage]), jnp.int32(n_valid))
    words, n_words = jrans.enc_flush(carry)
    return jrans.pack_stream(np.asarray(words), np.asarray(n_words))


def _port_stream(tables, syms, cap, n_valid):
    carry = rans.enc_init(cap)
    for stage in (3, 2, 1, 0):
        carry = rans.encode_stage(carry, torch.from_numpy(tables[stage]),
                                  torch.from_numpy(syms[stage]), n_valid)
    words, n_words = rans.enc_flush(carry)
    return rans.pack_stream(words.numpy(), n_words.numpy())


def _port_decode(stream, tables, cap, n_valid):
    w_np, _ = rans.unpack_stream(stream, rans.word_capacity(cap))
    words = torch.from_numpy(w_np)
    carry = rans.dec_init(words)
    prev = torch.zeros(cap, dtype=torch.int32)
    out = []
    for stage in range(4):
        carry, s, prev = rans.decode_stage(carry, torch.from_numpy(tables[stage]),
                                           words, n_valid, prev, stage)
        out.append(s.numpy())
    return out, prev.numpy()


@pytest.mark.parametrize("cap,frac", [(256, 1.0), (256, 0.3), (2048, 0.77),
                                      (4096, 0.0), (16384, 0.9)])
def test_stream_bytes_equal_jax_and_decode(cap, frac):
    """Four stages, flush and framing give the JAX package's bytes; the
    port decodes every stage's symbols and the fused prev (the occupancy
    byte after stage 3). Lanes: 8, 8, 16, 32 and 128."""
    rng = np.random.default_rng(cap + int(frac * 100))
    n_valid = int(cap * frac)
    tables, syms = _tables(rng, cap)
    stream = _port_stream(tables, syms, cap, n_valid)
    assert stream == _jax_stream(tables, syms, cap, n_valid)
    assert int(np.frombuffer(stream[:2], np.uint16)[0]) == rans.lane_count(cap)
    out, prev = _port_decode(stream, tables, cap, n_valid)
    for stage in range(4):
        np.testing.assert_array_equal(out[stage][:n_valid], syms[stage][:n_valid])
        assert not out[stage][n_valid:].any()
    byte = ((syms[0] * 2 + syms[1]) * 4 + syms[2]) * 16 + syms[3]
    np.testing.assert_array_equal(prev[:n_valid], byte[:n_valid])


def test_decode_symbols_equal_jax():
    """decode_stage against the JAX package's on a JAX-written stream."""
    rng = np.random.default_rng(7)
    cap, n_valid = 1024, 1000
    tables, syms = _tables(rng, cap, skew=0.3)
    stream = _jax_stream(tables, syms, cap, n_valid)
    w_np, _ = jrans.unpack_stream(stream, jrans.word_capacity(cap))
    carry = jrans.dec_init(jnp.asarray(w_np))
    want = []
    for stage in range(4):
        carry, s = jrans.decode_stage(carry, jnp.asarray(tables[stage], jnp.uint16),
                                      jnp.asarray(w_np), jnp.int32(n_valid))
        want.append(np.asarray(s))
    got, _ = _port_decode(stream, tables, cap, n_valid)
    for stage in range(4):
        np.testing.assert_array_equal(got[stage], want[stage])


def test_skewed_rows():
    """Near-deterministic rows, the common case of occupancy bits
    (tests/test_rans.py:84): one stage at Lp 3, every table the same."""
    cap = 512
    probs = np.full((cap, 2), [0.999, 0.001], np.float32)
    table = np.asarray(jcdf.probs_to_cdf_int16(jnp.asarray(probs))).astype(np.int32)
    rng = np.random.default_rng(2)
    tables = [table, table, table[:, :3], table]
    syms = [(rng.random(cap) < 0.001).astype(np.int32) for _ in range(4)]
    tables[2] = np.asarray(jcdf.probs_to_cdf_int16(jnp.asarray(
        np.full((cap, 4), [0.997, 0.001, 0.001, 0.001], np.float32)))).astype(np.int32)
    tables[3] = np.asarray(jcdf.probs_to_cdf_int16(jnp.asarray(
        np.full((cap, 16), [0.985] + [0.001] * 15, np.float32)))).astype(np.int32)
    stream = _port_stream(tables, syms, cap, cap)
    assert stream == _jax_stream(tables, syms, cap, cap)
    out, _ = _port_decode(stream, tables, cap, cap)
    for stage in range(4):
        np.testing.assert_array_equal(out[stage], syms[stage])


def test_lane_count_and_word_capacity_equal_jax():
    for cap in (256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 163840):
        assert rans.lane_count(cap) == jrans.lane_count(cap)
        for n_stages in (1, 4):
            assert rans.word_capacity(cap, n_stages) == jrans.word_capacity(cap, n_stages)


def test_kernel_path_needs_cuda_tensors():
    """A tensor on another device than CPU or CUDA raises rather than
    running the plain version."""
    cap = 256
    table = torch.zeros((cap, 3), dtype=torch.int32, device="meta")
    syms = torch.zeros(cap, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        rans.encode_stage(rans.enc_init(cap, device="meta"), table, syms, cap)
