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
from gauspcc_tpu_torch.core import cdf
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


def _counting_search(rows, slot):
    """The plain version's search: s counts the entries of columns 1..Lp-2
    at or below the slot; (lo, freq) of s read from the row."""
    lp = rows.shape[1]
    s = (rows[:, 1:lp - 1] <= slot[:, None]).sum(1)
    lo, freq = rans._row_freq(rows, s)
    return s, lo, freq


def _search_rows(kind, lp, rng):
    """Rows nondecreasing over columns 0..Lp-2: `random` from seeded
    probabilities (core/cdf.py, strictly increasing), `zerofreq` with about
    half the symbols at frequency 0 (equal neighbouring entries), `last`
    with all the mass in the last symbol (every entry 0, the wrapped last
    column too)."""
    n = 64
    if kind == "random":
        probs = rng.dirichlet(np.full(lp - 1, 0.7), size=n).astype(np.float32)
        return cdf.probs_to_cdf_int16(torch.from_numpy(probs)).to(torch.int64)
    if kind == "last":
        return torch.zeros((n, lp), dtype=torch.int64)
    f = rng.integers(1, 5000, (n, lp - 1)) * (rng.random((n, lp - 1)) < 0.5)
    f[:, -1] += 1
    f = np.floor(f / f.sum(1, keepdims=True) * 65000).astype(np.int64)
    f[:, -1] += 65536 - f.sum(1)
    table = np.concatenate([np.zeros((n, 1), np.int64), f.cumsum(1)], 1) & 0xFFFF
    return torch.from_numpy(table)


@pytest.mark.parametrize("kind", ["random", "zerofreq", "last"])
@pytest.mark.parametrize("lp", [3, 5, 17])
def test_search_by_compares_equals_counting_search(lp, kind):
    """The decode kernel's branch-free search (max, min and count over the
    whole row) gives the counting search's s, lo and freq at every CDF
    entry of the row and one either side of it, and at 0 and 65535."""
    rng = np.random.default_rng(lp * 10 + len(kind))
    rows = _search_rows(kind, lp, rng)
    if kind == "zerofreq":
        freqs = (rows.roll(-1, 1) - rows)[:, :-1] & 0xFFFF
        assert (freqs == 0).any()
    slots = torch.cat([rows + d for d in (-1, 0, 1)]
                      + [torch.zeros_like(rows[:, :1]), rows[:, :1] * 0 + 0xFFFF], 1)
    for col in range(slots.shape[1]):
        slot = slots[:, col].clamp(0, 0xFFFF)
        s, lo, hi = rans.search_by_compares(rows, slot)
        want_s, want_lo, want_freq = _counting_search(rows, slot)
        assert torch.equal(s, want_s)
        assert torch.equal(lo, want_lo)
        assert torch.equal((hi - lo) & 0xFFFF, want_freq)


@pytest.mark.parametrize("cap,n_valid,encode,lp", [
    (16768, 16768, True, 17),  # 128 lanes x 131 steps: a ragged last slot
    (16768, 16768, False, 17),
    (16768, 12837, True, 3),  # n_valid mid-step
    (16768, 12837, False, 3),
    (163840, 158577, False, 17),  # the bench cloud's finest level, 16-way
    (16384, 0, True, 3),
    (16384, 0, False, 5),
    (256, 255, True, 17),  # 8 lanes
    (2048, 1999, False, 5),  # 16 lanes
])
def test_ring_walk_codes_each_position_once_in_walk_order(cap, n_valid,
                                                          encode, lp):
    """The kernels' ring replayed on the host: each lane's thread codes
    exactly the positions t*L + lane below n_valid, steps backwards on
    encode and forwards on decode; every copy starts and ends on 16 bytes
    and fits its slot; slots cycle, the consumers' parity flips each round,
    and the producer refills a slot only after the round that emptied it."""
    lanes = rans.lane_count(cap)
    chunk, slots, smem = rans.ring_plan(lanes, lp, encode)
    assert smem <= rans.SMEM_LIMIT
    chunks, positions = rans.ring_walk(cap, lanes, n_valid, lp, encode)
    steps = cap // lanes
    order = range(steps - 1, -1, -1) if encode else range(steps)
    for lane in range(lanes):
        want = [t * lanes + lane for t in order if t * lanes + lane < n_valid]
        assert positions[lane] == want
    assert sum(tn for *_, tn, _, _ in chunks) == -(-n_valid // lanes)
    for i, (slot, parity, refill_parity, t0, tn, offset, nbytes) in enumerate(chunks):
        assert slot == i % slots and parity == (i // slots) % 2
        assert refill_parity == (None if i < slots else chunks[i - slots][1])
        assert 1 <= tn <= chunk and t0 % chunk == 0
        assert offset % 16 == 0 and nbytes % 16 == 0
        assert nbytes <= chunk * lanes * lp * 4


def test_ring_plan_fits_every_stage_of_the_format():
    """Every lane count the format uses, at 3, 5 and 17 columns, gets at
    least 3 slots (encode) or 2 (decode) of shared memory within a block's
    limit, of at most 32 steps (decode's word ring holds 4 slots' words)."""
    for cap in (256, 1024, 2048, 4096, 8192, 16384):
        lanes = rans.lane_count(cap)
        for lp in (3, 5, 17):
            for encode in (True, False):
                chunk, slots, smem = rans.ring_plan(lanes, lp, encode)
                assert slots >= (3 if encode else 2) and smem <= rans.SMEM_LIMIT
                assert 1 <= chunk <= 32


def test_kernel_arguments_checked_before_launch():
    """What the kernels do not take raises before a launch: a lane count
    that is not a multiple of 4, and a table not on 16 bytes."""
    table = torch.zeros((64, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="lanes"):
        rans._on_card([table], ["table"], 6)
    flat = torch.zeros(64 * 3 + 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="16 bytes"):
        rans._on_card([flat[1:].view(64, 3)], ["table"], 8)
    assert rans._on_card([table], ["table"], 8) == table.device


def test_division_by_reciprocal_is_exact():
    """The encode kernel's division (a high multiply by (2^32 - 1) // freq
    and one correction) equals // and % for every freq in [1, 65535], at
    the states 2^16, (freq << 16) - 1, k freq - 1 and k freq for the
    largest k below 2^32, 2^32 - 1, and 1,000 seeded random states each."""
    rng = np.random.default_rng(0)
    for lo in range(1, 65536, 4096):
        freq = np.arange(lo, min(lo + 4096, 65536), dtype=np.uint64)
        k = np.uint64(rans.U32) // freq
        states = [np.full_like(freq, 1 << 16), (freq << np.uint64(16)) - np.uint64(1),
                  k * freq - np.uint64(1), k * freq, np.full_like(freq, rans.U32)]
        states += list(rng.integers(0, 1 << 32, (1000, freq.size), dtype=np.uint64))
        for x in states:
            q, r = rans.divide_by_reciprocal(x, freq)
            np.testing.assert_array_equal(q, x // freq)
            np.testing.assert_array_equal(r, x % freq)
