"""ctypes bindings for the native chunk-parallel arithmetic coder: the
port's copy of gauspcc_tpu/ops/coder.py over its own copy of the C++
source, `csrc/ac_coder.cpp`, built by `native.load_host` with the JAX
package's flags, so both write the same bytes on one machine.

The device computes the models; the coder runs on the host, on
`os.cpu_count() - 1` threads, one independent chunk of symbols at a time.
`encode_gauss` / `decode_gauss` evaluate the (mixture of) Gaussian CDF
inside the coder from per-symbol (mu, sigma[, w]), in residual units;
`encode_int16_cdf` / `decode_int16_cdf` take normalized uint16 CDF rows
(`core/cdf.py`). A stream is: u32 n_chunks, u32 chunk byte lengths, then
the chunks' payloads. `seconds` counts the wall time spent inside the
library's encode and decode calls.
"""

from __future__ import annotations

import ctypes
import os
import threading
import time

import numpy as np

from gauspcc_tpu_torch import native

# symbols per independent coder chunk (the JAX package's choice)
DEFAULT_CHUNK_SIZE = 65536

seconds = 0.0  # wall time inside the native encode/decode calls

_lock = threading.Lock()
_lib = None
_P = ctypes.c_void_p
_I32, _I64 = ctypes.c_int32, ctypes.c_int64


def _load():
    """The coder library, built on first use; every pointer is c_void_p."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = native.load_host("ac_coder").lib
        lib.ac_max_chunk_bytes.restype = _I64
        lib.ac_max_chunk_bytes.argtypes = [_I64]
        lib.ac_encode.restype = _I64
        lib.ac_encode.argtypes = [_P, _I64, _I32, _P, _I64, _I32, _P, _P]
        lib.ac_decode.restype = _I32
        lib.ac_decode.argtypes = [_P, _I64, _I32, _P, _P, _I64, _I32, _P]
        lib.ac_dec_create.restype = _P
        lib.ac_dec_create.argtypes = [_P, _I64, _P, _I64, _I64, _I64]
        lib.ac_dec_next.restype = _I64
        lib.ac_dec_next.argtypes = [_P, _P, _I32, _I64, _P]
        lib.ac_dec_free.restype = None
        lib.ac_dec_free.argtypes = [_P]
        lib.ac_encode_gauss.restype = _I64
        lib.ac_encode_gauss.argtypes = [_P, _P, _P, _I32, _I64, _I32, _I32,
                                        _P, _I64, _I32, _P, _P]
        lib.ac_decode_gauss.restype = _I32
        lib.ac_decode_gauss.argtypes = [_P, _P, _P, _I32, _I64, _I32, _I32,
                                        _P, _P, _I64, _I32, _P]
        _lib = lib
        return lib


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def _timed(fn, *args):
    global seconds
    t0 = time.perf_counter()
    try:
        return fn(*args)
    finally:
        seconds += time.perf_counter() - t0


def _n_threads() -> int:
    return max(1, (os.cpu_count() or 2) - 1)


def _frame(lib, chunk_size: int, n: int):
    """(n_chunks, per-chunk stride, output buffer, chunk lengths)."""
    n_chunks = (n + chunk_size - 1) // chunk_size
    stride = lib.ac_max_chunk_bytes(chunk_size)
    return (n_chunks, stride, np.empty(n_chunks * stride, dtype=np.uint8),
            np.zeros(n_chunks, dtype=np.int64))


def _pack(n_chunks: int, stride: int, out: np.ndarray,
          chunk_lens: np.ndarray) -> bytes:
    parts = [np.uint32(n_chunks).tobytes(), chunk_lens.astype(np.uint32).tobytes()]
    for c in range(n_chunks):
        s = c * stride
        parts.append(out[s : s + chunk_lens[c]].tobytes())
    return b"".join(parts)


def _unpack(stream: bytes, n_chunks: int):
    """(chunk lengths int64, contiguous payload) of a stream."""
    chunk_lens = np.frombuffer(stream[4 : 4 + 4 * n_chunks],
                               dtype=np.uint32).astype(np.int64)
    payload = np.ascontiguousarray(
        np.frombuffer(stream[4 + 4 * n_chunks :], dtype=np.uint8))
    return chunk_lens, payload


def _stored_chunks(stream: bytes) -> int:
    return int(np.frombuffer(stream[:4], dtype=np.uint32)[0])


class IncrementalDecoder:
    """Stateful sequential decoder over a stream written by
    encode_int16_cdf: feed CDF rows batch by batch (each batch's rows may
    depend on the symbols decoded before it)."""

    def __init__(self, stream: bytes, n_total: int,
                 chunk_size: int = DEFAULT_CHUNK_SIZE):
        self._lib = _load()
        self._handle = None
        n_chunks = _stored_chunks(stream)
        expect = (n_total + chunk_size - 1) // chunk_size
        if n_total > 0 and n_chunks != expect:
            raise ValueError(f"stream has {n_chunks} chunks, expected {expect}")
        self._chunk_lens, self._payload = _unpack(stream, n_chunks)
        self._handle = self._lib.ac_dec_create(
            _ptr(self._payload), self._payload.size, _ptr(self._chunk_lens),
            n_chunks, chunk_size, n_total)
        self._remaining = n_total

    def decode(self, cdf_u16: np.ndarray) -> np.ndarray:
        """Decode the next cdf_u16.shape[0] symbols."""
        cdf_u16 = np.ascontiguousarray(cdf_u16, dtype=np.uint16)
        count, lp = cdf_u16.shape
        if count > self._remaining:
            raise ValueError("decoding past end of stream")
        out = np.empty(count, dtype=np.int16)
        rc = _timed(self._lib.ac_dec_next, self._handle, _ptr(cdf_u16), lp,
                    count, _ptr(out))
        if rc != count:
            raise ValueError("incremental decode failed")
        self._remaining -= count
        return out

    def close(self):
        if self._handle:
            self._lib.ac_dec_free(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def encode_int16_cdf(cdf_u16: np.ndarray, symbols: np.ndarray,
                     chunk_size: int = DEFAULT_CHUNK_SIZE) -> bytes:
    """Encode `symbols[i]` under the normalized CDF row `cdf_u16[i]`. Empty
    input encodes to the 4-byte header alone."""
    lib = _load()
    cdf_u16 = np.ascontiguousarray(cdf_u16, dtype=np.uint16)
    symbols = np.ascontiguousarray(symbols, dtype=np.int16)
    if cdf_u16.ndim != 2 or symbols.ndim != 1 or symbols.shape[0] != cdf_u16.shape[0]:
        raise ValueError(f"cdf {cdf_u16.shape} and symbols {symbols.shape} "
                         f"do not match")
    n, lp = cdf_u16.shape
    if n == 0:
        return np.uint32(0).tobytes()
    n_chunks, stride, out, chunk_lens = _frame(lib, chunk_size, n)
    total = _timed(lib.ac_encode, _ptr(cdf_u16), n, lp, _ptr(symbols),
                   chunk_size, _n_threads(), _ptr(out), _ptr(chunk_lens))
    if total < 0:
        raise ValueError("ac_encode failed (bad arguments)")
    return _pack(n_chunks, stride, out, chunk_lens)


def decode_int16_cdf(cdf_u16: np.ndarray, stream: bytes,
                     chunk_size: int = DEFAULT_CHUNK_SIZE) -> np.ndarray:
    """Inverse of :func:`encode_int16_cdf`; returns int16 symbols [N]."""
    lib = _load()
    cdf_u16 = np.ascontiguousarray(cdf_u16, dtype=np.uint16)
    if cdf_u16.ndim != 2:
        raise ValueError(f"cdf must be [N, Lp], got {cdf_u16.shape}")
    n, lp = cdf_u16.shape
    if n == 0:
        return np.zeros(0, dtype=np.int16)
    n_chunks = (n + chunk_size - 1) // chunk_size
    stored = _stored_chunks(stream)
    if stored != n_chunks:
        raise ValueError(f"stream has {stored} chunks but N={n}, "
                         f"chunk_size={chunk_size} imply {n_chunks}")
    chunk_lens, payload = _unpack(stream, n_chunks)
    out_sym = np.empty(n, dtype=np.int16)
    rc = _timed(lib.ac_decode, _ptr(cdf_u16), n, lp, _ptr(payload),
                _ptr(chunk_lens), chunk_size, _n_threads(), _ptr(out_sym))
    if rc != 0:
        raise ValueError("ac_decode failed (bad arguments)")
    return out_sym


def _as_mix(mu, sigma, w, n: int):
    """[N] or [N, K] model arrays -> contiguous f32 [N, K] and K."""
    mu = np.ascontiguousarray(mu, dtype=np.float32).reshape(n, -1)
    k = mu.shape[1]
    sigma = np.ascontiguousarray(sigma, dtype=np.float32).reshape(n, k)
    if w is None:
        w = np.ones((n, k), np.float32)
    w = np.ascontiguousarray(w, dtype=np.float32).reshape(n, k)
    return mu, sigma, w, k


def encode_gauss(mu, sigma, symbols, rmin: int, rmax: int, w=None,
                 chunk_size: int = DEFAULT_CHUNK_SIZE) -> bytes:
    """Encode residual symbols under per-element Gaussian(-mixture) models
    evaluated inside the coder: mu/sigma in residual units, symbols[i] =
    residual - rmin in [0, rmax - rmin]. Framed as encode_int16_cdf."""
    lib = _load()
    symbols = np.ascontiguousarray(symbols, dtype=np.int16)
    n = symbols.shape[0]
    if n == 0:
        return np.uint32(0).tobytes()
    mu, sigma, w, k = _as_mix(mu, sigma, w, n)
    n_chunks, stride, out, chunk_lens = _frame(lib, chunk_size, n)
    total = _timed(lib.ac_encode_gauss, _ptr(mu), _ptr(sigma), _ptr(w), k, n,
                   rmin, rmax - rmin + 2, _ptr(symbols), chunk_size,
                   _n_threads(), _ptr(out), _ptr(chunk_lens))
    if total < 0:
        raise ValueError("ac_encode_gauss failed (bad arguments)")
    return _pack(n_chunks, stride, out, chunk_lens)


def decode_gauss(mu, sigma, stream: bytes, rmin: int, rmax: int, w=None,
                 chunk_size: int = DEFAULT_CHUNK_SIZE) -> np.ndarray:
    """Inverse of :func:`encode_gauss`; returns int16 symbols [N]."""
    lib = _load()
    mu_arr = np.asarray(mu)
    n = mu_arr.shape[0]
    if n == 0:
        return np.zeros(0, dtype=np.int16)
    mu, sigma, w, k = _as_mix(mu, sigma, w, n)
    n_chunks = (n + chunk_size - 1) // chunk_size
    stored = _stored_chunks(stream)
    if stored != n_chunks:
        raise ValueError(f"stream has {stored} chunks but N={n} implies "
                         f"{n_chunks}")
    chunk_lens, payload = _unpack(stream, n_chunks)
    out_sym = np.empty(n, dtype=np.int16)
    rc = _timed(lib.ac_decode_gauss, _ptr(mu), _ptr(sigma), _ptr(w), k, n,
                rmin, rmax - rmin + 2, _ptr(payload), _ptr(chunk_lens),
                chunk_size, _n_threads(), _ptr(out_sym))
    if rc != 0:
        raise ValueError("ac_decode_gauss failed (bad arguments)")
    return out_sym
