"""Voxel geometry of the codec: the port's counterpart of
gauspcc_tpu/ops/hostmap.py (`expand_children` :76, `build_map` :103,
`build_map_packed` :126), which calls the native geometry code
gauspcc_tpu/native/neighbor.cpp.

Each voxel is packed into one int64 key as neighbor.cpp's `key3` does
(:33-36): z most significant, 21 bits an axis, each coordinate biased by 8
so that probes a few voxels below 0 stay ordered. Lex order of
coordinates is the order of their keys, so a sort of keys is a lex sort
and a neighbor lookup is a `searchsorted` over the sorted keys. The
outputs equal the native code's exactly, padding included; the work is
integer sorting and searching, exact on any device, so the sib engine's
geometry needs no upload.

`build_map_packed` is the host-built geometry of the general conv (codec
version 6): the port's copy of the native packed-map code,
`csrc/neighbor.cpp`, built at first use by `native.load_host` (a failed
build raises with g++'s output) and bound with ctypes.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np
import torch

from gauspcc_tpu_torch import native

KEY_BITS = 21
KEY_BIAS = 8
_KEY_MASK = (1 << KEY_BITS) - 1
# coordinates a key holds with room for the probes of a k <= 5 map and the
# children of every voxel (neighbor.cpp: valid for coords < 2^20)
MAX_COORD = 1 << 20
# octant o = (x&1) + 2*(y&1) + 4*(z&1) -> offset (x, y, z)
OCTANT_OFFSETS = [[o & 1, (o >> 1) & 1, (o >> 2) & 1] for o in range(8)]


def key3(coords: torch.Tensor) -> torch.Tensor:
    """int64 keys of int coords [N, 3] (x, y, z); coords + 8 < 2^21."""
    c = coords.to(torch.int64) + KEY_BIAS
    return (c[:, 2] << (2 * KEY_BITS)) | (c[:, 1] << KEY_BITS) | c[:, 0]


def unkey3(keys: torch.Tensor) -> torch.Tensor:
    """int64 coords [N, 3] of `key3` keys."""
    return torch.stack([keys & _KEY_MASK, (keys >> KEY_BITS) & _KEY_MASK,
                        keys >> (2 * KEY_BITS)], dim=1) - KEY_BIAS


def dedupe(coords: torch.Tensor) -> torch.Tensor:
    """Unique rows of int coords [N, 3], lex-sorted (int64): the device
    form of `sparse.dedupe_lex`."""
    return unkey3(torch.unique(key3(coords), sorted=True))


def expand_children(pcoords: torch.Tensor, pocc: torch.Tensor, ccap: int):
    """Occupied children of lex-sorted parents, lex-sorted, padded to ccap.

    pcoords int [Np, 3] valid parents (not padded); pocc int [Np] (0..255).
    Returns (ccoords int32 [ccap, 3] (0 pad), octant int32 [ccap] (0 pad),
    parent_idx int32 [ccap] (-1 pad), n_children). Children of lex-sorted
    parents are not lex-sorted as expanded (the z = 1 child of parent
    (0, 0, 0) comes after the z = 0 child of parent (1, 0, 0)), so they are
    sorted by key, as the native code's 8-way merge orders them."""
    dev = pcoords.device
    np_ = pcoords.shape[0]
    octs = torch.arange(8, device=dev)
    occupied = ((pocc.to(torch.int64)[:, None] >> octs[None, :]) & 1).bool()
    offs = torch.tensor(OCTANT_OFFSETS, dtype=torch.int64, device=dev)
    child = 2 * pcoords.to(torch.int64)[:, None, :] + offs[None, :, :]
    child = child[occupied]  # [n, 3], parent-major
    octant = octs.expand(np_, 8)[occupied]
    parent = torch.arange(np_, device=dev)[:, None].expand(np_, 8)[occupied]
    n = child.shape[0]
    if n > ccap:
        raise ValueError(f"child capacity {ccap} overflow for {np_} parents")
    order = torch.argsort(key3(child))  # keys are unique
    ccoords = torch.zeros((ccap, 3), dtype=torch.int32, device=dev)
    ccoords[:n] = child[order].to(torch.int32)
    oct_out = torch.zeros(ccap, dtype=torch.int32, device=dev)
    oct_out[:n] = octant[order].to(torch.int32)
    pidx = torch.full((ccap,), -1, dtype=torch.int32, device=dev)
    pidx[:n] = parent[order].to(torch.int32)
    return ccoords, oct_out, pidx, n


def kernel_offsets(kernel_size: int, device="cpu") -> torch.Tensor:
    """[K^3, 3] int64 offsets (dx, dy, dz) in tap order t = ((dz+r)*k +
    (dy+r))*k + (dx+r), x fastest (neighbor.cpp:17), made on `device` (no
    copy from the host)."""
    r = torch.arange(kernel_size, device=device) - kernel_size // 2
    zz, yy, xx = torch.meshgrid(r, r, r, indexing="ij")
    return torch.stack([xx, yy, zz], dim=-1).reshape(-1, 3)


def build_map(coords: torch.Tensor, n_valid: int, kernel_size: int,
              ncap: int | None = None) -> torch.Tensor:
    """Neighbor gather table of a submanifold conv.

    coords int [>= n_valid, 3], the valid prefix lex-sorted, unique and
    non-negative. Returns idx int32 [K^3, ncap]: the row of the voxel at
    each tap's offset, -1 where there is none (and on padded queries)."""
    dev = coords.device
    if ncap is None:
        ncap = coords.shape[0]
    if ncap < n_valid:
        raise ValueError(f"map capacity {ncap} below {n_valid} voxels")
    k3 = kernel_size**3
    out = torch.full((k3, ncap), -1, dtype=torch.int32, device=dev)
    if n_valid == 0:
        return out
    c = coords[:n_valid].to(torch.int64)
    keys = key3(c)
    offs = kernel_offsets(kernel_size, dev)
    for t in range(k3):
        probe = key3(c + offs[t])
        at = torch.searchsorted(keys, probe).clamp_max(n_valid - 1)
        out[t, :n_valid] = torch.where(keys[at] == probe, at, -1).to(torch.int32)
    return out


_lock = threading.Lock()
_lib = None


def _load():
    """The packed-map library, built on first use; argtypes set."""
    global _lib
    with _lock:
        if _lib is None:
            lib = native.load_host("neighbor").lib
            p = ctypes.c_void_p
            lib.nm_build_packed.restype = ctypes.c_int64
            lib.nm_build_packed.argtypes = [p, ctypes.c_int64, ctypes.c_int64,
                                            ctypes.c_int32, ctypes.c_int32, p, p]
            _lib = lib
        return _lib


def build_map_packed(coords: np.ndarray, n_valid: int, kernel_size: int,
                     ncap: int | None = None):
    """Packed window map of a submanifold conv, on the host: (lo int32
    [K^2, ncap], codes uint16 [K^2, ncap]). Per (dz, dy) kernel row, lo is
    the start of the window of lex-sorted sources and codes hold a 3-bit
    window slot per x-offset bin (7 = no neighbor); tap index = lo + slot.
    coords int [>= n_valid, 3], the valid prefix lex-sorted, unique and
    non-negative; kernel_size <= 5."""
    lib = _load()
    coords = np.ascontiguousarray(coords, dtype=np.int32)
    if ncap is None:
        ncap = coords.shape[0]
    k2 = kernel_size**2
    lo = np.empty((k2, ncap), np.int32)
    codes = np.empty((k2, ncap), np.uint16)
    rc = lib.nm_build_packed(coords.ctypes.data, n_valid, ncap, kernel_size,
                             max(1, (os.cpu_count() or 2) - 1),
                             lo.ctypes.data, codes.ctypes.data)
    if rc != 0:
        raise ValueError(f"nm_build_packed refused its arguments (n {n_valid}, "
                         f"capacity {ncap}, kernel {kernel_size})")
    return lo, codes
