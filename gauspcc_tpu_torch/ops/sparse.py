"""The occupancy pyramid of a voxel cloud (host, numpy): the port's copy of
gauspcc_tpu/ops/sparse.py:42-135 (`lex_key_np`, `morton_order_np`,
`dedupe_lex_np`, `build_occupancy_pyramid`).

Voxels are ordered lexicographically with z most significant. A parent is
child >> 1; its occupancy byte ORs 2^(x%2 + 2*(y%2) + 4*(z%2)) over its
children (GausPcgc/kit/nn.py:25-55).
"""

from __future__ import annotations

import numpy as np


def lex_key(coords: np.ndarray, dims) -> np.ndarray:
    """int64 key, z most significant: ((z*Y + y)*X + x)."""
    c = coords.astype(np.int64)
    return (c[:, 2] * int(dims[1]) + c[:, 1]) * int(dims[0]) + c[:, 0]


def morton_order_np(xyz: np.ndarray) -> np.ndarray:
    """The order HAC codes its anchors in (the reference's
    calculate_morton_order, despite the name a lexicographic one): shift to
    the minimum, then a stable argsort of x + y (M + 1) + z (M + 1)^2 with M
    the largest shifted coordinate."""
    x = np.asarray(xyz).astype(np.int64)
    x = x - x.min(axis=0, keepdims=True)
    m = int(x.max()) + 1
    key = x @ np.power(m, np.arange(3, dtype=np.int64))
    return np.argsort(key, kind="stable")


def dedupe_lex(coords: np.ndarray) -> np.ndarray:
    """Unique rows of a non-negative int [N, 3] array in (z, y, x) lex
    order (int64)."""
    cur = np.asarray(coords).astype(np.int64)
    if cur.shape[0] <= 1:
        return cur
    key = lex_key(cur, cur.max(axis=0) + 1)
    order = np.argsort(key)
    cur, key = cur[order], key[order]
    keep = np.empty(cur.shape[0], bool)
    keep[0] = True
    np.not_equal(key[1:], key[:-1], out=keep[1:])
    return cur[keep]


def build_occupancy_pyramid(coords: np.ndarray, min_points: int = 64,
                            sorted_unique: bool = False):
    """Dyadic downscale until fewer than `min_points` parents remain.

    coords: non-negative int [N, 3] (pass sorted_unique=True when already
    deduped by `dedupe_lex`). Returns the levels coarse to fine: a list of
    (parent coords int32 [Ni, 3], occupancy uint8 [Ni]), each lex-sorted;
    the finest level's children are the input."""
    coords = np.asarray(coords)
    if coords.ndim != 2 or coords.shape[1] != 3 or coords.shape[0] == 0:
        raise ValueError(f"expected int coords [N, 3], got {coords.shape}")
    if coords.min() < 0:
        raise ValueError("shift coordinates to be non-negative first")
    cur = coords.astype(np.int64) if sorted_unique else dedupe_lex(coords)
    levels = []
    while True:
        parent = cur >> 1
        octant = (cur[:, 0] & 1) + 2 * (cur[:, 1] & 1) + 4 * (cur[:, 2] & 1)
        dims = parent.max(axis=0) + 1
        pkey = lex_key(parent, (dims[0], dims[1]))
        order = np.argsort(pkey, kind="stable")
        pkey = pkey[order]
        flags = np.empty(pkey.shape[0], bool)
        flags[0] = True
        np.not_equal(pkey[1:], pkey[:-1], out=flags[1:])
        starts = np.flatnonzero(flags)
        bits = (1 << octant).astype(np.uint8)[order]
        occ = np.bitwise_or.reduceat(bits, starts)
        pcoords = parent[order[starts]].astype(np.int32)
        levels.append((pcoords, occ))
        cur = pcoords.astype(np.int64)
        if cur.shape[0] < min_points or cur.shape[0] <= 1:
            break
    return levels[::-1]
