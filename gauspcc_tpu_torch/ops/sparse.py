"""Sparse voxel ops of the codec: the port's counterpart of
gauspcc_tpu/ops/sparse.py.

The occupancy pyramid (host, numpy; `lex_key_np` .. `build_occupancy_pyramid`
:42-130): voxels are ordered lexicographically with z most significant. A
parent is child >> 1; its occupancy byte ORs 2^(x%2 + 2*(y%2) + 4*(z%2))
over its children (GausPcgc/kit/nn.py:25-55).

The general submanifold sparse conv and its geometry (torch, on the
codec's device; `lex_sort` :58, `fcg_expand` :143, `NeighborMap` :180
(`kernel_offsets` :173 is `hostmap.kernel_offsets`), `nmap_from_host`
:192, `WindowMap` / `PackedLo` / `pack_lo_np` :197-253, `expand_lo` :257,
`nmap_from_packed` :266, `sparse_conv_window` :283, `build_neighbor_map`
:335, `sparse_conv_apply` :441; `sorted_children` is the codec's
`_device_children`, gauspcc_tpu/codecs/gauspcgc/codec.py:526). Every
function takes fixed-capacity tensors and a validity mask, so what it
launches depends only on the capacities, and nothing reads a value back to
the host: the device-built geometry (codec version 7) runs a whole pyramid
without a synchronisation.

`sparse_conv_apply` gathers K^3 taps in groups of 8 and takes one
[Nq, g*Cin] x [g*Cin, Cout] `torch.matmul` a group, in float32 on the
features' values (the JAX package's bf16 products accumulated in float32,
`preferred_element_type`), adds the float32 bias and casts to the
features' dtype. Its backward has no scatter: a submanifold self-map is
symmetric, idx[t, q] = s exactly when idx[K^3-1-t, s] = q, so dX is the
same conv of dY over the same map with the taps mirrored and each tap's
weight transposed, and dW[t] is the gathered input, transposed, times dY.
It saves the input and the map, never the gathered buffer (JAX
rematerialises it under `jax.checkpoint`, model.py:149-170). The products
stay library calls, as the JAX package leaves them to XLA; a gather fused
into the product by hand is ROADMAP Queue 2 part B's K9.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gauspcc_tpu_torch.ops import hostmap

_I32_MAX = 2**31 - 1
_I64_MAX = 2**63 - 1


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


# ---------------------------------------------------------------------------
# device geometry: lex sort, child expansion, neighbor maps
# ---------------------------------------------------------------------------

def lex_sort(coords: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Permutation (int64) putting the valid coords [N, 3] in (z, y, x) lex
    order, padding last in its original order: three stable sorts, x then
    y then z, as `jnp.lexsort` orders them."""
    z, y, x = (torch.where(mask, coords[:, a].to(torch.int64), _I32_MAX)
               for a in (2, 1, 0))
    perm = torch.argsort(x, stable=True)
    perm = perm[torch.argsort(y[perm], stable=True)]
    return perm[torch.argsort(z[perm], stable=True)]


def _octant_offsets(device) -> torch.Tensor:
    """[8, 3] int32 (dx, dy, dz) of octant o = dx + 2 dy + 4 dz, made on the
    device (no copy from the host)."""
    o = torch.arange(8, device=device, dtype=torch.int32)
    return torch.stack([o & 1, (o >> 1) & 1, (o >> 2) & 1], dim=1)


def fcg_expand(coords: torch.Tensor, occ: torch.Tensor, mask: torch.Tensor):
    """Expand parents to their occupied children.

    coords int [N, 3], occ int [N] (0..255), mask bool [N] -> child coords
    int32 [N*8, 3], child mask [N*8], octant int32 [N*8], parent index
    int32 [N*8]. The children of parent i are rows 8i..8i+7 in octant
    order; callers lex-sort them afterwards."""
    n = coords.shape[0]
    dev = coords.device
    child = coords.to(torch.int32)[:, None, :] * 2 + _octant_offsets(dev)[None]
    octant = torch.arange(8, device=dev, dtype=torch.int32).expand(n, 8)
    bits = (occ.to(torch.int32)[:, None] >> octant) & 1
    child_mask = (bits == 1) & mask[:, None]
    parent_index = torch.arange(n, device=dev, dtype=torch.int32)[:, None].expand(n, 8)
    return (child.reshape(-1, 3), child_mask.reshape(-1),
            octant.reshape(-1), parent_index.reshape(-1))


def sorted_children(coords: torch.Tensor, occ: torch.Tensor,
                    mask: torch.Tensor, cap: int):
    """The occupied children of padded lex-sorted parents, lex-sorted
    (valid first) and cut to `cap` rows, on the parents' device with static
    shapes: the host geometry's order, without reading anything back.
    -> (child coords, child mask, octant, parent index)."""
    child, cm, octant, pidx = fcg_expand(coords, occ, mask)
    perm = lex_sort(child, cm)[:cap]
    return child[perm], cm[perm], octant[perm], pidx[perm]


class NeighborMap:
    """Gather table of a submanifold conv: idx int32 [K^3, Nq], the source
    row at each tap, 0 where invalid; valid bool [K^3, Nq]. The conv's
    gather rows (`group_rows`) are built on first use and kept with it."""

    __slots__ = ("idx", "valid", "_rows")

    def __init__(self, idx: torch.Tensor, valid: torch.Tensor):
        self.idx = idx
        self.valid = valid
        self._rows = None

    def group_rows(self, ns: int, g: int) -> torch.Tensor:
        """[n_groups, Nq * g] int32: for each group of g taps (the last
        padded with absent taps), the rows of a gather into the ns source
        rows followed by one zero row, query-major, so the gather of a
        group reshapes to [Nq, g * Cin] as it lies. An absent tap reads
        the zero row."""
        if self._rows is None or self._rows[:2] != (ns, g):
            k3, nq = self.idx.shape
            n_groups = -(-k3 // g)
            rows = torch.full((n_groups * g, nq), ns, dtype=torch.int32,
                              device=self.idx.device)
            rows[:k3] = torch.where(self.valid, self.idx.to(torch.int32), ns)
            rows = rows.view(n_groups, g, nq).transpose(1, 2).reshape(n_groups, -1)
            self._rows = (ns, g, rows)
        return self._rows[2]


def nmap_from_host(idx: torch.Tensor) -> NeighborMap:
    """A host-built gather table (ops/hostmap.py; -1 = no neighbor)."""
    return NeighborMap(idx.clamp_min(0), idx >= 0)


class WindowMap(NamedTuple):
    """Packed neighbor map (ops/hostmap.py `build_map_packed`): per (dz, dy)
    kernel row, lo int32 [K^2, Nq], the start of the window of consecutive
    lex-sorted sources, and codes int32 [K^2, Nq] (uint16 payload), a 3-bit
    window slot per x-offset bin (7 = no neighbor); tap index = lo + slot."""

    lo: torch.Tensor
    codes: torch.Tensor


B_LO = 64  # queries per lo base block


class PackedLo(NamedTuple):
    """Upload form of WindowMap.lo: per row, an int32 base per B_LO queries
    and u8 offsets from it; an offset outside [0, 254] escapes to 255 and
    its value rides in the exception list (padded to a power of two >= 16
    with the out-of-range position K^2 * nb * B_LO)."""

    base: torch.Tensor  # int32 [K2, nb]
    off: torch.Tensor  # uint8 [K2, nb * B_LO]
    exc_pos: torch.Tensor  # int32 [E]
    exc_val: torch.Tensor  # int32 [E]


def pack_lo_np(lo: np.ndarray):
    """Host side: lo int32 [K2, cap] -> (base, off_u8, exc_pos, exc_val),
    as gauspcc_tpu/ops/sparse.py:234 packs it."""
    k2, cap = lo.shape
    nb = (cap + B_LO - 1) // B_LO
    lp = np.pad(lo, ((0, 0), (0, nb * B_LO - cap)), mode="edge")
    base = np.ascontiguousarray(lp[:, ::B_LO])
    off = lp - np.repeat(base, B_LO, axis=1)
    exc = (off > 254) | (off < 0)
    exc_pos = np.nonzero(exc.reshape(-1))[0].astype(np.int32)
    exc_val = lp.reshape(-1)[exc_pos].astype(np.int32)
    off_u8 = np.where(exc, 255, off).astype(np.uint8)
    ecap = 16
    while ecap < exc_pos.shape[0]:
        ecap *= 2
    oob = np.int32(k2 * nb * B_LO)
    exc_pos = np.pad(exc_pos, (0, ecap - exc_pos.shape[0]), constant_values=oob)
    exc_val = np.pad(exc_val, (0, ecap - exc_val.shape[0]))
    return base, off_u8, exc_pos, exc_val


def expand_lo(packed: PackedLo, cap: int) -> torch.Tensor:
    """Device side: lo int32 [K2, cap] exactly. The exception list's
    padding points one past the end; it writes into a spare slot that is
    then dropped (JAX drops it with mode="drop")."""
    k2, nb = packed.base.shape
    lo = (packed.base.repeat_interleave(B_LO, dim=1)
          + packed.off.to(torch.int32)).reshape(-1)
    lo = torch.cat([lo, lo.new_zeros(1)])
    lo[packed.exc_pos.to(torch.int64)] = packed.exc_val.to(torch.int32)
    return lo[:-1].reshape(k2, nb * B_LO)[:, :cap]


def nmap_from_packed(wmap: WindowMap, kernel_size: int) -> NeighborMap:
    """The dense gather table a packed window map expands to, on its device."""
    k = kernel_size
    if wmap.lo.shape[0] != k * k:
        raise ValueError(f"a window map of {wmap.lo.shape[0]} kernel rows "
                         f"does not serve a kernel of size {k}")
    shifts = 3 * torch.arange(k, device=wmap.codes.device, dtype=torch.int32)
    slots = (wmap.codes.to(torch.int32)[:, None, :] >> shifts[None, :, None]) & 7
    valid = slots < k  # [K2, k (dx bin), Nq]
    idx = wmap.lo[:, None, :] + torch.where(valid, slots, 0)
    nq = wmap.lo.shape[1]
    return NeighborMap(idx.reshape(k**3, nq), valid.reshape(k**3, nq))


def build_neighbor_map(coords_q: torch.Tensor, mask_q: torch.Tensor,
                       coords_s: torch.Tensor, mask_s: torch.Tensor,
                       kernel_size: int) -> NeighborMap:
    """Neighbor map of valid queries into valid sources, on their device:
    idx[t, q] is the (unsorted) row of the source at q + offset t.

    The sources are lex-sorted and keyed by `hostmap.key3` after a shift by
    the smallest valid coordinate less the radius, so every probe is a
    non-negative key; each tap is one `searchsorted` over the sorted keys.
    Equal to the JAX package's binary search over packed (y, x) lanes,
    padding included, for coordinates spanning less than
    `hostmap.MAX_COORD` on each axis."""
    k = kernel_size
    r = k // 2
    dev = coords_q.device
    nq, ns = coords_q.shape[0], coords_s.shape[0]
    order = lex_sort(coords_s, mask_s)
    cs = coords_s.to(torch.int64)[order]
    ms = mask_s[order]
    cq = coords_q.to(torch.int64)
    lo_s = torch.where(mask_s[:, None], coords_s.to(torch.int64), _I32_MAX).amin(0)
    lo_q = torch.where(mask_q[:, None], cq, _I32_MAX).amin(0)
    shift = torch.minimum(lo_s, lo_q) - r
    skeys = torch.where(ms, hostmap.key3(cs - shift), _I64_MAX)
    offs = hostmap.kernel_offsets(k, dev)
    base = cq - shift
    idx = torch.empty((k**3, nq), dtype=torch.int32, device=dev)
    valid = torch.empty((k**3, nq), dtype=torch.bool, device=dev)
    k2 = k * k
    for dz in range(k):  # one plane of k^2 taps at a time bounds the buffers
        taps = slice(dz * k2, (dz + 1) * k2)
        probe = hostmap.key3((base[None] + offs[taps, None, :]).reshape(-1, 3))
        probe = probe.view(k2, nq)
        pos = torch.searchsorted(skeys, probe).clamp_max(max(ns - 1, 0))
        hit = (skeys[pos] == probe) & mask_q[None, :]
        idx[taps] = torch.where(hit, order[pos], 0).to(torch.int32)
        valid[taps] = hit
    return NeighborMap(idx, valid)


# ---------------------------------------------------------------------------
# the general submanifold sparse conv
# ---------------------------------------------------------------------------

GROUP = 8  # taps a group
GATHER_BUDGET = 64 * 1024 * 1024  # elements of one group's gathered buffer


def group_size(nq: int, cin: int) -> int:
    """Taps a group: GROUP, shrunk so one gathered [Nq, g*Cin] buffer
    stays under GATHER_BUDGET elements (both sides of a codec know Nq)."""
    return max(1, min(GROUP, GATHER_BUDGET // max(nq * cin, 1)))


def _gather_products(x: torch.Tensor, rows: torch.Tensor,
                     w: torch.Tensor) -> torch.Tensor:
    """float32 [Nq, Cout] = sum over groups of gather(x, rows[i]) @ w[i].

    x float32 [Ns, Cin]; rows [n_groups, Nq * g] (`group_rows`, row Ns
    reads zeros); w float32 [n_groups, g * Cin, Cout]."""
    x2 = torch.cat([x, x.new_zeros((1, x.shape[1]))])
    nq = rows.shape[1] // (w.shape[1] // x.shape[1])
    acc = None
    for i in range(rows.shape[0]):
        xg = x2.index_select(0, rows[i]).view(nq, -1)
        acc = torch.mm(xg, w[i]) if acc is None else acc.addmm_(xg, w[i])
    return acc


def _grouped(w: torch.Tensor, g: int) -> torch.Tensor:
    """w [K3, Cin, Cout] -> [n_groups, g * Cin, Cout], zero taps appended."""
    k3, cin, cout = w.shape
    n_groups = -(-k3 // g)
    pad = w.new_zeros((n_groups * g - k3, cin, cout))
    return torch.cat([w, pad]).reshape(n_groups, g * cin, cout)


class _SparseConv(torch.autograd.Function):
    """y = the submanifold conv of x over nmap with w [K3, Cin, Cout] and b;
    saves x, w and the map (not the gathered buffers)."""

    @staticmethod
    def forward(ctx, x, w, b, nmap):
        k3, cin, cout = w.shape
        nq = nmap.idx.shape[1]
        g = group_size(nq, cin)
        wc = w.to(x.dtype).to(torch.float32)  # the features' values, exactly
        out = _gather_products(x.to(torch.float32),
                               nmap.group_rows(x.shape[0], g), _grouped(wc, g))
        if b is not None:
            out = out + b.to(torch.float32)
        ctx.save_for_backward(x, w)
        ctx.nmap, ctx.g, ctx.has_bias = nmap, g, b is not None
        return out.to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        nmap, g = ctx.nmap, ctx.g
        k3, cin, cout = w.shape
        nq = nmap.idx.shape[1]
        rows = nmap.group_rows(x.shape[0], g)
        dy = dy.to(x.dtype).to(torch.float32)
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            if x.shape[0] != nq:
                raise ValueError("the scatter-free backward needs a "
                                 "submanifold self-map (as many queries as "
                                 f"sources), not {nq} queries of {x.shape[0]}")
            # the mirrored taps, each weight transposed: [K3, Cout, Cin]
            wback = w.to(x.dtype).to(torch.float32).flip(0).transpose(1, 2)
            dx = _gather_products(dy, rows, _grouped(wback, g)).to(x.dtype)
        if ctx.needs_input_grad[1]:
            x2 = torch.cat([x.to(torch.float32), x.new_zeros((1, cin), dtype=torch.float32)])
            parts = [torch.mm(x2.index_select(0, rows[i]).view(nq, -1).T, dy)
                     for i in range(rows.shape[0])]
            dw = torch.cat(parts).view(-1, cin, cout)[:k3].to(w.dtype)
        if ctx.has_bias and ctx.needs_input_grad[2]:
            db = dy.sum(0)
        return dx, dw, db, None


def sparse_conv_apply(feats: torch.Tensor, nmap: NeighborMap,
                      weight: torch.Tensor, bias: torch.Tensor | None = None
                      ) -> torch.Tensor:
    """Submanifold sparse conv of feats [Ns, Cin] over a prebuilt map:
    weight [K3, Cin, Cout], bias [Cout] -> [Nq, Cout] in feats.dtype.
    Differentiable in feats (for a self-map), weight and bias."""
    if nmap.idx.shape[0] != weight.shape[0]:
        raise ValueError(f"a map of {nmap.idx.shape[0]} taps does not serve "
                         f"a weight of {weight.shape[0]} taps")
    return _SparseConv.apply(feats, weight, bias, nmap)


def sparse_conv_window(feats: torch.Tensor, wmap: WindowMap,
                       weight: torch.Tensor, bias: torch.Tensor | None = None
                       ) -> torch.Tensor:
    """Submanifold sparse conv of feats [Ns, Cin] over a packed window map
    (gauspcc_tpu/ops/sparse.py:283): weight [K3, Cin, Cout], bias [Cout] ->
    [Nq, Cout] in feats.dtype, equal to `sparse_conv_apply` over the dense
    map the codes expand to (`nmap_from_packed`).

    Per (dz, dy) kernel row it gathers the k-row window of consecutive
    sources at lo + [0, k) (clipped to the sources), aligns the window's
    slots to the x-offset bins by the 3-bit codes (absent bins read zeros)
    and takes one [Nq, k Cin] x [k Cin, Cout] product on the features'
    values in float32. Nothing in either package's codec calls it."""
    k3, cin, cout = weight.shape
    k = round(k3 ** (1 / 3))
    if k**3 != k3:
        raise ValueError(f"a weight of {k3} taps is not a cube")
    if wmap.lo.shape[0] != k * k:
        raise ValueError(f"a window map of {wmap.lo.shape[0]} kernel rows "
                         f"does not serve a kernel of size {k}")
    nq, ns = wmap.lo.shape[1], feats.shape[0]
    w = weight.to(feats.dtype).to(torch.float32).reshape(k * k, k * cin, cout)
    x = feats.to(torch.float32)
    shifts = 3 * torch.arange(k, device=wmap.codes.device, dtype=torch.int32)
    out = torch.zeros((nq, cout), dtype=torch.float32, device=feats.device)
    for r in range(k * k):
        slots = (wmap.codes[r].to(torch.int32)[:, None] >> shifts[None, :]) & 7
        hit = slots < k  # [Nq, k (dx bin)]
        rows = torch.clamp(wmap.lo[r][:, None] + torch.where(hit, slots, 0),
                           0, ns - 1).to(torch.int64)
        aligned = torch.where(hit[..., None], x[rows], 0.0)  # [Nq, k, Cin]
        out = out + aligned.reshape(nq, k * cin) @ w[r]
    if bias is not None:
        out = out + bias.to(torch.float32)
    return out.to(feats.dtype)
