"""Sibling-packed submanifold sparse conv and its gradient: the port's
counterpart of gauspcc_tpu/ops/sibconv.py (`sib_pos_np` :38, `tap_table`
:55, `_wmat` :82, `_core` / `_core_fwd` / `_core_bwd` :97-141,
`sibconv_apply` :143).

Voxels are packed by parent cell into groups of 8 octant slots (x [G*8,
C], empty slots zero). A voxel's k <= 5 neighborhood lies in the 27
parent cells around its own, which all 8 siblings share, so the conv is a
gather of 27 group rows of 8C values per group and one [G, 216C] x [216C,
8C] matrix product against a weight matrix assembled from w [k^3, Cin,
Cout] by a constant tap table.

The product is `torch.matmul`, a library call, as the JAX package leaves
it to XLA; a gather fused into the product by hand is ROADMAP Queue 2 K4.
In bf16 the product accumulates in float32 and rounds once to bf16
(`preferred_element_type=f32` then a cast, in JAX); the codec runs it
with cuBLAS's reduced-precision bf16 reductions off (codec.py). The bias
is added in the feature dtype, as in JAX.

The backward is scatter-free, as JAX's: the transpose of the gather over
a group map is a gather of the upstream gradient over the flipped map
(group h receives from g = h + flip(e)), times the per-e transposed conv
matrix; the conv matrix's gradient is one product of the re-gathered
input with the upstream gradient (the [G, 216C] buffer is gathered again,
not kept); w's gradient sums, for each tap, the 8 blocks it fills (one
per octant) in a fixed order, so no atomics make it vary from run to run.
The rounding points are JAX's: the upstream gradient cast to x's dtype,
both products accumulated in float32 and rounded to x's and the conv
matrix's dtype, the tap sum in the conv matrix's dtype.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
from torch import nn

from gauspcc_tpu_torch.ops import hostmap


def sib_pos(coords: torch.Tensor, groups: torch.Tensor) -> torch.Tensor:
    """Packed row (group_row * 8 + octant) of each voxel (int64).

    coords int [N, 3] lex-sorted; groups int [G, 3] lex-sorted unique,
    covering every coords >> 1."""
    c = coords.to(torch.int64)
    gidx = torch.searchsorted(hostmap.key3(groups), hostmap.key3(c >> 1))
    oct_ = (c[:, 0] & 1) + 2 * (c[:, 1] & 1) + 4 * (c[:, 2] & 1)
    return gidx * 8 + oct_


@lru_cache(maxsize=8)
def tap_table(kernel_size: int) -> np.ndarray:
    """TIDX [27, 8, 8] int32: TIDX[e, s, o] = the kernel tap that reaches
    (neighbor group e, sibling slot s) from an output voxel of octant o,
    or -1. Tap t = ((dz+r)*k + (dy+r))*k + (dx+r); octant o = (x&1) +
    2*(y&1) + 4*(z&1); group e = ((ez+1)*3 + (ey+1))*3 + (ex+1)."""
    k = kernel_size
    r = k // 2
    assert k <= 5, "sibling packing assumes kernel radius <= 2 (27 groups)"
    tidx = np.full((27, 8, 8), -1, np.int32)
    for o in range(8):
        ob = (o & 1, (o >> 1) & 1, (o >> 2) & 1)
        for t in range(k**3):
            d = (t % k - r, (t // k) % k - r, t // (k * k) - r)
            ex, ey, ez = ((ob[i] + d[i]) >> 1 for i in range(3))
            sx, sy, sz = ((ob[i] + d[i]) & 1 for i in range(3))
            e = ((ez + 1) * 3 + (ey + 1)) * 3 + (ex + 1)
            s = sx + 2 * sy + 4 * sz
            assert tidx[e, s, o] == -1
            tidx[e, s, o] = t
    return tidx


def wmat(w: torch.Tensor, kernel_size: int, dtype: torch.dtype) -> torch.Tensor:
    """The conv matrix [27*8*Cin, 8*Cout] from w [k^3, Cin, Cout]: rows
    (e, s, cin), as the gathered input; columns (o, cout). Differentiable
    in w (`_WMat`)."""
    return _WMat.apply(w, kernel_size, dtype)


@lru_cache(maxsize=16)
def _device_tables(kernel_size: int, device: torch.device):
    """`tap_table` and `tap_blocks` on `device`, copied there once (a copy
    from the host per conv would make the host wait each time)."""
    return (torch.as_tensor(tap_table(kernel_size), dtype=torch.int64,
                            device=device),
            torch.as_tensor(tap_blocks(kernel_size), device=device).reshape(-1))


def _build_wmat(w: torch.Tensor, kernel_size: int, dtype: torch.dtype) -> torch.Tensor:
    k3, cin, cout = w.shape
    tidx, _ = _device_tables(kernel_size, w.device)
    wpad = torch.cat([w.to(dtype), torch.zeros((1, cin, cout), dtype=dtype,
                                                device=w.device)])
    blocks = wpad[tidx]  # [27, 8, 8, Cin, Cout]; tap -1 is the zero block
    return blocks.permute(0, 1, 3, 2, 4).reshape(27 * 8 * cin, 8 * cout)


@lru_cache(maxsize=8)
def tap_blocks(kernel_size: int) -> np.ndarray:
    """[k^3, 8] int64: the block (e * 8 + s) * 8 + o of the conv matrix's
    [27 * 8 * 8] blocks that tap t fills for octant o (`tap_table`
    inverted: each tap lands once per octant)."""
    tidx = tap_table(kernel_size)
    out = np.full((kernel_size**3, 8), -1, np.int64)
    for e, s, o in zip(*np.nonzero(tidx >= 0)):
        out[tidx[e, s, o], o] = (e * 8 + s) * 8 + o
    assert (out >= 0).all()
    return out


class _WMat(torch.autograd.Function):
    """w [k^3, Cin, Cout] -> the conv matrix. Its gradient sums each tap's
    8 blocks in octant order, in the conv matrix's dtype, then casts to
    w's (JAX: the scatter-add transposing the gather from the padded w, in
    that dtype; the pad row's gradient is dropped)."""

    @staticmethod
    def forward(ctx, w, kernel_size, dtype):
        ctx.kernel_size = kernel_size
        ctx.w_dtype = w.dtype
        return _build_wmat(w, kernel_size, dtype)

    @staticmethod
    def backward(ctx, dwm):
        k3 = ctx.kernel_size**3
        cin = dwm.shape[0] // 216
        cout = dwm.shape[1] // 8
        blocks = dwm.reshape(27, 8, cin, 8, cout).permute(0, 1, 3, 2, 4)
        blocks = blocks.reshape(27 * 8 * 8, cin, cout)
        _, idx = _device_tables(ctx.kernel_size, dwm.device)
        per_o = blocks.index_select(0, idx).reshape(k3, 8, cin, cout)
        dw = per_o[:, 0]
        for o in range(1, 8):
            dw = dw + per_o[:, o]
        return dw.to(ctx.w_dtype), None, None


class GroupMap:
    """A group neighbor map gmapT [G, 27] (-1 = absent group) as gather
    rows: `index` (`gather_index`) for the forward and `flipped`, the rows
    of gmapT[:, ::-1], for the backward's gather of the upstream gradient
    (built on first use, then kept: JAX's `put_map` keeps both maps)."""

    __slots__ = ("index", "_flipped")

    def __init__(self, gmapT: torch.Tensor):
        self.index = gather_index(gmapT)
        self._flipped = None

    @property
    def flipped(self) -> torch.Tensor:
        if self._flipped is None:
            self._flipped = self.index.view(-1, 27).flip(1).reshape(-1)
        return self._flipped

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.index, self._flipped) if t is not None)


def group_map(m) -> GroupMap:
    """`m` as a GroupMap: a GroupMap is kept, a gmapT [G, 27] converted."""
    return m if isinstance(m, GroupMap) else GroupMap(m)


def gather_index(gmapT: torch.Tensor) -> torch.Tensor:
    """Rows of the gather for a group map [G, 27] (-1 = absent group): an
    absent group reads row G, which `core` fills with zeros. This equals
    `_gather27`'s clip to 0 and mask, without a masked copy of the [G, 27,
    8C] buffer."""
    g = gmapT.to(torch.int64)
    return torch.where(g >= 0, g, gmapT.shape[0]).reshape(-1)


def _gather27(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """[G, 27 * 8C]: the 27 neighbor groups' rows of x [G*8, C] over the
    gather rows `index` [G*27] (row G reads zeros)."""
    g = index.shape[0] // 27
    x2 = torch.cat([x.reshape(g, -1),
                    torch.zeros((1, 8 * x.shape[1]), dtype=x.dtype,
                                device=x.device)])
    return torch.index_select(x2, 0, index).reshape(g, -1)


class _Core(torch.autograd.Function):
    """y [G*8, Cout] = the packed conv of x [G*8, Cin] with the conv matrix
    wm; saves x and wm (not the gathered buffer), as JAX's residuals."""

    @staticmethod
    def forward(ctx, x, gm, wm):
        ctx.gm = gm
        ctx.save_for_backward(x, wm)
        g = gm.index.shape[0] // 27
        return torch.matmul(_gather27(x, gm.index), wm).reshape(g * 8, -1)

    @staticmethod
    def backward(ctx, dy):
        x, wm = ctx.saved_tensors
        gm = ctx.gm
        g = gm.index.shape[0] // 27
        cin8, cout8 = wm.shape[0] // 27, wm.shape[1]
        dy = dy.to(x.dtype)
        dx = wm_grad = None
        if ctx.needs_input_grad[0]:
            wback = wm.reshape(27, cin8, cout8).transpose(1, 2).reshape(
                27 * cout8, cin8)
            dx = torch.matmul(_gather27(dy, gm.flipped), wback).reshape(
                g * 8, -1)
        if ctx.needs_input_grad[2]:
            wm_grad = torch.matmul(_gather27(x, gm.index).T,
                                   dy.reshape(g, cout8)).to(wm.dtype)
        return dx, None, wm_grad


def core(x: torch.Tensor, gm: GroupMap, wm: torch.Tensor) -> torch.Tensor:
    """y [G*8, Cout] = packed conv of x [G*8, Cin] with the conv matrix
    `wm` over the group map `gm`."""
    return _Core.apply(x, gm, wm)


def sibconv_apply(x: torch.Tensor, gmapT, w: torch.Tensor,
                  bias: torch.Tensor | None = None, *,
                  slotmask: torch.Tensor | None = None) -> torch.Tensor:
    """Packed sparse conv.

    x [G*8, Cin] packed features (empty slots zero); gmapT [G, 27] group
    neighbor map (-1 = absent) or its `GroupMap`; w [k^3, Cin, Cout]; bias
    [Cout]; slotmask [G*8] bool zeroes the output's empty slots. Returns
    [G*8, Cout] in x.dtype; differentiable in x, w and bias."""
    k = round(w.shape[0] ** (1 / 3))
    y = core(x, group_map(gmapT), wmat(w, k, x.dtype))
    if bias is not None:
        y = y + bias.to(y.dtype)
    if slotmask is not None:
        y = torch.where(slotmask[:, None], y, 0)
    return y


class SibConv(nn.Module):
    """One packed conv: w [k^3, Cin, Cout] and b [Cout], as the JAX
    package keeps them. Without a gradient to w its conv matrix is built
    once per dtype and device and rebuilt only when w changes; with one,
    it is built in the graph on every call, so the gradient reaches w."""

    def __init__(self, cin: int, cout: int, kernel_size: int):
        super().__init__()
        self.kernel_size = kernel_size
        self.w = nn.Parameter(torch.zeros((kernel_size**3, cin, cout)))
        self.b = nn.Parameter(torch.zeros(cout))
        self._wmats: dict = {}

    def conv_matrix(self, dtype: torch.dtype) -> torch.Tensor:
        if torch.is_grad_enabled() and self.w.requires_grad:
            return wmat(self.w, self.kernel_size, dtype)
        key = (dtype, self.w.device, self.w._version)
        if key not in self._wmats:
            with torch.no_grad():
                self._wmats = {key: wmat(self.w, self.kernel_size, dtype)}
        return self._wmats[key]

    def forward(self, x: torch.Tensor, gm: GroupMap,
                slotmask: torch.Tensor) -> torch.Tensor:
        """x [G*8, Cin]; gm the group map (`group_map`); slotmask [G*8]."""
        y = core(x, gm, self.conv_matrix(x.dtype)) + self.b.to(x.dtype)
        return torch.where(slotmask[:, None], y, 0)
