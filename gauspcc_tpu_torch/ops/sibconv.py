"""Sibling-packed submanifold sparse conv, forward: the port's counterpart
of gauspcc_tpu/ops/sibconv.py (`sib_pos_np` :38, `tap_table` :55, `_wmat`
:82, `_core_fwd` :110, `sibconv_apply` :143).

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
is added in the feature dtype, as in JAX. The custom backward
(`_core_bwd` :119) comes with codec training.
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
    (e, s, cin), as the gathered input; columns (o, cout)."""
    k3, cin, cout = w.shape
    tidx = torch.as_tensor(tap_table(kernel_size), dtype=torch.int64,
                           device=w.device)
    wpad = torch.cat([w.to(dtype), torch.zeros((1, cin, cout), dtype=dtype,
                                                device=w.device)])
    blocks = wpad[tidx]  # [27, 8, 8, Cin, Cout]; tap -1 is the zero block
    return blocks.permute(0, 1, 3, 2, 4).reshape(27 * 8 * cin, 8 * cout)


def gather_index(gmapT: torch.Tensor) -> torch.Tensor:
    """Rows of the gather for a group map [G, 27] (-1 = absent group): an
    absent group reads row G, which `core` fills with zeros. This equals
    `_gather27`'s clip to 0 and mask, without a masked copy of the [G, 27,
    8C] buffer."""
    g = gmapT.to(torch.int64)
    return torch.where(g >= 0, g, gmapT.shape[0]).reshape(-1)


def core(x: torch.Tensor, index: torch.Tensor, wm: torch.Tensor) -> torch.Tensor:
    """y [G*8, Cout] = packed conv of x [G*8, Cin] with the conv matrix
    `wm` over the gather rows `index` [G*27] (`gather_index`)."""
    g = index.shape[0] // 27
    cin = x.shape[1]
    x2 = torch.cat([x.reshape(g, 8 * cin),
                    torch.zeros((1, 8 * cin), dtype=x.dtype, device=x.device)])
    xg = torch.index_select(x2, 0, index).reshape(g, 27 * 8 * cin)
    return torch.matmul(xg, wm).reshape(g * 8, -1)


def sibconv_apply(x: torch.Tensor, gmapT: torch.Tensor, w: torch.Tensor,
                  bias: torch.Tensor | None = None, *,
                  slotmask: torch.Tensor | None = None) -> torch.Tensor:
    """Packed sparse conv.

    x [G*8, Cin] packed features (empty slots zero); gmapT [G, 27] group
    neighbor map (-1 = absent); w [k^3, Cin, Cout]; bias [Cout]; slotmask
    [G*8] bool zeroes the output's empty slots. Returns [G*8, Cout] in
    x.dtype."""
    k = round(w.shape[0] ** (1 / 3))
    y = core(x, gather_index(gmapT), wmat(w, k, x.dtype))
    if bias is not None:
        y = y + bias.to(y.dtype)
    if slotmask is not None:
        y = torch.where(slotmask[:, None], y, 0)
    return y


class SibConv(nn.Module):
    """One packed conv: w [k^3, Cin, Cout] and b [Cout], as the JAX
    package keeps them. Its conv matrix is built once per dtype and device
    and rebuilt only when w changes."""

    def __init__(self, cin: int, cout: int, kernel_size: int):
        super().__init__()
        self.kernel_size = kernel_size
        self.w = nn.Parameter(torch.zeros((kernel_size**3, cin, cout)))
        self.b = nn.Parameter(torch.zeros(cout))
        self._wmats: dict = {}

    def conv_matrix(self, dtype: torch.dtype) -> torch.Tensor:
        key = (dtype, self.w.device, self.w._version)
        if key not in self._wmats:
            with torch.no_grad():
                self._wmats = {key: wmat(self.w, self.kernel_size, dtype)}
        return self._wmats[key]

    def forward(self, x: torch.Tensor, index: torch.Tensor,
                slotmask: torch.Tensor) -> torch.Tensor:
        """x [G*8, Cin]; index from `gather_index`; slotmask [G*8]."""
        y = core(x, index, self.conv_matrix(x.dtype)) + self.b.to(x.dtype)
        return torch.where(slotmask[:, None], y, 0)
