"""Multi-resolution hash-grid encoder (counterpart of
gauspcc_tpu/fields/hashgrid.py:58-235), plain PyTorch.

Per level: pos = x * (R - 2) + 0.5, trilinear corners at floor(pos) and
min(floor(pos) + 1, R - 1); corners on the border (component 0 or R - 1)
are excluded and the remaining weights renormalised; dense indexing while
R^d fits the level's rows, else the XOR-prime hash, which wraps in uint32;
inputs outside [0, 1] give zeros. HAC binarises the tables with the sign
STE before lookup. The `binary_vxl` window mask is not on HAC's path and is
not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from gauspcc_tpu_torch.core.quant import ste_binary
from gauspcc_tpu_torch.utils import profiling

_PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF


class HashGridSpec(NamedTuple):
    """Static layout of one multi-level grid."""

    num_dim: int
    n_features: int
    resolutions: tuple[int, ...]
    offsets: tuple[int, ...]  # per-level row offsets into the table, +end

    @property
    def n_rows(self) -> int:
        return self.offsets[-1]

    @property
    def output_dim(self) -> int:
        return len(self.resolutions) * self.n_features


def make_spec(num_dim: int, n_features: int, resolutions,
              log2_hashmap_size: int) -> HashGridSpec:
    offsets = [0]
    max_params = 2**log2_hashmap_size
    for r in resolutions:
        rows = min(max_params, r**num_dim)
        rows = int(np.ceil(rows / 8) * 8)
        offsets.append(offsets[-1] + rows)
    return HashGridSpec(num_dim=num_dim, n_features=n_features,
                        resolutions=tuple(int(r) for r in resolutions),
                        offsets=tuple(offsets))


def _corner_offsets(num_dim: int, device) -> torch.Tensor:
    """[2^d, d] int64 corner offsets, bit k of corner i on axis k. Made on
    the device by arange, so encode makes no host-to-device copy."""
    i = torch.arange(2**num_dim, device=device)
    return (i[:, None] >> torch.arange(num_dim, device=device)) & 1


def encode(spec: HashGridSpec, table: torch.Tensor,
           x: torch.Tensor) -> torch.Tensor:
    """x: [N, num_dim] in [0, 1] -> [N, L * F] features."""
    d = spec.num_dim
    corners = _corner_offsets(d, x.device)  # [2^d, d]
    oob = ((x < 0.0) | (x > 1.0)).any(-1)  # [N]
    outs = []
    for lvl, r in enumerate(spec.resolutions):
        rows = spec.offsets[lvl + 1] - spec.offsets[lvl]
        pos = x * float(r - 2) + 0.5
        pos_grid = torch.floor(pos)
        frac = pos - pos_grid
        # int64 holds what JAX's int32 cast does for every in-range input;
        # out-of-range rows are zeroed below and only need a valid index
        pos_grid = pos_grid.to(torch.int64)

        cg = torch.clamp_max(pos_grid[:, None, :] + corners[None], r - 1)
        w = torch.where(corners[None] == 0, 1.0 - frac[:, None, :],
                        frac[:, None, :]).prod(-1)  # [N, 2^d]
        border = ((cg == 0) | (cg == r - 1)).any(-1)
        w = torch.where(border, 0.0, w)
        w = w / (w.sum(-1, keepdim=True) + 1e-9)

        if r**d <= rows:
            idx = sum(cg[..., k] * r**k for k in range(d))
        else:
            # uint32 XOR-prime hash, carried in int64 and masked to 32 bits
            h = torch.zeros(cg.shape[:2], dtype=torch.int64, device=x.device)
            for k in range(d):
                h = h ^ (((cg[..., k] & _U32) * _PRIMES[k]) & _U32)
            idx = h % rows
        idx = (idx % rows) + spec.offsets[lvl]

        feats = table[idx]  # [N, 2^d, F]
        outs.append((feats * w[..., None]).sum(1))
    out = torch.cat(outs, -1)
    return torch.where(oob[:, None], 0.0, out)


class MixedGridSpec(NamedTuple):
    xyz: HashGridSpec
    plane: HashGridSpec  # shared layout for xy/xz/yz

    @property
    def output_dim(self) -> int:
        return self.xyz.output_dim + 3 * self.plane.output_dim


def make_mixed_spec(
    n_features: int = 2,
    resolutions_3d=(18, 24, 33, 44, 59, 80, 108, 148, 201, 275, 376, 514),
    log2_hashmap_size: int = 19,
    resolutions_2d=(130, 258, 514, 1026),
    log2_hashmap_size_2d: int = 17,
) -> MixedGridSpec:
    return MixedGridSpec(
        xyz=make_spec(3, n_features, resolutions_3d, log2_hashmap_size),
        plane=make_spec(2, n_features, resolutions_2d, log2_hashmap_size_2d))


TABLE_NAMES = ("xyz", "xy", "xz", "yz")  # the reference's serialization order


class MixedTables(nn.Module):
    """HAC's 3-D table and three axis-plane tables."""

    def __init__(self, spec: MixedGridSpec):
        super().__init__()
        self.spec = spec
        for name in TABLE_NAMES:
            s = spec.xyz if name == "xyz" else spec.plane
            self.register_parameter(
                name, nn.Parameter(torch.zeros(s.n_rows, s.n_features)))

    @torch.no_grad()
    def init_uniform(self, rng: np.random.Generator,
                     std: float = 1e-4) -> "MixedTables":
        for name in TABLE_NAMES:
            p = getattr(self, name)
            p.copy_(torch.from_numpy(
                rng.uniform(-std, std, tuple(p.shape)).astype(np.float32)))
        return self

    def forward(self, x: torch.Tensor, binarize: bool = True) -> torch.Tensor:
        """HAC context features: the 3-D grid on xyz and the 2-D grids on
        the three axis planes, concatenated (mixed_encode). While the
        recorder is on, its backward is the span "hac.grid.bwd": from the
        output's gradient to the last table's."""
        tb = {n: ste_binary(getattr(self, n)) if binarize else getattr(self, n)
              for n in TABLE_NAMES}
        out = torch.cat([
            encode(self.spec.xyz, tb["xyz"], x),
            encode(self.spec.plane, tb["xy"], x[:, 0:2]),
            encode(self.spec.plane, tb["xz"], x[:, 0::2]),
            encode(self.spec.plane, tb["yz"], x[:, 1:3]),
        ], -1)
        profiling.backward_span("hac.grid.bwd", out,
                                [getattr(self, n) for n in TABLE_NAMES])
        return out

    def flat(self) -> torch.Tensor:
        """All embeddings concatenated in the order xyz, xy, xz, yz."""
        return torch.cat([getattr(self, n) for n in TABLE_NAMES])


@torch.no_grad()
def unflatten_tables(spec: MixedGridSpec, flat: torch.Tensor) -> MixedTables:
    """The inverse of `MixedTables.flat`: tables from `[rows, F]` rows in
    the order xyz, xy, xz, yz, on flat's device."""
    n3, n2 = spec.xyz.n_rows, spec.plane.n_rows
    if flat.shape != (n3 + 3 * n2, spec.xyz.n_features):
        raise ValueError(f"flat tables {tuple(flat.shape)} do not fit the "
                         f"spec's {n3 + 3 * n2} rows of {spec.xyz.n_features}")
    tables = MixedTables(spec).to(flat.device)
    for name, part in zip(TABLE_NAMES, torch.split(flat, [n3, n2, n2, n2])):
        getattr(tables, name).copy_(part)
    return tables
