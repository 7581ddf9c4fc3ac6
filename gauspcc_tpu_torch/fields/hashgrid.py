"""Multi-resolution hash-grid encoder (counterpart of
gauspcc_tpu/fields/hashgrid.py:58-235), plain PyTorch.

Per level: pos = x * (R - 2) + 0.5, trilinear corners at floor(pos) and
min(floor(pos) + 1, R - 1); corners on the border (component 0 or R - 1)
are excluded and the remaining weights renormalised; dense indexing while
R^d fits the level's rows, else the XOR-prime hash, which wraps in uint32;
inputs outside [0, 1] give zeros. HAC binarises the tables with the sign
STE before lookup. The `binary_vxl` window mask is not on HAC's path and is
not ported yet.

The table's gradient. For a table that needs its gradient, under grad
mode, `encode` looks up through `_Lookup`: its forward is the plain
gather, weights and sum, op for op, and its backward is `table_grad`, a
deterministic segmented sum over the lookups sorted by table row, in place
of autograd's accumulating `index_put_`. On a CUDA table that is K3's
backward (`csrc/hashgrid.cu`), which launches or raises; on a CPU table it
is `table_grad_reference`, the kernel's plain version: the same sorted
order and segment sums in torch ops. So training on either device takes
one route, and the CPU's parity tests against the JAX package cover it.
Calls without grad (views, evaluation, the codecs) take the plain forward.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from gauspcc_tpu_torch import native
from gauspcc_tpu_torch.core.quant import ste_binary
from gauspcc_tpu_torch.utils import profiling

_PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF
F32_ULP = 2.0 ** -24  # unit roundoff of float32
KERNEL_FEATURES = (1, 2, 4, 8)  # the row widths K3 is built for
CHUNK = 2048  # sorted lookups a warp of K3 sums (kChunk in csrc/hashgrid.cu)

# Number of K3 backward launches made by `table_grad`: one per call of the C
# entry (one per table a step), which launches starts_kernel, chunk_kernel
# and rows_kernel. Callers reset it to 0 to count the launches of one run.
# While the recorder is on, each launch also counts "grid_bwd_launches" in
# the innermost span (utils/profiling.py).
backward_launches = 0


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


def _level_lookups(spec: HashGridSpec, x: torch.Tensor):
    """Per level: (idx [N, 2^d] int64 table rows, w [N, 2^d] weights) of
    every corner."""
    d = spec.num_dim
    corners = _corner_offsets(d, x.device)  # [2^d, d]
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
        yield (idx % rows) + spec.offsets[lvl], w


def _interpolate(table: torch.Tensor, idx: torch.Tensor,
                 w: torch.Tensor) -> torch.Tensor:
    """One level's features [N, F]: the corners' rows weighted and summed."""
    feats = table[idx]  # [N, 2^d, F]
    return (feats * w[..., None]).sum(1)


def encode(spec: HashGridSpec, table: torch.Tensor,
           x: torch.Tensor) -> torch.Tensor:
    """x: [N, num_dim] in [0, 1] -> [N, L * F] features."""
    oob = ((x < 0.0) | (x > 1.0)).any(-1)  # [N]
    if torch.is_grad_enabled() and table.requires_grad:
        idxs, ws = zip(*_level_lookups(spec, x))
        out = _Lookup.apply(table, idxs, *ws)
    else:
        out = torch.cat([_interpolate(table, idx, w)
                         for idx, w in _level_lookups(spec, x)], -1)
    return torch.where(oob[:, None], 0.0, out)


class _Lookup(torch.autograd.Function):
    """Every level's lookups into one table: the plain forward, with the
    table's gradient from `table_grad` (K3 on CUDA tensors, its plain
    version on CPU tensors). Takes the table, the levels' rows (no
    gradient) and the levels' weights."""

    @staticmethod
    def forward(ctx, table, idxs, *ws):
        out = torch.cat([_interpolate(table, idx, w)
                         for idx, w in zip(idxs, ws)], -1)
        ctx.save_for_backward(
            table, torch.stack([i.to(torch.int32) for i in idxs], 1),
            torch.stack(ws, 1))
        return out

    @staticmethod
    def backward(ctx, grad_out):
        table, idx, w = ctx.saved_tensors  # idx, w: [N, L, 2^d]
        g = grad_out.contiguous()
        grad_table = (table_grad(idx, w, g, table.shape[0])
                      if ctx.needs_input_grad[0] else None)
        # the weights' gradient, where x needs one: sum_f g * table[idx]
        n, levels, _ = idx.shape
        g_levels = g.reshape(n, levels, -1)
        grad_ws = [(table[idx[:, lvl].long()] * g_levels[:, lvl, None, :]).sum(-1)
                   if ctx.needs_input_grad[2 + lvl] else None
                   for lvl in range(levels)]
        return (grad_table, None, *grad_ws)


def _check_grad_inputs(idx: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                       rows: int) -> int:
    """Checks K3's inputs (see `table_grad`); returns F."""
    if idx.dim() != 3 or idx.dtype != torch.int32:
        raise ValueError(f"idx: expected int32 [N, L, C], got {idx.dtype} "
                         f"{tuple(idx.shape)}")
    n, levels, _ = idx.shape
    f = g.shape[-1] // levels if g.dim() == 2 and levels else 0
    for name, t, shape in (("w", w, tuple(idx.shape)),
                           ("grad_out", g, (n, levels * f))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected float32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != idx.device:
            raise ValueError(f"{name} is on {t.device}, idx on {idx.device}")
    if f not in KERNEL_FEATURES:
        raise ValueError(f"K3 takes rows of {KERNEL_FEATURES} floats, not {f}")
    if idx.numel() >= 2**31 or not 0 <= rows < 2**31 - 1:
        raise ValueError(f"{idx.numel()} lookups into {rows} rows do not fit "
                         "K3's int32 positions")
    return f


def _library():
    lib = native.load("hashgrid").lib
    if lib.hashgrid_table_grad.argtypes is None:
        # every pointer and the stream as c_void_p: ctypes would otherwise
        # pass them as 32-bit ints and cut them
        lib.hashgrid_table_grad.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int] + [
            ctypes.c_void_p] * 4
        lib.hashgrid_table_grad.restype = ctypes.c_int
    return lib


def table_grad(idx: torch.Tensor, w: torch.Tensor, grad_out: torch.Tensor,
               rows: int) -> torch.Tensor:
    """The gradient [rows, F] of a table of `rows` rows whose lookups are
    idx [N, L, C] (int32 table rows of every point, level and corner) with
    weights w [N, L, C], given grad_out [N, L * F], the gradient of the
    weighted sums (before the out-of-range mask, which autograd applies).

    On CUDA tensors: a stable sort of the row keys, with the flat lookup id
    as the value, then K3's backward (counted in `backward_launches`); it
    raises if a launch is refused. On CPU tensors: `table_grad_reference`."""
    if idx.device.type == "cpu":
        return table_grad_reference(idx, w, grad_out, rows)
    if idx.device.type != "cuda":
        raise ValueError(f"K3 runs on CUDA or CPU, not {idx.device}")
    keys, order = torch.sort(idx.reshape(-1), stable=True)
    return launch_table_grad(keys, order, w, grad_out, rows)


def launch_table_grad(keys: torch.Tensor, order: torch.Tensor, w: torch.Tensor,
                      grad_out: torch.Tensor, rows: int) -> torch.Tensor:
    """One call of K3's C entry on the lookups sorted by row (keys int32
    [M], order int64 [M], as `table_grad` sorts them), with w [N, L, C] and
    grad_out [N, L * F] as there -> the gradient [rows, F]; counted in
    `backward_launches`, raises if a launch is refused."""
    global backward_launches
    m = keys.shape[0]
    for name, t, dtype in (("keys", keys, torch.int32),
                           ("order", order, torch.int64)):
        if t.dtype != dtype or tuple(t.shape) != (w.numel(),) \
                or t.device != w.device:
            raise ValueError(f"{name}: expected {dtype} ({w.numel()},) on "
                             f"{w.device}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    if w.device.type != "cuda":
        raise ValueError(f"K3 runs on CUDA tensors, not {w.device}")
    f = _check_grad_inputs(keys.view(w.shape), w, grad_out, rows)
    dev = keys.device
    w, grad_out = w.contiguous(), grad_out.contiguous()
    starts = torch.empty(rows + 1, dtype=torch.int32, device=dev)
    partial = torch.empty((max(-(-m // CHUNK), 1), 2, f), dtype=torch.float32,
                          device=dev)
    grad = torch.empty((rows, f), dtype=torch.float32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.hashgrid_table_grad(
            keys.data_ptr(), order.data_ptr(), w.data_ptr(), grad_out.data_ptr(),
            m, w.shape[2], f, rows, starts.data_ptr(), partial.data_ptr(),
            grad.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"hashgrid table_grad launch failed: CUDA error {rc}")
    backward_launches += 1
    profiling.count("grid_bwd_launches")
    return grad


def table_grad_reference(idx: torch.Tensor, w: torch.Tensor,
                         grad_out: torch.Tensor, rows: int) -> torch.Tensor:
    """Plain version of K3's backward, on any device and dtype: the lookups
    in the same sorted order (a stable sort of the rows), each term w * g,
    and each row's run summed (`segment_reduce`; 0 for a row no lookup
    hits)."""
    n, levels, corners = idx.shape
    f = grad_out.shape[-1] // levels
    keys, order = torch.sort(idx.reshape(-1).long(), stable=True)
    terms = w.reshape(-1)[order, None] * grad_out.reshape(-1, f)[order // corners]
    lengths = torch.bincount(keys, minlength=rows)
    return torch.segment_reduce(terms, "sum", lengths=lengths, axis=0,
                                unsafe=True)


def table_grad_tolerance(idx: torch.Tensor, w: torch.Tensor,
                         grad_out: torch.Tensor, rows: int) -> torch.Tensor:
    """Per-element atol [rows, F] between two float32 table gradients that
    sum the same rounded terms in other orders (K3 and
    `table_grad_reference`, or either and autograd's `index_put_`): a sum
    of n terms in any order is within (n - 1) u sum|x| of the exact sum (u
    = 2^-24), so two orders are within 2 (n - 1) u sum|x|; both round each
    product w * g alike. sum|x| is taken in float64."""
    mags = table_grad_reference(idx, w.double().abs(), grad_out.double().abs(),
                                rows)
    n = torch.bincount(idx.reshape(-1).long(), minlength=rows)
    return (2 * (n - 1).clamp_min(0)[:, None] * F32_ULP * mags).to(torch.float32)


def kernel_grad_tolerance(idx: torch.Tensor, w: torch.Tensor,
                          grad_out: torch.Tensor, rows: int) -> torch.Tensor:
    """Per-element atol [rows, F] float64 of K3's gradient from the exact
    one (`table_grad_reference` on w and grad_out in float64, whose own
    error is below 2^-53 n sum|x|). K3 adds a row's term w * g, rounded
    once, along a path of at most h = min(n - 1, 5 + CHUNK / 32 +
    ceil(n / CHUNK)) roundings: 5 steps of a tile's shuffle scan, one carry
    for each later tile of its chunk, and one for each later chunk of the
    row's run (rows_kernel). So it is within (h + 2) u sum|w g| of the
    exact sum, plus 2^-149 a product for underflow. The bound grows with
    the number of chunks of a row, not with n u sum|x|, so a dropped or
    repeated chunk of a long row lies far outside it."""
    mags = table_grad_reference(idx, w.double().abs(), grad_out.double().abs(),
                                rows)
    n = torch.bincount(idx.reshape(-1).long(), minlength=rows).double()
    depth = torch.minimum((n - 1).clamp_min(0),
                          5 + CHUNK // 32 + torch.ceil(n / CHUNK))
    return ((depth + 2) * F32_ULP)[:, None] * mags + (n * 2.0**-149)[:, None]


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
