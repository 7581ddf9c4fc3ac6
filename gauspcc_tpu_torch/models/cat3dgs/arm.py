"""CAT-3DGS's autoregressive model over the triplane latents (counterpart
of gauspcc_tpu/models/cat3dgs/arm.py: `init_arm` :39, `arm_apply` :54,
`get_mu_scale` :69, `laplace_cdf` :75, `compute_rate` :79,
`extract_context` :89, `plane_rate` :102, `coding_waves` :114, the float
coder :166 / :373 and the fixed-point coder :207-370).

An ARM reads the 12 causal neighbours of a latent pixel (the first half of
its 5x5 window, zero outside the plane) through four 16-wide layers (a
16->16 layer adds its input back) to a head (mu, log_scale); the scale is
exp(-0.5 clip(log_scale, -10, 13.8155)) and a symbol's probability is its
Laplace bin mass, floored at 2^-16. Training evaluates every pixel's
context at once from the (noisy) plane.

The coders run on the host in numpy and feed the port's native coder
(`ops/coder.py`) in wavefront order: pixel (i, j) lies in wave 3 i + j,
and every context pixel of a wave lies in an earlier one, so a wave
decodes as one batch. The scene stream uses the fixed-point ARM: Q12
weights, Q8 activations, int64 sums and a Q30 exp built from hard-coded
constants, so the encoder and the decoder compute the same CDF rows on
any machine, and the JAX package's integers exactly. The quantised weights
travel in the stream (`pack_arm`).
"""

from __future__ import annotations

import struct

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from gauspcc_tpu_torch.ops import coder

MASK_SIZE = 5  # 2 * n_ctx_rowcol + 1 with n_ctx_rowcol = 2
N_CTX = (MASK_SIZE**2 - 1) // 2  # 12 causal neighbours
WAVE_ROW_OFFSET = 3  # n_ctx_rowcol + 1

# (dy, dx) of the 12 causal neighbours: the first half of the 5x5 window in
# raster order (rows -2 and -1 whole; row 0 at columns -2 and -1)
CTX_OFFSETS = np.array(
    [(dy, dx) for dy in (-2, -1) for dx in (-2, -1, 0, 1, 2)]
    + [(0, -2), (0, -1)],
    dtype=np.int32,
)


class _Layer(nn.Module):
    """One dense layer under the JAX key it has there: `res_lin` when it
    maps a width to itself (and adds its input back), else `lin`."""

    def __init__(self, d_in: int, d_out: int, head: bool = False):
        super().__init__()
        self.res = d_in == d_out and not head
        setattr(self, "res_lin" if self.res else "lin", nn.Linear(d_in, d_out))

    @property
    def linear(self) -> nn.Linear:
        return self.res_lin if self.res else self.lin


class ARM(nn.Module):
    """The 12-tap context MLP: layers/<i>/<lin|res_lin>, then a 2-wide head
    (`layers[-1]`, always `lin`)."""

    def __init__(self, layers=(16, 16, 16, 16)):
        super().__init__()
        mods, d_in = [], N_CTX
        for d_out in layers:
            mods.append(_Layer(d_in, d_out))
            d_in = d_out
        mods.append(_Layer(d_in, 2, head=True))
        self.layers = nn.ModuleList(mods)

    @torch.no_grad()
    def init_uniform(self, rng: np.random.Generator) -> "ARM":
        """U(+-1/sqrt(fan_in)) for every weight and bias (the JAX package's
        dense_init), drawn from a numpy Generator."""
        for layer in self.layers:
            fc = layer.linear
            bound = 1.0 / np.sqrt(fc.in_features)
            for p in (fc.weight, fc.bias):
                p.copy_(torch.from_numpy(
                    rng.uniform(-bound, bound, tuple(p.shape)).astype(np.float32)))
        return self

    def numpy_layers(self) -> list:
        """[(res, w [in, out] float32, b [out] float32)] on the host."""
        return [(layer.res,
                 np.ascontiguousarray(layer.linear.weight.detach().cpu().numpy().T),
                 layer.linear.bias.detach().cpu().numpy())
                for layer in self.layers]


def arm_apply(arm: ARM, ctx: torch.Tensor) -> torch.Tensor:
    """ctx [B, 12] -> raw (mu, log_scale) [B, 2]."""
    x = ctx
    for layer in arm.layers[:-1]:
        y = layer.linear(x)
        if layer.res:
            y = y + x
        x = torch.relu(y)
    return arm.layers[-1].linear(x)


def get_mu_scale(raw: torch.Tensor):
    mu = raw[:, 0]
    scale = torch.exp(-0.5 * torch.clamp(raw[:, 1], -10.0, 13.8155))
    return mu, scale


def laplace_cdf(x, loc, scale):
    """0.5 - 0.5 sign(x - loc) expm1(-|x - loc| / scale); |d| written as
    where(d >= 0, d, -d), whose gradient at 0 is +1 as jnp.abs's is (the
    rate's gradient reaches the ARM and the planes through it)."""
    d = x - loc
    return 0.5 - 0.5 * torch.sign(d) * torch.expm1(
        -torch.where(d >= 0, d, -d) / scale)


def compute_rate(x, raw):
    """Bits of the quantised-Laplace likelihood, floored at 2^-16, and the
    model's (mu, scale)."""
    mu, scale = get_mu_scale(raw)
    proba = torch.clamp_min(
        laplace_cdf(x + 0.5, mu, scale) - laplace_cdf(x - 0.5, mu, scale),
        2.0**-16)
    return -torch.log2(proba), mu, scale


def extract_context(latent: torch.Tensor) -> torch.Tensor:
    """latent [H, W] -> its pixels' causal neighbours [H*W, 12] (zero
    outside the plane)."""
    h, w = latent.shape
    pad = MASK_SIZE // 2
    xp = F.pad(latent, (pad, pad, pad, pad))
    cols = [xp[pad + int(dy): pad + int(dy) + h, pad + int(dx): pad + int(dx) + w]
            for dy, dx in CTX_OFFSETS]
    return torch.stack(cols, -1).reshape(h * w, N_CTX)


def plane_rate(arm: ARM, latent: torch.Tensor):
    """(total bits, mu, scale) of one [H, W] quantised latent plane."""
    raw = arm_apply(arm, extract_context(latent))
    rate, mu, scale = compute_rate(latent.reshape(-1), raw)
    return rate.sum(), mu, scale


# ---------------------------------------------------------------------------
# the wavefront order
# ---------------------------------------------------------------------------

def coding_waves(h: int, w: int) -> list:
    """(rows, cols) int32 index arrays of each wave, wave 3 i + j holding
    pixel (i, j), in order."""
    wave_of = WAVE_ROW_OFFSET * np.arange(h)[:, None] + np.arange(w)[None, :]
    waves = []
    for wv in range(int(wave_of.max()) + 1):
        ii, jj = np.nonzero(wave_of == wv)
        if ii.size:
            waves.append((ii.astype(np.int32), jj.astype(np.int32)))
    return waves


def _wave_order(h: int, w: int) -> np.ndarray:
    return np.concatenate([ii * w + jj for ii, jj in coding_waves(h, w)])


def _ctx_np(padded: np.ndarray, ii: np.ndarray, jj: np.ndarray) -> np.ndarray:
    pad = MASK_SIZE // 2
    return np.stack([padded[ii + pad + dy, jj + pad + dx]
                     for dy, dx in CTX_OFFSETS], axis=-1)


def _padded_plane(latent: np.ndarray, dtype) -> np.ndarray:
    h, w = latent.shape
    pad = MASK_SIZE // 2
    out = np.zeros((h + 2 * pad, w + 2 * pad), dtype)
    out[pad:-pad, pad:-pad] = latent
    return out


def _head(h: int, w: int, rmin: int, rmax: int) -> bytes:
    return np.array([h, w, rmin, rmax], np.int32).tobytes()


def _read_head(stream: bytes):
    h, w, rmin, rmax = (int(v) for v in np.frombuffer(stream[:16], np.int32))
    return h, w, rmin, rmax, stream[16:]


# ---------------------------------------------------------------------------
# the float coder (the host's float32 numpy ARM)
# ---------------------------------------------------------------------------

def _arm_apply_np(layers: list, ctx: np.ndarray) -> np.ndarray:
    x = ctx
    for res, w, b in layers[:-1]:
        y = x @ w + b
        if res:
            y = y + x
        x = np.maximum(y, 0.0)
    _, w, b = layers[-1]
    return x @ w + b


def _mu_scale_np(raw: np.ndarray):
    return raw[:, 0], np.exp(-0.5 * np.clip(raw[:, 1], -10.0, 13.8155))


def _laplace_cdf_np(x, loc, scale):
    return 0.5 - 0.5 * np.sign(x - loc) * np.expm1(-np.abs(x - loc) / scale)


def _laplace_table_np(mu, scale, rmin: int, rmax: int) -> np.ndarray:
    """uint16-normalised Laplace CDF rows over the symbols [rmin, rmax]."""
    lp = rmax - rmin + 2
    xs = (np.arange(lp, dtype=np.float32) + (rmin - 0.5))[None, :]
    cdf = np.clip(_laplace_cdf_np(xs, mu[:, None], scale[:, None]), 0.0, 1.0)
    new_max = np.float32(2.0**16 - (lp - 1))
    v = np.round(cdf * new_max).astype(np.int64) + np.arange(lp)
    return v.astype(np.uint16)


def encode_plane(arm: ARM, latent: np.ndarray, sym_bound: int = 256) -> bytes:
    """One quantised [H, W] plane under the float ARM: its CDF rows from
    the whole (teacher-forced) plane, the symbols in wavefront order.
    Returns the 16-byte head (h, w, rmin, rmax) and the coder's payload."""
    h, w = latent.shape
    lat = np.clip(np.round(latent), -sym_bound, sym_bound).astype(np.int32)
    ii, jj = np.mgrid[0:h, 0:w]
    ctx = _ctx_np(_padded_plane(lat.astype(np.float32), np.float32),
                  ii.reshape(-1), jj.reshape(-1))
    mu, scale = _mu_scale_np(_arm_apply_np(arm.numpy_layers(), ctx))
    rmin, rmax = int(lat.min()), int(lat.max())
    order = _wave_order(h, w)
    table = _laplace_table_np(mu, scale, rmin, rmax)
    syms = (lat.reshape(-1)[order] - rmin).astype(np.int16)
    return _head(h, w, rmin, rmax) + coder.encode_int16_cdf(table[order], syms)


def decode_plane(arm: ARM, stream: bytes) -> np.ndarray:
    """Inverse of encode_plane: a wave at a time, the float ARM over the
    wave's decoded contexts, the coder's incremental decoder."""
    h, w, rmin, rmax, payload = _read_head(stream)
    layers = arm.numpy_layers()
    pad = MASK_SIZE // 2
    padded = np.zeros((h + 2 * pad, w + 2 * pad), np.float32)
    dec = coder.IncrementalDecoder(payload, h * w)
    out = np.zeros((h, w), np.float32)
    try:
        for ii, jj in coding_waves(h, w):
            mu, scale = _mu_scale_np(_arm_apply_np(layers, _ctx_np(padded, ii, jj)))
            vals = dec.decode(_laplace_table_np(mu, scale, rmin, rmax)).astype(
                np.float32) + rmin
            padded[ii + pad, jj + pad] = vals
            out[ii, jj] = vals
    finally:
        dec.close()
    return out


# ---------------------------------------------------------------------------
# the fixed-point coder (the scene stream's)
# ---------------------------------------------------------------------------

ARM_W_FRAC = 12  # weight fraction bits
ARM_A_FRAC = 8  # activation fraction bits
_EXP_T_MAX = 22 << 16  # exp(-22) rounds to 0 in Q30
# exp(-2^(i-16)) in Q30 for the bits 0..20 of t in Q16, written out so that
# no libm call can change the table between machines
_EXP_C = np.array([
    1073725440, 1073709056, 1073676290, 1073610760, 1073479712, 1073217664,
    1072693760, 1071646719, 1069555701, 1065385899, 1057095000, 1040706261,
    1008687096, 947573834, 836230973, 651257337, 395007542, 145315154,
    19666268, 360200, 121,
], dtype=np.int64)
_LS_MIN_Q8 = -10 * 256
_LS_MAX_Q8 = 3537  # 13.8155 * 256


def _exp_neg_q30(t_q16: np.ndarray) -> np.ndarray:
    """exp(-t) for t = t_q16 / 2^16 >= 0, in Q30 (int64, the product of the
    constants of t's set bits)."""
    t = np.minimum(t_q16.astype(np.int64), _EXP_T_MAX)
    acc = np.full(t.shape, np.int64(1) << 30, np.int64)
    for i in range(_EXP_C.shape[0]):
        on = ((t >> i) & 1) == 1
        acc = np.where(on, (acc * _EXP_C[i]) >> 30, acc)
    return acc


def quantize_arm(arm: ARM) -> dict:
    """The float ARM as the stream ships it: {"layers": [{"res", "w" int32
    [in, out] in Q12, "b" int64 at the Q20 accumulator scale}]}."""
    layers = []
    for res, w, b in arm.numpy_layers():
        layers.append({
            "res": res,
            "w": np.round(w.astype(np.float64) * (1 << ARM_W_FRAC)).astype(np.int32),
            "b": np.round(b.astype(np.float64)
                          * (1 << (ARM_W_FRAC + ARM_A_FRAC))).astype(np.int64),
        })
    return {"layers": layers}


def _arm_apply_fixed(qparams: dict, ctx_int: np.ndarray) -> np.ndarray:
    """ctx_int [B, 12] integer latents -> (mu, log_scale) in Q8, int64
    [B, 2]: each layer's Q20 sum rounded half up back to Q8."""
    x = ctx_int.astype(np.int64) << ARM_A_FRAC
    half = np.int64(1) << (ARM_W_FRAC - 1)
    for layer in qparams["layers"][:-1]:
        acc = x @ layer["w"].astype(np.int64) + layer["b"]
        y = (acc + half) >> ARM_W_FRAC
        if layer["res"]:
            y = y + x
        x = np.maximum(y, 0)
    last = qparams["layers"][-1]
    acc = x @ last["w"].astype(np.int64) + last["b"]
    return (acc + half) >> ARM_W_FRAC


def _laplace_table_fixed(mu_q8, ls_q8, rmin: int, rmax: int) -> np.ndarray:
    """uint16-normalised Laplace CDF rows from integer (mu, log_scale):
    1/scale = exp(ls / 2) by the integer exp (and an integer reciprocal for
    ls >= 0), then cdf = exp(-(mu - x)/scale) / 2 below mu and 1 - exp(-(x -
    mu)/scale) / 2 above, in Q31. The rows are made non-decreasing (the
    integer exp is monotone to about an ulp of Q30) before the +arange that
    makes them strictly increasing."""
    ls = np.clip(ls_q8, _LS_MIN_Q8, _LS_MAX_Q8).astype(np.int64)
    e = _exp_neg_q30(np.abs(ls) << 7)  # |ls| / 512 in Q16
    inv_scale_q16 = np.where(ls >= 0, (np.int64(1) << 46) // np.maximum(e, 1),
                             e >> 14)
    lp = rmax - rmin + 2
    xs_q8 = ((np.arange(lp, dtype=np.int64) + rmin) << 8) - 128  # rmin - 0.5 + j
    d_q8 = xs_q8[None, :] - mu_q8.astype(np.int64)[:, None]
    eh = _exp_neg_q30((np.abs(d_q8) * inv_scale_q16[:, None]) >> 8)
    cdf_q31 = np.where(d_q8 < 0, eh, (np.int64(1) << 31) - eh)
    new_max = np.int64(2**16 - (lp - 1))
    v = (cdf_q31 * new_max + (np.int64(1) << 30)) >> 31
    v = np.maximum.accumulate(v, axis=1)
    return (v + np.arange(lp, dtype=np.int64)).astype(np.uint16)


def pack_arm(qparams: dict) -> bytes:
    """An integer ARM as bytes: u32 layer count, then per layer u32 (res,
    in, out), the weights as <i4 and the biases as <i8."""
    out = [struct.pack("<I", len(qparams["layers"]))]
    for layer in qparams["layers"]:
        w, b = layer["w"], layer["b"]
        out.append(struct.pack("<III", int(layer["res"]), *w.shape))
        out.append(w.astype("<i4").tobytes())
        out.append(b.astype("<i8").tobytes())
    return b"".join(out)


def unpack_arm(buf: bytes, off: int = 0):
    """-> (integer ARM, bytes read from `off`)."""
    (n_layers,) = struct.unpack_from("<I", buf, off)
    start, off = off, off + 4
    layers = []
    for _ in range(n_layers):
        res, din, dout = struct.unpack_from("<III", buf, off)
        off += 12
        w = np.frombuffer(buf, "<i4", din * dout, off).reshape(din, dout)
        off += 4 * din * dout
        b = np.frombuffer(buf, "<i8", dout, off)
        off += 8 * dout
        layers.append({"res": bool(res), "w": w.copy(), "b": b.copy()})
    return {"layers": layers}, off - start


def encode_plane_fixed(qparams: dict, latent: np.ndarray,
                       sym_bound: int = 256) -> bytes:
    """encode_plane under the integer ARM and integer CDF rows."""
    h, w = latent.shape
    lat = np.clip(np.round(latent), -sym_bound, sym_bound).astype(np.int64)
    ii, jj = np.mgrid[0:h, 0:w]
    raw = _arm_apply_fixed(qparams, _ctx_np(_padded_plane(lat, np.int64),
                                            ii.reshape(-1), jj.reshape(-1)))
    rmin, rmax = int(lat.min()), int(lat.max())
    table = _laplace_table_fixed(raw[:, 0], raw[:, 1], rmin, rmax)
    order = _wave_order(h, w)
    syms = (lat.reshape(-1)[order] - rmin).astype(np.int16)
    return _head(h, w, rmin, rmax) + coder.encode_int16_cdf(table[order], syms)


def decode_plane_fixed(qparams: dict, stream: bytes) -> np.ndarray:
    """Inverse of encode_plane_fixed, a wave at a time with integer
    arithmetic only. Returns float32 [H, W] integers."""
    h, w, rmin, rmax, payload = _read_head(stream)
    pad = MASK_SIZE // 2
    padded = np.zeros((h + 2 * pad, w + 2 * pad), np.int64)
    dec = coder.IncrementalDecoder(payload, h * w)
    out = np.zeros((h, w), np.float32)
    try:
        for ii, jj in coding_waves(h, w):
            raw = _arm_apply_fixed(qparams, _ctx_np(padded, ii, jj))
            vals = dec.decode(_laplace_table_fixed(
                raw[:, 0], raw[:, 1], rmin, rmax)).astype(np.int64) + rmin
            padded[ii + pad, jj + pad] = vals
            out[ii, jj] = vals
    finally:
        dec.close()
    return out
