"""File-level entropy coding of quantized tensors (counterpart of
gauspcc_tpu/ops/entropy_coding.py).

The models are computed in torch on the tensors' device; the bits are
written by the port's native coder on the host (`ops/coder.py`). A tensor
crosses to the host once, stacked with the others the coder needs. The
`.b` files are the JAX package's: f32 rmin, f32 rmax, then the coder's
payload; for the binary coder, f32 p1, then the payload.

Gaussian symbols are residuals r = round(x / q) - round(mean / q), coded
under the residual-space model (mean / q - round(mean / q), scale / q) that
the coder evaluates itself. Encoder and decoder compute the centre and the
model with the same operations, so on one device and one build they agree
bit for bit. The mixture coder (HAC++'s features) centres its residuals on
round(sum_k p_k mean_k / q) and hands the coder K components per symbol.
The factorized coder writes one int16 CDF row per channel over the
symbols' range, for every row of that channel. The rows are evaluated by
the factorized model in float32 on the host whatever device holds the
parameters, so a stream's tables, and its bytes, do not depend on the
device that wrote it. Against the JAX package's tables (XLA's tanh and
softplus) an entry can differ by one count of 2^16.
"""

from __future__ import annotations

import numpy as np
import torch

from gauspcc_tpu_torch.core import cdf as cdf_lib
from gauspcc_tpu_torch.core import entropy as entropy_lib
from gauspcc_tpu_torch.core.quant import quantize_to_symbols
from gauspcc_tpu_torch.ops import coder


def _flat(x: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x).reshape(-1)


def _as_q(q, like: torch.Tensor) -> torch.Tensor:
    if not isinstance(q, torch.Tensor) or q.dim() == 0:
        return torch.full_like(like, float(q))
    return q.reshape(-1)


@torch.no_grad()
def _residual_model(x, mean, scale, q):
    """Residual symbols (float, integral) and the residual-space model."""
    center = torch.round(mean / q)
    res = torch.round(x / q) - center
    return res, center, (mean / q - center), scale / q


@torch.no_grad()
def _residual_model_dec(mean, scale, q):
    center = torch.round(mean / q)
    return center, (mean / q - center), scale / q


def _dequantize(sym: torch.Tensor, rmin: int, center: torch.Tensor,
                q: torch.Tensor) -> torch.Tensor:
    """The value a symbol stands for: (sym + rmin + center) q."""
    return (sym.to(torch.float32) + rmin + center) * q


@torch.no_grad()
def gaussian_values(x, mean, scale, q) -> torch.Tensor:
    """What `decode_gaussian` returns for what `encode_gaussian` codes,
    computed on the encoder's side with the decoder's function."""
    x, mean, scale = _flat(x), _flat(mean), _flat(scale)
    q = _as_q(q, mean)
    res, center, _, _ = _residual_model(x, mean, scale, q)
    if res.numel() == 0:
        return torch.zeros(0, dtype=torch.float32, device=mean.device)
    rmin = int(res.min())
    return _dequantize(res - rmin, rmin, center, q)


def _mixture_model(means, scales, probs, q):
    """Flat [N] components -> (centre, [K, N] mu, sigma, weights in residual
    space), as the decoder recomputes them."""
    center = cdf_lib.mixture_center(means, probs, q)
    mu = torch.stack([m / q - center for m in means])
    sig = torch.stack([s / q for s in scales])
    return center, mu, sig, torch.stack(list(probs))


def _flat_mixture(means, scales, probs, q):
    means = [_flat(m) for m in means]
    return (means, [_flat(s) for s in scales], [_flat(p) for p in probs],
            _as_q(q, means[0]))


@torch.no_grad()
def mixture_values(x, means, scales, probs, q) -> torch.Tensor:
    """What `decode_gaussian_mixed` returns for what `encode_gaussian_mixed`
    codes, computed on the encoder's side with the decoder's function."""
    means, scales, probs, q = _flat_mixture(means, scales, probs, q)
    center = cdf_lib.mixture_center(means, probs, q)
    res = torch.round(_flat(x) / q) - center
    if res.numel() == 0:
        return torch.zeros(0, dtype=torch.float32, device=q.device)
    rmin = int(res.min())
    return _dequantize(res - rmin, rmin, center, q)


def _write(file_name: str, header: list, payload: bytes) -> None:
    with open(file_name, "wb") as f:
        for v in header:
            f.write(np.float32(v).tobytes())
        f.write(payload)


def encode_gaussian(x, mean, scale, q, file_name: str) -> int:
    """Arithmetic-encode x (flat [N]) under per-element Gaussian models of
    step q (a tensor shaped like mean, or a number). Returns the bits
    written."""
    x, mean, scale = _flat(x), _flat(mean), _flat(scale)
    q = _as_q(q, mean)
    res, _, mu_res, sig_res = _residual_model(x, mean, scale, q)
    if res.numel() == 0:
        payload, rmin, rmax = np.uint32(0).tobytes(), 0, 0
    else:
        host = torch.stack([res, mu_res, sig_res]).to(torch.float32).cpu().numpy()
        res_np = host[0].astype(np.int32)
        rmin, rmax = int(res_np.min()), int(res_np.max())
        payload = coder.encode_gauss(host[1], host[2],
                                     (res_np - rmin).astype(np.int16), rmin, rmax)
    _write(file_name, [rmin, rmax], payload)
    return (len(payload) + 8) * 8


def decode_gaussian(mean, scale, q, file_name: str) -> torch.Tensor:
    """Inverse of encode_gaussian: float32 [N] on mean's device."""
    mean, scale = _flat(mean), _flat(scale)
    q = _as_q(q, mean)
    with open(file_name, "rb") as f:
        rmin = int(np.frombuffer(f.read(4), dtype=np.float32)[0])
        rmax = int(np.frombuffer(f.read(4), dtype=np.float32)[0])
        payload = f.read()
    if mean.numel() == 0:
        return torch.zeros(0, dtype=torch.float32, device=mean.device)
    center, mu_res, sig_res = _residual_model_dec(mean, scale, q)
    host = torch.stack([mu_res, sig_res]).to(torch.float32).cpu().numpy()
    sym = coder.decode_gauss(host[0], host[1], payload, rmin, rmax)
    return _dequantize(torch.from_numpy(sym).to(mean.device), rmin, center, q)


def _binary_table(p1: float, n: int) -> np.ndarray:
    """[n, 3] uint16 rows of the two-symbol CDF at P(1) = p1 (clamped to
    [1e-6, 1 - 1e-6]), on the host: at scene scale the table is tens of
    MB and only the coder reads it."""
    p1_c = min(max(p1, 1e-6), 1.0 - 1e-6)
    row = cdf_lib.normalize_cdf_int16(
        torch.tensor([[0.0, 1.0 - p1_c, 1.0]], dtype=torch.float32))
    return np.broadcast_to(row.numpy().astype(np.uint16), (n, 3))


def encode_binary(x01, file_name: str) -> int:
    """Encode a {0, 1} tensor under one global p1. Returns the bits written."""
    x = torch.as_tensor(x01).reshape(-1).to(torch.float32).cpu().numpy()
    p1 = float(x.sum() / max(x.size, 1))
    payload = coder.encode_int16_cdf(_binary_table(p1, x.size), x.astype(np.int16))
    _write(file_name, [p1], payload)
    return (len(payload) + 4) * 8


def decode_binary(n: int, file_name: str, device="cpu") -> torch.Tensor:
    """Inverse of encode_binary: float32 {0, 1} [n] on `device`."""
    with open(file_name, "rb") as f:
        p1 = float(np.frombuffer(f.read(4), dtype=np.float32)[0])
        payload = f.read()
    sym = coder.decode_int16_cdf(_binary_table(p1, n), payload)
    return torch.from_numpy(sym.astype(np.float32)).to(device)


@torch.no_grad()
def encode_gaussian_mixed(x, means, scales, probs, q, file_name: str) -> int:
    """Arithmetic-encode x (flat [N]) under per-element mixtures of K
    Gaussians (means, scales, probs: K tensors shaped like x), of step q.
    Returns the bits written."""
    means, scales, probs, q = _flat_mixture(means, scales, probs, q)
    center, mu, sig, w = _mixture_model(means, scales, probs, q)
    res = torch.round(_flat(x) / q) - center
    if res.numel() == 0:
        payload, rmin, rmax = np.uint32(0).tobytes(), 0, 0
    else:
        k = len(means)
        host = torch.cat([res[None], mu, sig, w]).to(torch.float32).cpu().numpy()
        res_np = host[0].astype(np.int32)
        rmin, rmax = int(res_np.min()), int(res_np.max())
        payload = coder.encode_gauss(
            host[1:1 + k].T, host[1 + k:1 + 2 * k].T,
            (res_np - rmin).astype(np.int16), rmin, rmax,
            w=host[1 + 2 * k:].T)
    _write(file_name, [rmin, rmax], payload)
    return (len(payload) + 8) * 8


@torch.no_grad()
def decode_gaussian_mixed(means, scales, probs, q, file_name: str) -> torch.Tensor:
    """Inverse of encode_gaussian_mixed: float32 [N] on the means' device."""
    means, scales, probs, q = _flat_mixture(means, scales, probs, q)
    with open(file_name, "rb") as f:
        rmin = int(np.frombuffer(f.read(4), dtype=np.float32)[0])
        rmax = int(np.frombuffer(f.read(4), dtype=np.float32)[0])
        payload = f.read()
    if means[0].numel() == 0:
        return torch.zeros(0, dtype=torch.float32, device=q.device)
    k = len(means)
    center, mu, sig, w = _mixture_model(means, scales, probs, q)
    host = torch.cat([mu, sig, w]).to(torch.float32).cpu().numpy()
    sym = coder.decode_gauss(host[:k].T, host[k:2 * k].T, payload, rmin, rmax,
                             w=host[2 * k:].T)
    return _dequantize(torch.from_numpy(sym).to(q.device), rmin, center, q)


@torch.no_grad()
def factorized_table(params: dict, min_v: int, max_v: int, q) -> np.ndarray:
    """The uint16 CDF rows [C, Lp] of the factorized model over the symbols
    min_v..max_v (Lp = max_v - min_v + 2 edges at (s - 0.5) q), each
    channel's CDF rescaled to run from 0 to 1 before the int16
    normalisation; computed on the host in float32."""
    params = {k: [v.detach().to("cpu", torch.float32) for v in leaves]
              for k, leaves in params.items()}
    c = params["matrices"][0].shape[0]
    lp = max_v - min_v + 2
    samples = (torch.arange(lp, dtype=torch.float32) + (min_v - 0.5)) * float(q)
    logits = entropy_lib.factorized_logits_cumulative(
        params, samples[None, None, :].expand(c, 1, lp))
    cdf = torch.sigmoid(logits)[:, 0, :]  # [C, Lp], monotone in the symbol
    cdf = torch.clamp((cdf - cdf[:, :1])
                      / torch.clamp_min(cdf[:, -1:] - cdf[:, :1], 1e-9), 0.0, 1.0)
    return cdf_lib.normalize_cdf_int16(cdf).numpy().astype(np.uint16)


def _rows(table: np.ndarray, n: int) -> np.ndarray:
    """The channels' rows [C, Lp] repeated for n rows of values: [n C, Lp]."""
    c, lp = table.shape
    return np.ascontiguousarray(
        np.broadcast_to(table[None], (n, c, lp)).reshape(n * c, lp))


def encode_factorized(params: dict, x: torch.Tensor, q, file_name: str) -> int:
    """Arithmetic-encode the values x [N, C] at step q (a number) under the
    factorized model `params` (one CDF row a channel). Returns the bits
    written."""
    if x.dim() != 2:
        raise ValueError(f"x must be [N, C], got {tuple(x.shape)}")
    n, c = x.shape
    sym = quantize_to_symbols(x, q).cpu().numpy()
    if sym.size == 0:
        payload, min_v, max_v = np.uint32(0).tobytes(), 0, 0
    else:
        min_v, max_v = int(sym.min()), int(sym.max())
        table = factorized_table(params, min_v, max_v, q)
        payload = coder.encode_int16_cdf(
            _rows(table, n), (sym.reshape(-1) - min_v).astype(np.int16))
    _write(file_name, [min_v, max_v], payload)
    return (len(payload) + 8) * 8


def decode_factorized(params: dict, n: int, c: int, q,
                      file_name: str) -> torch.Tensor:
    """Inverse of encode_factorized: float32 [N, C] on the parameters'
    device."""
    dev = params["matrices"][0].device
    with open(file_name, "rb") as f:
        min_v = int(np.frombuffer(f.read(4), dtype=np.float32)[0])
        max_v = int(np.frombuffer(f.read(4), dtype=np.float32)[0])
        payload = f.read()
    if n * c == 0:
        return torch.zeros((n, c), dtype=torch.float32, device=dev)
    table = factorized_table(params, min_v, max_v, q)
    sym = coder.decode_int16_cdf(_rows(table, n), payload)
    vals = torch.from_numpy(sym.astype(np.float32)).reshape(n, c).to(dev)
    return (vals + min_v) * q
