"""File-level entropy coding of quantized tensors (counterpart of
gauspcc_tpu/ops/entropy_coding.py:30-168, :213-256).

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
The factorized coders wait for ROADMAP.md Queue 1 item 7h.
"""

from __future__ import annotations

import numpy as np
import torch

from gauspcc_tpu_torch.core import cdf as cdf_lib
from gauspcc_tpu_torch.ops import coder

_LATER = ("the factorized coders are not ported yet: no family of the port "
          "calls them (ROADMAP.md Queue 1 item 7h)")


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


def encode_factorized(*args, **kwargs):
    raise NotImplementedError(_LATER)


def decode_factorized(*args, **kwargs):
    raise NotImplementedError(_LATER)
