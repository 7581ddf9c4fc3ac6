"""Train-time entropy models: differentiable bit estimators (counterpart of
gauspcc_tpu/core/entropy.py:20-94).

Only what HAC's training objective reaches: `low_bound` with its custom
gradient, the quantized-Gaussian bits and the binary-size estimate. The
mixture, Bernoulli and factorized estimators come with HAC++ and CAT.
All functions return per-element bits; callers sum and normalise.
"""

from __future__ import annotations

import math

import torch

from gauspcc_tpu_torch.core.quant import CLAMP_STEPS, USE_CLAMP

LIKELIHOOD_BOUND = 1e-6


class _LowBound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.clamp_min(x, LIKELIHOOD_BOUND)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * ((x >= LIKELIHOOD_BOUND) | (g < 0.0)).to(g.dtype)


def low_bound(x: torch.Tensor) -> torch.Tensor:
    """clamp(x, min=1e-6); the gradient passes where x >= the bound or where
    it pushes the value up (g < 0)."""
    return _LowBound.apply(x)


def _normal_cdf(x, mean, scale):
    return 0.5 * torch.special.erfc(-(x - mean) / (scale * math.sqrt(2.0)))


def gaussian_bits(x, mean, scale, q=1.0, x_mean=None):
    """Bits of the quantized-Gaussian likelihood of x. x is first clamped to
    x_mean +- 15000 q, bounds that carry no gradient."""
    if USE_CLAMP:
        if x_mean is None:
            x_mean = x.mean()
        lo = (x_mean - CLAMP_STEPS * q).detach()
        hi = (x_mean + CLAMP_STEPS * q).detach()
        x = torch.clamp(x, lo, hi)
    scale = torch.clamp_min(scale, 1e-9)
    diff = (_normal_cdf(x + 0.5 * q, mean, scale)
            - _normal_cdf(x - 0.5 * q, mean, scale))
    # |diff| with the JAX package's gradient at 0 (+1, where torch.abs has
    # 0): deep in the tails both CDFs round to the same float32 and the
    # difference is exactly 0, but its gradient is not
    likelihood = torch.where(diff >= 0, diff, -diff)
    return -torch.log2(low_bound(likelihood))


def binary_size_bits(binary01: torch.Tensor):
    """Global-p1 binary entropy size estimate. Returns (p1, total_bits),
    +32 bits for storing p1."""
    total = binary01.numel()
    pos = binary01.sum()
    p1 = torch.clamp(pos / total, 1e-6, 1.0 - 1e-6)
    bits = pos * (-torch.log2(p1)) + (total - pos) * (-torch.log2(1.0 - p1)) + 32.0
    return p1, bits
