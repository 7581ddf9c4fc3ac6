"""Train-time entropy models: differentiable bit estimators (counterpart of
gauspcc_tpu/core/entropy.py).

What the families' training objectives reach: `low_bound` with its
custom gradient, the quantized-Gaussian bits (HAC, TC-GS, CAT-3DGS), the
Gaussian-mixture bits (HAC++) and the binary-size estimate. The Bernoulli
bits and the fully factorized (Balle) model, which no family trains with,
complete the JAX package's set. All functions return per-element bits;
callers sum and normalise.
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


def _clamp_window(x, q, x_mean):
    """x clamped to x_mean +- 15000 q, bounds that carry no gradient."""
    if not USE_CLAMP:
        return x
    if x_mean is None:
        x_mean = x.mean()
    lo = (x_mean - CLAMP_STEPS * q).detach()
    hi = (x_mean + CLAMP_STEPS * q).detach()
    return torch.clamp(x, lo, hi)


def _bin_mass(x, mean, scale, q):
    """|CDF(x + q/2) - CDF(x - q/2)|, with the JAX package's gradient of |.|
    at 0 (+1, where torch.abs has 0): deep in the tails both CDFs round to
    the same float32 and the difference is exactly 0, but its gradient is
    not."""
    scale = torch.clamp_min(scale, 1e-9)
    diff = (_normal_cdf(x + 0.5 * q, mean, scale)
            - _normal_cdf(x - 0.5 * q, mean, scale))
    return torch.where(diff >= 0, diff, -diff)


def gaussian_bits(x, mean, scale, q=1.0, x_mean=None):
    """Bits of the quantized-Gaussian likelihood of x. x is first clamped to
    x_mean +- 15000 q."""
    x = _clamp_window(x, q, x_mean)
    return -torch.log2(low_bound(_bin_mass(x, mean, scale, q)))


def gaussian_mixture_bits(x, means, scales, probs, q=1.0, x_mean=None):
    """Bits of x under a mixture of quantized Gaussians (HAC++'s feature
    model): the likelihood is the probability-weighted sum of the
    components' bin masses. x is first clamped as in gaussian_bits."""
    x = _clamp_window(x, q, x_mean)
    likelihood = 0.0
    for mean, scale, prob in zip(means, scales, probs):
        likelihood = likelihood + prob * _bin_mass(x, mean, scale, q)
    return -torch.log2(low_bound(likelihood))


def bernoulli_bits(x: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Bits of x in {-1, +1} under P(+1) = p (p clipped to [1e-6, 1 - 1e-6])."""
    p = torch.clamp(p, 1e-6, 1.0 - 1e-6)
    pos_mask = (1.0 + x) / 2.0
    neg_mask = (1.0 - x) / 2.0
    return -torch.log2(p) * pos_mask + -torch.log2(1.0 - p) * neg_mask


def binary_size_bits(binary01: torch.Tensor):
    """Global-p1 binary entropy size estimate. Returns (p1, total_bits),
    +32 bits for storing p1."""
    total = binary01.numel()
    pos = binary01.sum()
    p1 = torch.clamp(pos / total, 1e-6, 1.0 - 1e-6)
    bits = pos * (-torch.log2(p1)) + (total - pos) * (-torch.log2(1.0 - p1)) + 32.0
    return p1, bits


# ---------------------------------------------------------------------------
# the fully factorized (Balle) entropy model
# ---------------------------------------------------------------------------

def init_factorized_params(channels: int, filters=(3, 3, 3),
                           init_scale: float = 10.0,
                           generator: torch.Generator | None = None) -> dict:
    """{"matrices", "biases", "factors"}: lists of float32 CPU tensors [C,
    d_out, d_in] (JAX's constant init), [C, d_out, 1] (U(-0.5, 0.5) from
    `generator`, not JAX's draws) and [C, d_out, 1] (zeros), for the
    channel widths (1, *filters, 1)."""
    dims = (1,) + tuple(int(f) for f in filters) + (1,)
    scale = init_scale ** (1.0 / (len(filters) + 1))
    matrices, biases, factors = [], [], []
    for i in range(len(filters) + 1):
        init = math.log(math.expm1(1.0 / scale / dims[i + 1]))
        matrices.append(torch.full((channels, dims[i + 1], dims[i]), init,
                                   dtype=torch.float32))
        u = torch.rand((channels, dims[i + 1], 1), generator=generator,
                       dtype=torch.float32)
        biases.append(u - 0.5)
        if i < len(filters):
            factors.append(torch.zeros((channels, dims[i + 1], 1),
                                       dtype=torch.float32))
    return {"matrices": matrices, "biases": biases, "factors": factors}


def factorized_logits_cumulative(params: dict, logits: torch.Tensor
                                 ) -> torch.Tensor:
    """logits [C, 1, N] -> [C, 1, N]: each channel's monotone scalar flow
    (softplus matrices, biases, tanh factors)."""
    n_layers = len(params["matrices"])
    for i in range(n_layers):
        matrix = torch.nn.functional.softplus(params["matrices"][i])
        logits = torch.matmul(matrix, logits) + params["biases"][i]
        if i < len(params["factors"]):
            logits = logits + torch.tanh(params["factors"][i]) * torch.tanh(logits)
    return logits


def factorized_bits(params: dict, x: torch.Tensor, q=1.0) -> torch.Tensor:
    """Bits of the quantized values x [N, C] under the factorized model, of
    step q (a number, or a tensor [N, C]) -> [N, C]."""
    xt = x.T[:, None, :]  # [C, 1, N]
    qt = q.T[:, None, :] if isinstance(q, torch.Tensor) and q.dim() == 2 else q
    lower = factorized_logits_cumulative(params, xt - 0.5 * (1.0 / qt))
    upper = factorized_logits_cumulative(params, xt + 0.5 * (1.0 / qt))
    sign = -torch.sign(lower + upper).detach()
    diff = torch.sigmoid(sign * upper) - torch.sigmoid(sign * lower)
    # |diff| with jnp.abs's gradient at 0 (+1), as `_bin_mass`
    likelihood = torch.where(diff >= 0, diff, -diff)
    bits = -torch.log2(low_bound(likelihood))
    return bits[:, 0, :].T
