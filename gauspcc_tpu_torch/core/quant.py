"""Straight-through quantizers, the anchors' 16-bit quantizer and the
train-time noise proxy (counterpart of gauspcc_tpu/core/quant.py).

`torch.round` rounds half to even, as `jnp.round` does. torch cannot draw
`jax.random`'s numbers, so `uniform_noise_quant` takes its uniform draw as
an argument (the tests hand both packages the same draw), or draws it from
an explicit `torch.Generator`.
"""

from __future__ import annotations

import torch

USE_CLAMP = True
CLAMP_STEPS = 15_000
ANCHOR_ROUND_DIGITS = 16  # bits per anchor coordinate in the size estimate
Q_ANCHOR = 1.0 / (2**ANCHOR_ROUND_DIGITS - 1)


class _STEBinary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.where(x >= 0, 1.0, -1.0).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * (x.abs() <= 1.0).to(g.dtype)


def ste_binary(x: torch.Tensor) -> torch.Tensor:
    """sign(x) in {-1, +1} with the gradient passed through on |x| <= 1."""
    return _STEBinary.apply(x)


class _STEMultistep(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, q, x_mean):
        x = torch.clamp(x, x_mean - CLAMP_STEPS * q, x_mean + CLAMP_STEPS * q)
        return torch.round(x / q) * q

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def ste_multistep(x: torch.Tensor, q: torch.Tensor,
                  x_mean: torch.Tensor) -> torch.Tensor:
    """round(x / q) * q after clamping x to x_mean +- 15000 q, with the
    gradient passed straight through to x."""
    return _STEMultistep.apply(x, q, x_mean)


def quantize_to_symbols(x: torch.Tensor, q) -> torch.Tensor:
    """round(x / q) as int32 symbols (offset by their minimum by the
    caller)."""
    return torch.round(x / q).to(torch.int32)


class _QuantizeAnchor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, anchors, min_v, max_v):
        interval = (max_v - min_v) * Q_ANCHOR + 1e-6
        quantized_v = torch.floor((anchors - min_v) / interval)
        quantized_v = torch.clamp(quantized_v, 0, 2**ANCHOR_ROUND_DIGITS - 1)
        ctx.mark_non_differentiable(quantized_v)
        return quantized_v * interval + min_v, quantized_v

    @staticmethod
    def backward(ctx, g_anchors, g_quantized):
        return g_anchors, None, None


def quantize_anchor(anchors: torch.Tensor, min_v: torch.Tensor,
                    max_v: torch.Tensor):
    """16-bit bounded anchor quantization: (anchors_q, the level indices,
    as floats) on a grid of 2^16 - 1 steps from min_v to max_v. The
    gradient passes to `anchors` unchanged; the bounds get none."""
    return _QuantizeAnchor.apply(anchors, min_v, max_v)


def ste_round(x: torch.Tensor) -> torch.Tensor:
    """round(x) with identity gradient."""
    return x + (torch.round(x) - x).detach()


def uniform_noise_quant(x: torch.Tensor, q, u: torch.Tensor | None = None,
                        generator: torch.Generator | None = None
                        ) -> torch.Tensor:
    """Train-time additive-uniform quantization proxy: x + (u - 0.5) q, with
    u ~ U[0, 1) shaped like x: `u` if given, else drawn from `generator`."""
    if u is None:
        u = torch.rand(x.shape, generator=generator, dtype=x.dtype,
                       device=x.device)
    return x + (u - 0.5) * q
