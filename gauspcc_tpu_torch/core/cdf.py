"""CDF tables for the entropy coders (counterpart of
gauspcc_tpu/core/cdf.py:21-97).

A table is int32 `[N, Lp]` holding the uint16 values of the JAX package's
tables: strictly increasing rows from 0, the final column (conceptually
2^16) wrapped to 0. torch has no uint16 arithmetic on the CPU, so the
values live in int32 and are masked to 16 bits.

The cumulative sum runs column by column, left to right: a fixed order,
so the encoder and the decoder compute the same tables on the same
device, and no scan kernel chooses its own order. The discretized
Gaussian tables are HAC's attribute models and the mixture tables HAC++'s
feature models; the native coder evaluates the same CDFs itself
(`ops/coder.encode_gauss`), so the coding path reaches only
`mixture_center`, and the tables are the tests' oracles.
"""

from __future__ import annotations

import math

import torch


def normalize_cdf_int16(cdf_float: torch.Tensor) -> torch.Tensor:
    """[N, Lp] float cdf in [0, 1] -> strictly monotone uint16 rows (int32).

    Scale by 2^16 - (Lp - 1), round half to even, add the column index
    (GausPcgc/kit/op.py:50-79); the last column wraps to 0."""
    lp = cdf_float.shape[-1]
    new_max = 2.0**16 - (lp - 1)
    v = torch.round(cdf_float.to(torch.float32) * new_max).to(torch.int32)
    v = v + torch.arange(lp, dtype=torch.int32, device=v.device)
    return v & 0xFFFF


def probs_to_cdf_int16(probs: torch.Tensor) -> torch.Tensor:
    """[N, L] per-symbol probabilities -> [N, L+1] normalized CDF rows:
    prepend 0, cumulative sum, clamp to [0, 1], int16-normalize."""
    cols = [torch.zeros_like(probs[..., 0])]
    for j in range(probs.shape[-1]):
        cols.append(cols[-1] + probs[..., j])
    cdf = torch.stack(cols, dim=-1).clamp(0.0, 1.0)
    return normalize_cdf_int16(cdf)


def gaussian_cdf(x: torch.Tensor, mean: torch.Tensor,
                 scale: torch.Tensor) -> torch.Tensor:
    """Phi((x - mean) / scale) through erfc."""
    return 0.5 * torch.special.erfc(-(x - mean) / (scale * math.sqrt(2.0)))


def _table(samples, mean, scale):
    scale = torch.clamp_min(scale, 1e-9)
    cdf = gaussian_cdf(samples, mean[:, None], scale[:, None])
    return normalize_cdf_int16(cdf.clamp(0.0, 1.0))


def _mixture_table(samples, means, scales, probs):
    acc = torch.zeros_like(samples)
    for mean, scale, prob in zip(means, scales, probs):
        scale = torch.clamp_min(scale, 1e-9)
        acc = acc + prob[:, None] * gaussian_cdf(samples, mean[:, None],
                                                 scale[:, None])
    return normalize_cdf_int16(acc.clamp(0.0, 1.0))


def gaussian_cdf_table(mean: torch.Tensor, scale: torch.Tensor,
                       q: torch.Tensor, min_value: int,
                       max_value: int) -> torch.Tensor:
    """Per-row discretized-Gaussian CDF table, int16-normalized: [N, Lp],
    Lp = max - min + 2; row i, column j holds
    Phi(((min_value + j) - 0.5) q[i]; mean[i], scale[i])."""
    lp = int(max_value) - int(min_value) + 2
    cols = torch.arange(lp, dtype=torch.float32, device=mean.device)
    return _table((cols + (min_value - 0.5)) * q[:, None], mean, scale)


def gaussian_cdf_table_residual(mean: torch.Tensor, scale: torch.Tensor,
                                q: torch.Tensor, rmin: int,
                                rmax: int) -> torch.Tensor:
    """The table over residuals r = round(x / q) - round(mean / q): the
    columns cover rmin..rmax around each row's centre round(mean / q),
    which encoder and decoder both compute from the shared model."""
    lp = int(rmax) - int(rmin) + 2
    offset = torch.round(mean / q)
    cols = torch.arange(lp, dtype=torch.float32, device=mean.device)
    return _table((offset[:, None] + cols + (rmin - 0.5)) * q[:, None],
                  mean, scale)


def gaussian_mixture_cdf_table(means: list, scales: list, probs: list,
                               q: torch.Tensor, min_value: int,
                               max_value: int) -> torch.Tensor:
    """The mixture's table (gauspcc_tpu/core/cdf.py:99): column j of row i
    holds sum_k probs[k][i] Phi(((min_value + j) - 0.5) q[i]; means[k][i],
    scales[k][i]), clamped to [0, 1], int16-normalized."""
    lp = int(max_value) - int(min_value) + 2
    cols = torch.arange(lp, dtype=torch.float32, device=q.device)
    samples = (cols + (min_value - 0.5)) * q[:, None]
    return _mixture_table(samples, means, scales, probs)


def mixture_center(means: list, probs: list, q: torch.Tensor) -> torch.Tensor:
    """round(sum_k probs[k] means[k] / q), the per-element centre of the
    mixture's residuals; encoder and decoder compute it alike."""
    m = torch.zeros_like(means[0])
    for mean, prob in zip(means, probs):
        m = m + prob * mean
    return torch.round(m / q)


def gaussian_mixture_cdf_table_residual(means: list, scales: list,
                                        probs: list, q: torch.Tensor,
                                        rmin: int, rmax: int) -> torch.Tensor:
    """The mixture's table over residuals around `mixture_center`."""
    lp = int(rmax) - int(rmin) + 2
    offset = mixture_center(means, probs, q)
    cols = torch.arange(lp, dtype=torch.float32, device=q.device)
    samples = (offset[:, None] + cols + (rmin - 0.5)) * q[:, None]
    return _mixture_table(samples, means, scales, probs)
