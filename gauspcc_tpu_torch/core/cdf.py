"""CDF tables for the entropy coders (counterpart of
gauspcc_tpu/core/cdf.py:21-45).

A table is int32 `[N, Lp]` holding the uint16 values of the JAX package's
tables: strictly increasing rows from 0, the final column (conceptually
2^16) wrapped to 0. torch has no uint16 arithmetic on the CPU, so the
values live in int32 and are masked to 16 bits.

The cumulative sum runs column by column, left to right: a fixed order,
so the encoder and the decoder compute the same tables on the same
device, and no scan kernel chooses its own order. The Gaussian tables
come with HAC's attribute coding.
"""

from __future__ import annotations

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
