"""Two-layer MLPs (counterpart of gauspcc_tpu/core/nn.py:10-32).

The JAX package keeps a dense weight as `w [in, out]` and computes
`x @ w + b`; `nn.Linear.weight` is `[out, in]`, so carried weights are
transposed (see `convert.py`).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


class MLP2(nn.Module):
    """relu(x @ W0 + b0) @ W1 + b1, with an optional output activation."""

    def __init__(self, d_in: int, d_hidden: int, d_out: int):
        super().__init__()
        self.fc0 = nn.Linear(d_in, d_hidden)
        self.fc1 = nn.Linear(d_hidden, d_out)

    def forward(self, x: torch.Tensor, out_act=None) -> torch.Tensor:
        y = self.fc1(torch.relu(self.fc0(x)))
        return out_act(y) if out_act is not None else y

    @torch.no_grad()
    def init_uniform(self, rng: np.random.Generator) -> "MLP2":
        """torch.nn.Linear's default law, U(+-1/sqrt(fan_in)) for weight and
        bias (the JAX package's dense_init), drawn from a numpy Generator."""
        for fc in (self.fc0, self.fc1):
            bound = 1.0 / np.sqrt(fc.in_features)
            for p in (fc.weight, fc.bias):
                p.copy_(torch.from_numpy(
                    rng.uniform(-bound, bound, tuple(p.shape)).astype(np.float32)))
        return self
