"""Per-group Adam with exponential learning-rate schedules (counterpart of
gauspcc_tpu/utils/optim.py:19-88).

The learning rate of a group is log-lerped from init to final over
max_steps with an optional delayed warm-up multiplier, computed on the host
in float32 as the JAX package computes it. `GroupAdam` is a functional Adam
over a flat dict of leaves ("anchors/offset", "nets/mlp_color/fc0/weight",
...): its state is plain dicts of moments, so densification can remap the
per-anchor moments row by row. It updates the moments and the leaves in
place, which saves a copy of every parameter; the arithmetic is optax's
scale_by_adam followed by the group's -lr(step), with the step counter
incremented before the lr is read, so the first update uses lr(1).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from gauspcc_tpu_torch.utils import profiling


def expon_lr(lr_init, lr_final, max_steps, lr_delay_steps=0,
             lr_delay_mult=1.0, step_sub=0) -> Callable[[int], float]:
    """f(step) -> lr, the reference's get_expon_lr_func, in float32."""
    f32 = np.float32

    def f(step) -> float:
        step = f32(step) - f32(step_sub)
        if lr_init == 0.0 or lr_final == 0.0:
            return 0.0
        if lr_delay_steps > 0:
            delay_rate = f32(lr_delay_mult) + f32(1 - lr_delay_mult) * np.sin(
                f32(0.5 * np.pi) * np.clip(step / f32(lr_delay_steps), f32(0), f32(1)))
        else:
            delay_rate = f32(1.0)
        t = np.clip(step / f32(max_steps), f32(0), f32(1))
        log_lerp = np.exp(f32(np.log(lr_init)) * (f32(1) - t)
                          + f32(np.log(lr_final)) * t)
        lr = f32(delay_rate * log_lerp)
        return 0.0 if step < 0 else float(lr)

    return f


class GroupAdam:
    """Adam whose step size per leaf is group_lr[group_of(name)](step); a
    leaf whose group is None is frozen (zero update)."""

    def __init__(self, group_lr: dict[str, Callable], group_of: Callable,
                 eps: float = 1e-15, b1: float = 0.9, b2: float = 0.999):
        self.group_lr = group_lr
        self.group_of = group_of
        self.eps, self.b1, self.b2 = eps, b1, b2

    def init(self, leaves: dict[str, torch.Tensor]) -> dict:
        zeros = {k: torch.zeros_like(v, memory_format=torch.contiguous_format)
                 for k, v in leaves.items()}
        return {"mu": zeros,
                "nu": {k: torch.zeros_like(v) for k, v in zeros.items()},
                "count": 0}

    @torch.no_grad()
    @profiling.span("optim.update")
    def update(self, grads: dict[str, torch.Tensor], state: dict,
               leaves: dict[str, torch.Tensor]) -> dict:
        """One step: the moments and every leaf updated in place; returns
        the state with its counter advanced."""
        count = state["count"] + 1
        f32 = np.float32
        bc1 = float(f32(1) - f32(self.b1) ** f32(count))
        bc2 = float(f32(1) - f32(self.b2) ** f32(count))
        lrs = {name: fn(count) for name, fn in self.group_lr.items()}
        for name, p in leaves.items():
            g = grads[name]
            mu, nu = state["mu"][name], state["nu"][name]
            mu.mul_(self.b1).add_((1 - self.b1) * g)
            nu.mul_(self.b2).add_((1 - self.b2) * (g * g))
            group = self.group_of(name)
            if group is None:
                continue
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            p.add_(-lrs[group] * u)
        return dict(state, count=count)
