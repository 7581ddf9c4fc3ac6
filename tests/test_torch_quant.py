"""Port parity: straight-through quantizers (gauspcc_tpu_torch.core.quant
against gauspcc_tpu.core.quant) on the same numpy inputs.

Tolerances: forward values and symbols are exact (the same IEEE divide,
round-half-even and multiply on both sides); gradients are exact."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gauspcc_tpu.core import quant as jq
from gauspcc_tpu_torch.core import quant as tq


@pytest.mark.parametrize("seed", [0, 1])
def test_ste_binary_forward_and_gradient(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1.5, (64, 3)).astype(np.float32)
    x[0, 0] = 0.0  # sign(0) is +1 on both sides
    g = rng.normal(size=x.shape).astype(np.float32)

    want = np.asarray(jq.ste_binary(jnp.asarray(x)))
    want_grad = np.asarray(jax.grad(
        lambda v: jnp.sum(jq.ste_binary(v) * g))(jnp.asarray(x)))

    xt = torch.from_numpy(x).requires_grad_(True)
    got = tq.ste_binary(xt)
    (got * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(got.detach().numpy(), want)
    np.testing.assert_array_equal(xt.grad.numpy(), want_grad)


@pytest.mark.parametrize("q_shape", [(50, 1), (50, 1, 3)])
def test_ste_multistep_symbols_exact(q_shape):
    rng = np.random.default_rng(7)
    x_shape = (50, 6) if len(q_shape) == 2 else (50, 4, 3)
    x = rng.normal(0, 0.5, x_shape).astype(np.float32)
    q = (rng.uniform(0.001, 0.3, q_shape)).astype(np.float32)
    x_mean = np.float32(0.05)
    # values far outside the x_mean +- 15000 q clamp window
    x.reshape(-1)[:4] = [1e4, -1e4, 3e3, -3e3]

    want = np.asarray(jq.ste_multistep(jnp.asarray(x), jnp.asarray(q),
                                       jnp.asarray(x_mean)))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tq.ste_multistep(xt, torch.from_numpy(q), torch.tensor(x_mean))
    np.testing.assert_array_equal(got.detach().numpy(), want)
    np.testing.assert_array_equal(np.round(got.detach().numpy() / q),
                                  np.round(want / q))
    got.sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), np.ones_like(x))


def test_ste_round_half_to_even():
    x = np.array([0.5, 1.5, 2.5, -0.5, -1.5, 0.49, 3.7], np.float32)
    want = np.asarray(jq.ste_round(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tq.ste_round(xt)
    np.testing.assert_array_equal(got.detach().numpy(), want)
    got.sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), np.ones_like(x))
