"""Port parity: the train-time quantization proxy, entropy models and L1
(gauspcc_tpu_torch.core.{quant,entropy}, utils.image.l1_loss) against the
JAX package on the same numpy inputs.

Tolerances: values rtol 1e-5, atol 1e-6 (float32 elementwise: erfc and
log2 are computed by other libraries on each side); gradients the same,
relative to each tensor's largest gradient; the custom gradients' masks
exact."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gauspcc_tpu.core import entropy as jentropy
from gauspcc_tpu.core import quant as jquant
from gauspcc_tpu.utils import image as jimage

from gauspcc_tpu_torch.core import entropy as tentropy
from gauspcc_tpu_torch.core import quant as tquant
from gauspcc_tpu_torch.utils import image as timage

RTOL, ATOL = 1e-5, 1e-6


def _close(got, want, err_msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL * max(1.0, float(np.abs(want).max())),
                               err_msg=err_msg)


def test_low_bound_value_and_custom_gradient():
    """Below the bound the gradient passes only where it pushes the value up
    (g < 0); at or above it, always."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(0, 2e-6, 50), rng.uniform(0, 1, 50)]
                       ).astype(np.float32)
    g = rng.normal(size=100).astype(np.float32)
    want, vjp = jax.vjp(jentropy.low_bound, jnp.asarray(x))
    (want_g,) = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_(True)
    got = tentropy.low_bound(tx)
    (got_g,) = torch.autograd.grad(got, tx, torch.from_numpy(g))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_g.numpy(), np.asarray(want_g))
    assert (got_g.numpy() == 0).any() and (got_g.numpy() != 0).any()


@pytest.mark.parametrize("per_row_q", [False, True])
def test_gaussian_bits_and_gradients_match_jax(per_row_q):
    """Bits of x under N(mean, scale) quantized by q, with the clamp window
    around x_mean; some x lie outside the window (no gradient there), some
    scales below 1e-9, and some likelihoods under the 1e-6 bound, among
    them ones deep in a tail, where both normal CDFs round to the same
    float32 and the likelihood is exactly 0 (JAX's gradient of |.| there is
    +1, which the port keeps)."""
    rng = np.random.default_rng(1)
    n, d = 40, 6
    mean = rng.normal(0, 1, (n, d)).astype(np.float32)
    scale = rng.uniform(-0.1, 2, (n, d)).astype(np.float32)
    x = (mean + np.maximum(scale, 0.05) * rng.uniform(-4, 4, (n, d))
         ).astype(np.float32)
    x[1, :4] = mean[1, :4] + np.maximum(scale[1, :4], 0.05) * np.array(
        [9.0, -12.0, 15.0, 6.5], np.float32)  # deep in a tail
    x[0, :3] = [1e5, -1e5, 3e4]  # outside x_mean +- 15000 q
    q = (rng.uniform(0.5, 1.5, (n, 1)) if per_row_q else np.float32(1.0))
    q = np.asarray(q, np.float32)
    x_mean = np.float32(x[1:].mean())

    def jf(x, mean, scale, q):
        return jentropy.gaussian_bits(x, mean, scale, q, x_mean=jnp.float32(x_mean))

    jargs = [jnp.asarray(a) for a in (x, mean, scale, q)]
    want = jf(*jargs)
    want_g = jax.grad(lambda *a: jnp.sum(jf(*a) * jnp.arange(1, n * d + 1).reshape(n, d) / (n * d)),
                      argnums=(0, 1, 2, 3))(*jargs)
    targs = [torch.from_numpy(np.array(a)).requires_grad_(True) for a in (x, mean, scale, q)]
    got = tentropy.gaussian_bits(*targs, x_mean=torch.tensor(x_mean))
    weights = torch.arange(1, n * d + 1, dtype=torch.float32).reshape(n, d) / (n * d)
    got_g = torch.autograd.grad((got * weights).sum(), targs)
    _close(got.detach().numpy(), want)
    for name, a, b in zip(("x", "mean", "scale", "q"), got_g, want_g):
        _close(a.numpy(), np.asarray(b).reshape(a.shape), err_msg=name)
    assert float(got_g[0][0, 0]) == 0.0  # clamped: no gradient
    at_bound = got.detach().numpy()[1, :4] > -np.log2(1e-6) - 1e-3
    assert at_bound.sum() >= 2
    assert (got_g[0].numpy()[1, :4] != 0).any()


def test_binary_size_bits_and_gradient_match_jax():
    rng = np.random.default_rng(2)
    table = rng.uniform(-1.5, 1.5, (300, 2)).astype(np.float32)

    def jf(t):
        return jentropy.binary_size_bits((jquant.ste_binary(t) + 1.0) / 2.0)[1]

    want, want_g = jax.value_and_grad(jf)(jnp.asarray(table))
    tt = torch.from_numpy(table).requires_grad_(True)
    p1, bits = tentropy.binary_size_bits((tquant.ste_binary(tt) + 1.0) / 2.0)
    (got_g,) = torch.autograd.grad(bits, tt)
    _close(float(bits.detach()), float(want))
    _close(got_g.numpy(), want_g)
    want_p1 = jentropy.binary_size_bits(
        (jquant.ste_binary(jnp.asarray(table)) + 1.0) / 2.0)[0]
    _close(float(p1), float(want_p1))


def test_uniform_noise_quant_with_jax_draw():
    """The same uniform draw gives the same noised values; without a draw
    the port draws from its generator, in [-q/2, q/2)."""
    x = np.random.default_rng(3).normal(size=(20, 5)).astype(np.float32)
    q = np.full((20, 1), 0.3, np.float32)
    key = jax.random.PRNGKey(7)
    u = np.asarray(jax.random.uniform(key, x.shape, jnp.float32))
    want = jquant.uniform_noise_quant(jnp.asarray(x), jnp.asarray(q), key)
    got = tquant.uniform_noise_quant(torch.from_numpy(x), torch.from_numpy(q),
                                     torch.from_numpy(u.copy()))
    _close(got.numpy(), want)
    gen = torch.Generator().manual_seed(0)
    drawn = tquant.uniform_noise_quant(torch.from_numpy(x), 0.3, generator=gen)
    noise = drawn.numpy() - x
    assert noise.min() >= -0.15 - 1e-6 and noise.max() < 0.15 + 1e-6
    assert tquant.USE_CLAMP == jquant.USE_CLAMP
    assert tquant.CLAMP_STEPS == jquant.CLAMP_STEPS


def test_l1_loss_matches_jax():
    rng = np.random.default_rng(4)
    a = rng.random((3, 20, 24)).astype(np.float32)
    b = rng.random((3, 20, 24)).astype(np.float32)
    _close(float(timage.l1_loss(torch.from_numpy(a), torch.from_numpy(b))),
           float(jimage.l1_loss(jnp.asarray(a), jnp.asarray(b))))
