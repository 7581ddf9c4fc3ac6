"""Triplane feature field and its conv autoencoder (counterpart of
gauspcc_tpu/fields/triplane.py), plain PyTorch.

A triplane is three [C, R, R] planes read at the axis-aligned projections
of a point: plane 0 at (y, z), plane 1 at (x, z), plane 2 at (x, y).
Points are first contracted into the radius-2 ball (Mip-NeRF 360). The
bilinear sample is JAX's own, not `F.grid_sample`'s: align_corners=False
pixel centres, four taps whose indices are clipped into the plane and
whose values are zeroed outside it. Its gradient with respect to the
plane is a scatter-add.

The autoencoder (TC-GS's, three stride-2 3x3 convs down to an 8-channel
latent and three stride-2 transposed convs back, a sigmoid at the end)
keeps JAX's weights as they are stored there: `w` [3, 3, Cin, Cout] (HWIO)
and `b` [Cout]. Its convs take JAX's "SAME" padding, which
`torch.nn.Conv2d` does not reproduce: a stride-2 conv pads 0 before and
1 after; a transposed conv (`lax.conv_transpose`, transpose_kernel=False)
dilates its input by 2, pads it 2 before and 1 after, and correlates it
with the unflipped kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

PLANE_AXES = ((1, 2), (0, 2), (0, 1))  # (y,z), (x,z), (x,y)
_EPS = float(np.finfo(np.float32).eps)


def contract(x: torch.Tensor) -> torch.Tensor:
    """Identity inside the unit ball, else (2 - 1/|x|) x/|x|; |x|^2 is
    floored at float32's eps."""
    mag_sq = torch.clamp_min((x * x).sum(-1, keepdim=True), _EPS)
    # the square root correctly rounded, as XLA's (torch's vectorised CPU
    # sqrt is off by an ulp now and then)
    mag = torch.sqrt(mag_sq.double()).to(mag_sq.dtype)
    return torch.where(mag_sq <= 1.0, x, ((2.0 * mag - 1.0) / mag_sq) * x)


def grid_sample_2d(plane: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of plane [C, H, W] at uv [N, 2] in [-1, 1] ((u, v)
    = (x -> W, y -> H)), zero outside the plane. Returns [N, C]."""
    c, h, w = plane.shape
    x = (uv[:, 0] + 1.0) * 0.5 * w - 0.5
    y = (uv[:, 1] + 1.0) * 0.5 * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = (x - x0)[:, None]
    wy = (y - y0)[:, None]
    rows = plane.permute(1, 2, 0).reshape(h * w, c)

    def tap(xi, yi):
        inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        xi_c = torch.clamp(xi, 0, w - 1).to(torch.int64)
        yi_c = torch.clamp(yi, 0, h - 1).to(torch.int64)
        return torch.where(inside[:, None], rows[yi_c * w + xi_c], 0.0)

    v00 = tap(x0, y0)
    v01 = tap(x0 + 1, y0)
    v10 = tap(x0, y0 + 1)
    v11 = tap(x0 + 1, y0 + 1)
    return (v00 * (1 - wx) * (1 - wy) + v01 * wx * (1 - wy)
            + v10 * (1 - wx) * wy + v11 * wx * wy)


def sample_triplane(planes: torch.Tensor, coords: torch.Tensor,
                    apply_contract: bool = True) -> torch.Tensor:
    """planes [3, C, R, R] at coords [N, 3] (normalised, unit-ball-ish):
    [N, 3C], the planes' features side by side."""
    x = contract(coords) if apply_contract else coords
    return torch.cat([
        grid_sample_2d(planes[p], torch.stack([x[:, a], x[:, b]], -1))
        for p, (a, b) in enumerate(PLANE_AXES)], -1)


def init_triplane(n_feat: int, resolution: int, rng: np.random.Generator,
                  std: float = 0.1, n_planes: int = 3) -> torch.Tensor:
    """Planes [n_planes, n_feat, R, R] of N(0, std^2), drawn from a numpy
    Generator, on the CPU."""
    shape = (n_planes, n_feat, resolution, resolution)
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)) * std


class AEConfig(NamedTuple):
    feat: int
    compressed_dim: int = 8


class Conv(nn.Module):
    """A 3x3 conv's weights in JAX's layout: w [3, 3, Cin, Cout], b [Cout]."""

    def __init__(self, cin: int, cout: int, k: int = 3):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(k, k, cin, cout))
        self.b = nn.Parameter(torch.zeros(cout))

    @torch.no_grad()
    def init_uniform(self, rng: np.random.Generator) -> "Conv":
        """U(+-1/sqrt(Cin k^2)) for w and b (the JAX package's _conv_init)."""
        k, _, cin, _ = self.w.shape
        bound = 1.0 / np.sqrt(cin * k * k)
        for p in (self.w, self.b):
            p.copy_(torch.from_numpy(
                rng.uniform(-bound, bound, tuple(p.shape)).astype(np.float32)))
        return self

    def weight(self) -> torch.Tensor:
        """w as F.conv2d takes it, [Cout, Cin, k, k]."""
        return self.w.permute(3, 2, 0, 1)


def _same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    """JAX's "SAME" padding of one axis of n for a stride-s conv."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv2d(p: Conv, x: torch.Tensor, stride: int) -> torch.Tensor:
    """lax.conv_general_dilated(x, w, stride, "SAME") + b, NCHW."""
    k = p.w.shape[0]
    ph = _same_pads(x.shape[2], k, stride)
    pw = _same_pads(x.shape[3], k, stride)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(x, p.weight(), p.b, stride=stride)


def deconv2d(p: Conv, x: torch.Tensor, stride: int) -> torch.Tensor:
    """lax.conv_transpose(x, w, stride, "SAME") + b, NCHW: the input
    dilated by `stride`, padded as lax pads it, correlated with the
    unflipped kernel."""
    k = p.w.shape[0]
    n, c, h, w = x.shape
    up = x.new_zeros((n, c, (h - 1) * stride + 1, (w - 1) * stride + 1))
    up[:, :, ::stride, ::stride] = x
    pad_len = k + stride - 2
    before = k - 1 if stride > k - 1 else -(-pad_len // 2)
    after = pad_len - before
    up = F.pad(up, (before, after, before, after))
    return F.conv2d(up, p.weight(), p.b)


class Autoencoder(nn.Module):
    """TC-GS's conv autoencoder over the planes: enc0..enc2 (stride 2,
    ReLU) to the latent, dec0..dec2 (transposed, stride 2, ReLU, then a
    sigmoid) back."""

    def __init__(self, cfg: AEConfig):
        super().__init__()
        comp = cfg.compressed_dim
        self.enc0 = Conv(cfg.feat, 16)
        self.enc1 = Conv(16, 32)
        self.enc2 = Conv(32, comp)
        self.dec0 = Conv(comp, 32)
        self.dec1 = Conv(32, 16)
        self.dec2 = Conv(16, cfg.feat)

    @torch.no_grad()
    def init_uniform(self, rng: np.random.Generator) -> "Autoencoder":
        for m in self.children():
            m.init_uniform(rng)
        return self


def decode_latent(ae: Autoencoder, latent: torch.Tensor) -> torch.Tensor:
    """latent [P, comp, r, r] -> planes [P, C, 8r, 8r] in (0, 1)."""
    d = torch.relu(deconv2d(ae.dec0, latent, 2))
    d = torch.relu(deconv2d(ae.dec1, d, 2))
    return torch.sigmoid(deconv2d(ae.dec2, d, 2))


def autoencode(ae: Autoencoder, planes: torch.Tensor):
    """planes [P, C, R, R] -> (latent [P, comp, R/8, R/8], reconstruction
    [P, C, R, R] in (0, 1))."""
    h = torch.relu(conv2d(ae.enc0, planes, 2))
    h = torch.relu(conv2d(ae.enc1, h, 2))
    z = torch.relu(conv2d(ae.enc2, h, 2))
    return z, decode_latent(ae, z)
