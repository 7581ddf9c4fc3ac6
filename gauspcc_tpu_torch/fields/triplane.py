"""Triplane feature field and its conv autoencoder (counterpart of
gauspcc_tpu/fields/triplane.py), plain PyTorch.

A triplane is three [C, R, R] planes read at the axis-aligned projections
of a point: plane 0 at (y, z), plane 1 at (x, z), plane 2 at (x, y).
Points are first contracted into the radius-2 ball (Mip-NeRF 360). The
bilinear sample is JAX's own, not `F.grid_sample`'s: align_corners=False
pixel centres, four taps whose indices are clipped into the plane and
whose values are zeroed outside it. Its gradient with respect to the
plane is a scatter-add: autograd's in the plain sample, and, where
`sample_triplanes` reads triplanes under grad at one of K3's widths, the
hash grid's table gradient (`hashgrid.table_grad`) over the planes' rows.

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

from gauspcc_tpu_torch.fields import hashgrid

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


def _taps(u: torch.Tensor, v: torch.Tensor, h, w):
    """The four taps of bilinear samples at (u, v) in [-1, 1] (u along W,
    v along H) of planes of h x w pixels: u, v [N, L], a column a plane,
    with h and w ints or float [L] tensors of each plane's sizes. Returns
    (pixel [N, L, 4] int64, the tap's row yi * W + xi of its plane's
    pixel-major rows, its indices clipped into the plane; inside [N, L, 4]
    bool, whether it lies in the plane; wx, wy [N, L], the fractions), the
    taps in the order (x0, y0), (x0 + 1, y0), (x0, y0 + 1), (x0 + 1, y0 +
    1). Each element takes the same float32 operations whatever L."""
    x = (u + 1.0) * 0.5 * w - 0.5
    y = (v + 1.0) * 0.5 * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    if isinstance(w, torch.Tensor):
        h, w = h[:, None], w[:, None]
    xi = torch.stack([x0, x0 + 1, x0, x0 + 1], -1)
    yi = torch.stack([y0, y0, y0 + 1, y0 + 1], -1)
    inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    xi_c = xi.clamp_min(0).clamp_max(w - 1).to(torch.int64)
    yi_c = yi.clamp_min(0).clamp_max(h - 1).to(torch.int64)
    w_i = w if isinstance(w, int) else w.to(torch.int64)
    return yi_c * w_i + xi_c, inside, x - x0, y - y0


def _blend(v00, v01, v10, v11, wx, wy):
    """The bilinear sum of a sample's four taps [N, C] with the fractions
    wx, wy [N, 1]: the one expression both routes take, op for op."""
    return (v00 * (1 - wx) * (1 - wy) + v01 * wx * (1 - wy)
            + v10 * (1 - wx) * wy + v11 * wx * wy)


def grid_sample_2d(plane: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of plane [C, H, W] at uv [N, 2] in [-1, 1] ((u, v)
    = (x -> W, y -> H)), zero outside the plane. Returns [N, C]."""
    c, h, w = plane.shape
    pixel, inside, wx, wy = _taps(uv[:, :1], uv[:, 1:], h, w)
    rows = plane.permute(1, 2, 0).reshape(h * w, c)
    return _blend(*(torch.where(inside[:, 0, k, None], rows[pixel[:, 0, k]],
                                0.0) for k in range(4)), wx, wy)


def sample_triplane(planes: torch.Tensor, coords: torch.Tensor,
                    apply_contract: bool = True) -> torch.Tensor:
    """planes [3, C, R, R] at coords [N, 3] (normalised, unit-ball-ish):
    [N, 3C], the planes' features side by side."""
    x = contract(coords) if apply_contract else coords
    return torch.cat([
        grid_sample_2d(planes[p], torch.stack([x[:, a], x[:, b]], -1))
        for p, (a, b) in enumerate(PLANE_AXES)], -1)


def triplane_taps(planes: list, x: torch.Tensor):
    """The taps of triplanes [3, C, H_s, W_s] at x [N, 3], a level a plane
    (triplane by triplane, planes within one), every level in one set of
    operations: `_taps`'s (pixel, inside, wx, wy) with L levels, pixel
    offset to the plane's rows in `triplane_rows`. The levels' sizes and
    offsets are made on the device (no host-to-device copy)."""
    dev = x.device

    def per_level(values):  # one number a triplane -> [L], float32
        return torch.cat([torch.full((3,), float(n), device=dev)
                          for n in values])

    h = per_level(p.shape[2] for p in planes)
    w = per_level(p.shape[3] for p in planes)
    starts = np.cumsum([0] + [3 * p.shape[2] * p.shape[3] for p in planes])
    offset = torch.cat([torch.arange(3, device=dev) * (p.shape[2] * p.shape[3])
                        + int(start) for p, start in zip(planes, starts)])
    u = torch.stack([x[:, a] for a, _ in PLANE_AXES], 1).repeat(1, len(planes))
    v = torch.stack([x[:, b] for _, b in PLANE_AXES], 1).repeat(1, len(planes))
    pixel, inside, wx, wy = _taps(u, v, h, w)
    return pixel + offset[:, None], inside, wx, wy


def tap_weights(inside: torch.Tensor, wx: torch.Tensor,
                wy: torch.Tensor) -> torch.Tensor:
    """[N, L, 4] each tap's bilinear weight, exactly 0 outside its plane."""
    bilinear = torch.stack([(1 - wx) * (1 - wy), wx * (1 - wy),
                            (1 - wx) * wy, wx * wy], -1)
    return torch.where(inside, bilinear, 0.0)


def triplane_rows(planes: list) -> torch.Tensor:
    """Triplanes [3, C, H_s, W_s] as one table [sum 3 H_s W_s, C] of pixel
    rows, triplane by triplane, plane-major then y then x."""
    c = planes[0].shape[1]
    return torch.cat([p.permute(0, 2, 3, 1).reshape(-1, c) for p in planes])


class _Taps(torch.autograd.Function):
    """Every plane's taps into one table of pixel rows [rows, C]: the plain
    sample's forward, each element's operations as `grid_sample_2d` takes
    them, with the table's gradient from `hashgrid.table_grad` (K3 on CUDA
    tensors, its plain version on CPU tensors) over the taps' weights
    (`tap_weights`), and the fractions' gradient from the taps' rows
    dotted with the output's gradient. Takes the table, pixel and inside
    [N, L, 4] (no gradient), wx and wy [N, L]; returns [N, L C]."""

    @staticmethod
    def forward(ctx, table, pixel, inside, wx, wy):
        v = torch.where(inside[..., None], table[pixel], 0.0)  # [N, L, 4, C]
        out = _blend(v[:, :, 0], v[:, :, 1], v[:, :, 2], v[:, :, 3],
                     wx[..., None], wy[..., None])
        ctx.save_for_backward(table, pixel.to(torch.int32), inside, wx, wy)
        return out.reshape(out.shape[0], -1)

    @staticmethod
    def backward(ctx, grad_out):
        table, idx, inside, wx, wy = ctx.saved_tensors
        n, levels, _ = idx.shape
        g = grad_out.contiguous()
        grad_table = (hashgrid.table_grad(idx, tap_weights(inside, wx, wy), g,
                                          table.shape[0])
                      if ctx.needs_input_grad[0] else None)
        grad_wx = grad_wy = None
        if ctx.needs_input_grad[3] or ctx.needs_input_grad[4]:
            # each tap's row dotted with the gradient, 0 outside its plane
            s = torch.where(inside, (table[idx.long()] * g.reshape(
                n, levels, 1, -1)).sum(-1), 0.0)
            grad_wx = (s[..., 1] - s[..., 0]) * (1 - wy) \
                + (s[..., 3] - s[..., 2]) * wy
            grad_wy = (s[..., 2] - s[..., 0]) * (1 - wx) \
                + (s[..., 3] - s[..., 1]) * wx
        return grad_table, None, None, grad_wx, grad_wy


def sample_triplanes(planes: list, x: torch.Tensor) -> torch.Tensor:
    """Triplanes [3, C, R_s, R_s] of one C read at x [N, 3], taken as
    already contracted: [N, 3 C S], each `sample_triplane(p, x,
    apply_contract=False)` side by side, bit for bit.

    Under grad, where a triplane needs its gradient and C is one of K3's
    widths, every plane's taps are read in one set of operations through
    `_Taps` from `triplane_rows`: the planes' gradient is then
    `hashgrid.table_grad`'s deterministic segmented sum over the taps
    sorted by row (one K3 launch on CUDA), in place of autograd's
    accumulating `index_put_`, one a tap and plane, which walks a run of
    equal pixels in one warp. Every other call (no grad, as the codecs and
    evaluation run; other widths) takes the plain sample."""
    if not (torch.is_grad_enabled() and any(p.requires_grad for p in planes)
            and planes[0].shape[1] in hashgrid.KERNEL_FEATURES):
        return torch.cat([sample_triplane(p, x, apply_contract=False)
                          for p in planes], -1)
    pixel, inside, wx, wy = triplane_taps(planes, x)
    return _Taps.apply(triplane_rows(planes), pixel, inside, wx, wy)


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
