"""Image losses and metrics: L1, PSNR and SSIM with an 11x11 Gaussian window
(counterpart of gauspcc_tpu/utils/image.py:15-68). Images are [C, H, W]
in [0, 1]."""

from __future__ import annotations

import functools

import numpy as np
import torch


def l1_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a - b).abs().mean()


def psnr(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    mse = ((a - b) ** 2).mean()
    return 20.0 * torch.log10(1.0 / torch.sqrt(torch.clamp_min(mse, 1e-12)))


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size) - size // 2
    g = np.exp(-(x**2) / (2 * sigma**2))
    return (g / g.sum()).astype(np.float32)


def _band(n: int, win: np.ndarray) -> np.ndarray:
    """[n, n] matrix of the zero-padded 'same' convolution with `win`."""
    t = np.arange(n)[None, :] - np.arange(n)[:, None] + len(win) // 2
    inside = (t >= 0) & (t < len(win))
    return np.where(inside, win[np.clip(t, 0, len(win) - 1)], 0.0).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _band_on(n: int, device: torch.device) -> torch.Tensor:
    """The 11x11 window's band matrix for n, made once per device (a copy
    to the card on every call would cost a transfer and a host wait)."""
    return torch.from_numpy(_band(n, _gaussian_window())).to(device)


def _filter2d(img: torch.Tensor) -> torch.Tensor:
    """Separable zero-padded 'same' 11x11 Gaussian filter over [C, H, W], as
    two float32 matrix products (full float32: matmuls do not run in TF32
    unless asked, where cuDNN convolutions would)."""
    _, h, w = img.shape
    return _band_on(h, img.device) @ img @ _band_on(w, img.device).T


def ssim(a: torch.Tensor, b: torch.Tensor, c1: float = 0.01**2,
         c2: float = 0.03**2) -> torch.Tensor:
    mu_a = _filter2d(a)
    mu_b = _filter2d(b)
    mu_aa = mu_a * mu_a
    mu_bb = mu_b * mu_b
    mu_ab = mu_a * mu_b
    sigma_aa = _filter2d(a * a) - mu_aa
    sigma_bb = _filter2d(b * b) - mu_bb
    sigma_ab = _filter2d(a * b) - mu_ab
    m = ((2 * mu_ab + c1) * (2 * sigma_ab + c2)) / (
        (mu_aa + mu_bb + c1) * (sigma_aa + sigma_bb + c2))
    return m.mean()
