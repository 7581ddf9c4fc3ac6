"""The LPIPS perceptual distance: VGG16 features at relu{1_2, 2_2, 3_3,
4_3, 5_3}, unit-normalised per pixel, squared differences weighted by
linear heads, averaged over pixels and summed over the five blocks
(counterpart of gauspcc_tpu/utils/lpips.py).

No VGG weights can be fetched, so the weights come from a local `.npz`
(keys conv{i}_w [kh, kw, cin, cout], conv{i}_b [cout], lin{j}_w [c]): an
explicit path, $GAUSPCC_LPIPS_WEIGHTS, or lpips_vgg.npz beside this file.
Without one, `load_default_lpips` uses the seeded random-feature surrogate
(`random_weights(1234)`, variant "vgg_random_v1"): deterministic, a
relative perceptual distance, not comparable with published LPIPS.

The convolutions run in float32 without TF32 (`_exact_gemms`), so the card
agrees with the CPU.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gauspcc_tpu_torch.codecs.gauspcgc.codec import _exact_gemms
from gauspcc_tpu_torch.device import resolve

# VGG16's conv layout: (out_channels, n_convs) a block
_BLOCKS = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

_DEFAULT_PATH = os.path.join(os.path.dirname(__file__), "lpips_vgg.npz")

PRETRAINED, SURROGATE = "vgg16_pretrained", "vgg_random_v1"


def _normalize(x: torch.Tensor) -> torch.Tensor:
    """Unit length over the channels [1, C, H, W], the eps inside the root."""
    return x / torch.sqrt((x * x).sum(1, keepdim=True) + 1e-10)


class LPIPS(nn.Module):
    """lpips(a, b) for images [3, H, W] in [0, 1] on the module's device;
    returns a 0-dim float32 tensor. `variant` names the weights."""

    def __init__(self, weights: dict, variant: str = PRETRAINED,
                 device="cuda"):
        super().__init__()
        dev = resolve(device)
        self.variant = variant
        n_convs = sum(n for _, n in _BLOCKS)
        for i in range(n_convs):
            w = np.asarray(weights[f"conv{i}_w"], np.float32)  # HWIO
            self.register_buffer(f"conv{i}_w", torch.from_numpy(
                w.transpose(3, 2, 0, 1).copy()).to(dev))  # OIHW
            self.register_buffer(f"conv{i}_b", torch.from_numpy(
                np.asarray(weights[f"conv{i}_b"], np.float32)).to(dev))
        for j in range(len(_BLOCKS)):
            self.register_buffer(f"lin{j}_w", torch.from_numpy(
                np.asarray(weights[f"lin{j}_w"], np.float32)).to(dev))
        self.register_buffer("shift", torch.from_numpy(_SHIFT).to(dev))
        self.register_buffer("scale", torch.from_numpy(_SCALE).to(dev))

    def features(self, img: torch.Tensor) -> list[torch.Tensor]:
        x = img.to(torch.float32)[None]
        x = (x * 2.0 - 1.0 - self.shift[:, None, None]) / self.scale[:, None, None]
        feats = []
        ci = 0
        for bi, (_, n_convs) in enumerate(_BLOCKS):
            for _ in range(n_convs):
                x = F.relu(F.conv2d(x, getattr(self, f"conv{ci}_w"),
                                    getattr(self, f"conv{ci}_b"), padding=1))
                ci += 1
            feats.append(x)
            if bi < len(_BLOCKS) - 1:
                x = F.max_pool2d(x, 2, 2)  # VALID: odd sizes floor
        return feats

    @torch.no_grad()
    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        with _exact_gemms():
            fa, fb = self.features(a), self.features(b)
        total = torch.zeros((), dtype=torch.float32, device=self.shift.device)
        for j, (xa, xb) in enumerate(zip(fa, fb)):
            d = (_normalize(xa) - _normalize(xb)) ** 2
            lin = getattr(self, f"lin{j}_w")
            total = total + (d * lin[None, :, None, None]).sum(1).mean()
        return total


def weights_path(path: str | None = None) -> str:
    """The weights file load_default_lpips reads: `path`, else
    $GAUSPCC_LPIPS_WEIGHTS, else lpips_vgg.npz beside this module."""
    if path is None:
        path = os.environ.get("GAUSPCC_LPIPS_WEIGHTS", _DEFAULT_PATH)
    return path


def load_default_lpips(path: str | None = None, allow_surrogate: bool = True,
                       device="cuda") -> LPIPS:
    """The LPIPS module of the weights at `weights_path(path)`, variant
    "vgg16_pretrained"; without that file the seeded surrogate (variant
    "vgg_random_v1") when `allow_surrogate`, else FileNotFoundError. A
    consumer checks `.variant` before comparing with published LPIPS."""
    path = weights_path(path)
    if os.path.exists(path):
        with np.load(path) as data:
            weights = {k: data[k] for k in data.files}
        variant = PRETRAINED
    elif allow_surrogate:
        weights, variant = random_weights(1234), SURROGATE
    else:
        raise FileNotFoundError(path)
    return LPIPS(weights, variant, device).eval()


def random_weights(seed: int = 0) -> dict:
    """Random but fixed VGG16 and linear-head weights in the real layout
    (the JAX package's draws, in its order): conv weights N(0, 2 / (9 cin))
    [3, 3, cin, cout], zero biases, then the heads U(0, 1). Saved with
    np.savez they make a loadable weights file."""
    rng = np.random.default_rng(seed)
    weights = {}
    cin = 3
    ci = 0
    for cout, n_convs in _BLOCKS:
        for _ in range(n_convs):
            std = np.sqrt(2.0 / (9 * cin))
            weights[f"conv{ci}_w"] = rng.normal(
                0, std, (3, 3, cin, cout)).astype(np.float32)
            weights[f"conv{ci}_b"] = np.zeros(cout, np.float32)
            cin = cout
            ci += 1
    for j, (cout, _) in enumerate(_BLOCKS):
        weights[f"lin{j}_w"] = rng.uniform(0, 1, cout).astype(np.float32)
    return weights
