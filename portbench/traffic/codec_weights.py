"""Seeded GausPcgc weights for the codec-training cell, made on the card
under the JAX package's keys (dense weights [in, out]).

The laws are those of the port's `init_net` (codecs/gauspcgc/model.py
:126-146, after JAX's `init_params`): embeddings N(0, 1); conv w [k^3, C,
C] and b U(+-1/sqrt(C k^3)); dense w and b U(+-1/sqrt(fan_in)). The draws
are the benchmark's own, from a torch.Generator on the device.
"""

from __future__ import annotations

import torch

STAGE_SIZES = (2, 2, 4, 16)
STAGE_COND = (1, 2, 4, 16)


def shapes(channels: int, kernel_size: int) -> dict[str, tuple]:
    c, k3 = channels, kernel_size**3
    out = {"prior_embedding": (256, c), "target_embedding": (8, c)}

    def stack(prefix):
        for conv in ("conv", "res0/conv0", "res0/conv1", "res1/conv0",
                     "res1/conv1"):
            out[f"{prefix}/{conv}/w"] = (k3, c, c)
            out[f"{prefix}/{conv}/b"] = (c,)

    stack("prior_resnet")
    stack("target_resnet")
    for s in range(4):
        for conv in ("conv0", "conv1"):
            out[f"spatial_s{s}/{conv}/w"] = (k3, c, c)
            out[f"spatial_s{s}/{conv}/b"] = (c,)
        out[f"head_s{s}/fc0/w"] = (c, c)
        out[f"head_s{s}/fc0/b"] = (c,)
        out[f"head_s{s}/fc1/w"] = (c, STAGE_SIZES[s])
        out[f"head_s{s}/fc1/b"] = (STAGE_SIZES[s],)
        if s > 0:
            out[f"cond_emb_s{s}"] = (STAGE_COND[s], c)
    return out


@torch.no_grad()
def seeded_weights(seed: int, channels: int, kernel_size: int, device) -> dict:
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed) % (2**63))
    out = {}
    for name, shp in shapes(channels, kernel_size).items():
        if "embedding" in name or name.startswith("cond_emb"):
            out[name] = torch.randn(shp, generator=gen, device=dev)
            continue
        # every head's dense layers read C values; a conv C k^3
        fan_in = channels if "/fc" in name else kernel_size**3 * channels
        bound = 1.0 / float(fan_in) ** 0.5
        out[name] = (torch.rand(shp, generator=gen, device=dev) * 2 - 1) * bound
    return out
