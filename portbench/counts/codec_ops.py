"""Floating-point operations one GausPcgc round trip (encode, then decode)
needs, from the pyramid's shapes (the `mfu.code` count).

Per coded level, the network's submanifold convs cost 2 x Cin x Cout for
each (voxel, kernel tap) pair whose neighbour is in the voxel set: 5 convs
over the parents (the prior stack), 5 over the children (the target
stack) and 2 per stage over the children (4 stages); the heads 2 x (C x C
+ C x S) per child and stage. Encode and decode each run the whole
network once, so a round trip counts it twice. Geometry, embeddings,
tables and the coder are not counted (a lower bound). The neighbours are
found by the plain reference's `neighbours` (reference/gauspcgc.py).
"""

from __future__ import annotations

import torch

from portbench.reference import gauspcgc as ref

PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense bf16 on the tensor cores


def _pairs(coords, kernel_size: int, device) -> int:
    nbr = ref.neighbours(torch.as_tensor(coords, device=device), kernel_size)
    return int((nbr < coords.shape[0]).sum())


@torch.no_grad()
def round_trip_ops(levels, kernel_size: int, channels: int, device) -> int:
    c = channels
    total = 0
    for d in range(len(levels) - 1):
        p_pairs = _pairs(levels[d][0], kernel_size, device)
        c_pairs = _pairs(levels[d + 1][0], kernel_size, device)
        n_child = levels[d + 1][0].shape[0]
        convs = 2 * c * c * (5 * p_pairs + (5 + 2 * 4) * c_pairs)
        heads = sum(2 * n_child * (c * c + c * s) for s in ref.STAGE_SIZES)
        total += convs + heads
    return 2 * total
