"""The seeded leaves and noise of the `cat3dgs` cells: every trainable leaf
of an untrained CAT-3DGS state and each phase-5 step's uniform draws.

The scene, its cameras and frames, and the anchors are the `hac` cells'
(traffic/hac_scene.py); only what CAT-3DGS trains differs from HAC's. The
leaves have the shapes of the port's `CATNets` and anchors
(gauspcc_tpu_torch/models/cat3dgs/model.py `init_state`), by the port's
names, with values drawn from `--seed` on the card (laws below; sizes
assumed, see configs/cat3dgs.json "assumed").
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import cat3dgs as ref
from portbench.traffic import hac_scene


@torch.no_grad()
def make_leaves(shape: ref.CATShape, points: np.ndarray, seed: int, device):
    """(leaves, rest) on `device`, drawn from a torch.Generator seeded by
    `seed`. Laws: the anchors' four fields as the `hac` cells' (offsets
    U(-1, 1), masks' logits N(2, 1), features N(0, 1), scalings log(sqrt(knn
    mean squared distance)) + N(0, 0.1)); the planes N(0, 0.2^2)
    (`Field.init_seeded`'s law); every MLP's and ARM's weights and biases
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)); the gains 0, 1, 2 and the identity
    PCA frame (the set-up fits the frame). The frozen fields are the `hac`
    cells'."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed) % (2**63))
    n = points.shape[0]
    cap = hac_scene.bucket_capacity(n)
    shapes = ref.leaf_shapes(shape, cap)
    k = shape.n_offsets

    def u(shp, lo, hi):
        return torch.rand(shp, generator=gen, device=dev) * (hi - lo) + lo

    def nrm(shp, mean, std):
        return torch.randn(shp, generator=gen, device=dev) * std + mean

    live = torch.zeros(cap, dtype=torch.bool, device=dev)
    live[:n] = True
    livef = live.to(torch.float32)
    dist2 = np.maximum(hac_scene.knn_mean_dist(points), 1e-7)
    log_s = torch.zeros(cap, device=dev)
    log_s[:n] = torch.from_numpy(np.log(np.sqrt(dist2)).astype(np.float32)).to(dev)
    leaves = {
        "anchors/offset": u((cap, k, 3), -1.0, 1.0) * livef[:, None, None],
        "anchors/mask": nrm((cap, k, 1), 2.0, 1.0) * livef[:, None, None],
        "anchors/anchor_feat": nrm((cap, shape.feat_dim), 0.0, 1.0) * livef[:, None],
        "anchors/scaling": (log_s[:, None] + nrm((cap, 6), 0.0, 0.1)) * livef[:, None],
    }
    for name, shp in shapes.items():
        if name.startswith("nets/field/scales/"):
            leaves[name] = nrm(shp, 0.0, 0.2)
        elif name.endswith("/weight") or name.endswith("/bias"):
            fan_in = shapes[name.rsplit("/", 1)[0] + "/weight"][1]
            bound = 1.0 / float(np.sqrt(fan_in))
            leaves[name] = u(shp, -bound, bound)
    leaves["nets/field/gains"] = torch.arange(
        len(shape.multiscale), dtype=torch.float32, device=dev)
    leaves["nets/field/rotation"] = torch.eye(3, device=dev)
    leaves["nets/field/pca_mean"] = torch.zeros(3, device=dev)
    leaves["nets/field/pca_std"] = torch.ones(3, device=dev)
    assert leaves.keys() == shapes.keys()
    anchor = torch.zeros((cap, 3), device=dev)
    anchor[:n] = torch.from_numpy(points).to(dev)
    rot = torch.zeros((cap, 4), device=dev)
    rot[:n, 0] = 1.0
    rest = {
        "anchor": anchor, "rotation": rot,
        "opacity": torch.full((cap, 1), float(np.log(0.1 / 0.9)), device=dev),
        "valid": live,
    }
    return leaves, rest


def noise_draw(shape: ref.CATShape, cap: int, gen: torch.Generator, device):
    """One phase-5 step's draws: (feat [cap, F], scaling [cap, 6], offsets
    [cap, K, 3]) in [0, 1), as HAC's, and the planes' [3, C, R, R] a scale
    in [-0.5, 0.5), as the port's `training_loss` takes them."""
    planes = [torch.rand((3, shape.tri_feat, r, r), generator=gen,
                         device=device) - 0.5 for r in shape.resolutions]
    return (torch.rand((cap, shape.feat_dim), generator=gen, device=device),
            torch.rand((cap, 6), generator=gen, device=device),
            torch.rand((cap, shape.n_offsets, 3), generator=gen, device=device),
            planes)
