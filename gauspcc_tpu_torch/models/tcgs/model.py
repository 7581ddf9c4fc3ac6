"""TC-GS's model over HAC's scaffold (counterpart of
gauspcc_tpu/models/tcgs/model.py).

HAC's hash grids, mlp_grid and deform MLP give way to a single-scale
triplane [3, C, R, R] (`planes`), read at K points per anchor, whose
features, beside the anchor's position, feed `mlp_triplane` and its nine
context heads, HAC's (quantisation steps from a base of 0.3 for the
offsets). A conv autoencoder over the planes (`autoencoder`) gives the
f16 latent the bitstream ships. The K points are the anchor itself
repeated K times (repeat mode, the default) or its K nearest anchors
(knn mode, `knn_sampling`). Everything else (anchors, the scaffold MLPs,
rendering, densification) is HAC's, reached through
`TCGSConfig.as_hac()`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from gauspcc_tpu_torch.core.nn import MLP2
from gauspcc_tpu_torch.device import resolve
from gauspcc_tpu_torch.fields import triplane as tri
from gauspcc_tpu_torch.models.hac import model as hac


class TCGSConfig(NamedTuple):
    """The JAX package's TCGSConfig, same fields and defaults."""

    feat_dim: int = 50
    n_offsets: int = 10
    voxel_size: float = 0.001
    update_depth: int = 3
    update_init_factor: int = 16
    update_hierachy_factor: int = 4
    tri_feat: int = 16  # the planes' channels C
    tri_res: int = 32  # R
    tri_samples: int = 4  # K sample points per anchor
    knn_sampling: bool = False  # sample at the K nearest anchors
    ae_compressed: int = 8
    q_feat: float = 1.0
    q_scaling: float = 0.001
    q_offsets: float = 0.3

    @property
    def ctx_dim(self) -> int:
        return self.tri_samples * 3 * self.tri_feat + 3

    @property
    def grid_out_dim(self) -> int:
        return (self.feat_dim + 6 + 3 * self.n_offsets) * 2 + 3

    def as_hac(self) -> hac.HACConfig:
        """The same scene as a HAC config (HAC's defaults for the hash
        grids it has not), for the shared paths."""
        return hac.HACConfig(**{f: getattr(self, f) for f in self._fields
                                if f in hac.HACConfig._fields})


class TCGSNets(nn.Module):
    """HAC's scaffold MLPs, the planes, their autoencoder and
    mlp_triplane (ctx_dim -> 2 feat_dim -> grid_out_dim)."""

    def __init__(self, cfg: TCGSConfig):
        super().__init__()
        in_dim = cfg.feat_dim + 3 + 1
        self.mlp_opacity = MLP2(in_dim, cfg.feat_dim, cfg.n_offsets)
        self.mlp_cov = MLP2(in_dim, cfg.feat_dim, 7 * cfg.n_offsets)
        self.mlp_color = MLP2(in_dim, cfg.feat_dim, 3 * cfg.n_offsets)
        self.planes = nn.Parameter(
            torch.zeros(3, cfg.tri_feat, cfg.tri_res, cfg.tri_res))
        self.autoencoder = tri.Autoencoder(
            tri.AEConfig(cfg.tri_feat, cfg.ae_compressed))
        self.mlp_triplane = MLP2(cfg.ctx_dim, cfg.feat_dim * 2, cfg.grid_out_dim)

    @torch.no_grad()
    def init_seeded(self, rng: np.random.Generator) -> "TCGSNets":
        for name in ("mlp_opacity", "mlp_cov", "mlp_color"):
            getattr(self, name).init_uniform(rng)
        _, c, r, _ = self.planes.shape
        self.planes.copy_(tri.init_triplane(c, r, rng))
        self.autoencoder.init_uniform(rng)
        self.mlp_triplane.init_uniform(rng)
        return self


def init_state(cfg: TCGSConfig, points: np.ndarray, rng: np.random.Generator,
               device="cuda") -> hac.State:
    """HAC's seeded state with TC-GS's networks."""
    dev = resolve(device)
    return hac.init_state(cfg.as_hac(), points, rng, device=dev,
                          nets=TCGSNets(cfg).init_seeded(rng))


def normalize_coords(state: hac.State, x: torch.Tensor) -> torch.Tensor:
    """Centre and scale x into the triplane's unit ball by the anchors'
    bound."""
    lo, hi = state["x_bound_min"], state["x_bound_max"]
    center = 0.5 * (lo + hi)
    radius = 0.5 * (hi - lo).max() + 1e-9
    return (x - center) / radius


def triplane_context(state: hac.State, cfg: TCGSConfig, anchor: torch.Tensor,
                     planes: torch.Tensor | None = None,
                     knn_pos: torch.Tensor | None = None) -> torch.Tensor:
    """mlp_triplane's input [N, ctx_dim]: the planes sampled at K points a
    anchor, then the anchor. The points are `knn_pos` [N, K, 3] (detached),
    or the anchor repeated K times. `planes` replaces the state's (the
    codec samples the latent's reconstruction)."""
    if planes is None:
        planes = state["nets"].planes
    if knn_pos is not None:
        xn = normalize_coords(state, knn_pos.detach().reshape(-1, 3))
        feats = tri.sample_triplane(planes, xn).reshape(anchor.shape[0], -1)
    else:
        feats = tri.sample_triplane(planes, normalize_coords(state, anchor))
        feats = feats.repeat(1, cfg.tri_samples)
    return torch.cat([feats, anchor], -1)


def knn_positions(anchor_valid: np.ndarray, k: int) -> np.ndarray:
    """The K nearest anchors' positions of each anchor, itself first, in
    order of distance: float32 [N, K, 3]. Below k anchors, each anchor
    repeated. A function of its input alone, so the encoder and the decoder
    derive the same positions from the coded anchors."""
    from scipy.spatial import cKDTree

    pts = np.asarray(anchor_valid, np.float32)
    n = pts.shape[0]
    if n < k or n == 0:
        return np.repeat(pts[:, None, :], max(k, 1), axis=1)
    _, nn_idx = cKDTree(pts).query(pts, k=k)
    return pts[np.atleast_2d(nn_idx)].astype(np.float32)


def grid_mlp_split(state: hac.State, cfg: TCGSConfig,
                   ctx_feats: torch.Tensor) -> dict:
    """mlp_triplane's output split into HAC's 9 context heads."""
    return hac.context_heads(state["nets"].mlp_triplane(ctx_feats), cfg)


def reconstructed_planes(state: hac.State):
    """(latent, reconstruction) of the state's planes by its autoencoder."""
    nets = state["nets"]
    return tri.autoencode(nets.autoencoder, nets.planes)
