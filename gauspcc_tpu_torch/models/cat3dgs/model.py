"""CAT-3DGS's model over HAC's scaffold (counterpart of
gauspcc_tpu/models/cat3dgs/model.py: `CATConfig` :26, `init_state` :75,
`set_pca_frame` :106, `hyper_split` :121, `chcm_adjust` :142,
`chcm_slice_stats` :160, `feature_stats` :170).

HAC's hash grids, mlp_grid and deform MLP give way to the PCA triplane
field (`field.py`), whose features at an anchor feed `mlp_attr`: the
Gaussian of the first feature slice, the scaling's and the offsets', and
the three quantisation adjusters, HAC's heads split at the slice. Each
later feature slice takes its Gaussian from `mlp_chcm[i - 1]` over the
slices before it, (de)coded first (channel-wise context). The optional
`mlp_chcm_offsets` / `mlp_chcm_scaling` adjust the offsets' and the
scaling's Gaussians from the (de)coded features. Everything else (anchors,
the scaffold MLPs, rendering, densification) is HAC's, reached through
`CATConfig.as_hac()`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from gauspcc_tpu_torch.core.nn import MLP2
from gauspcc_tpu_torch.device import resolve
from gauspcc_tpu_torch.models.cat3dgs import field as cat_field
from gauspcc_tpu_torch.models.hac import model as hac
from gauspcc_tpu_torch.utils import profiling


class CATConfig(NamedTuple):
    """The JAX package's CATConfig, same fields and defaults."""

    feat_dim: int = 50
    n_offsets: int = 10
    voxel_size: float = 0.001
    update_depth: int = 3
    update_init_factor: int = 16
    update_hierachy_factor: int = 4
    chcm_slices: tuple = (25, 25)
    chcm_for_offsets: bool = False
    chcm_for_scaling: bool = False
    tri_feat: int = 1
    base_resolution: int = 64
    multiscale: tuple = (1, 2, 4)
    contract: bool = True
    q_feat: float = 1.0
    q_scaling: float = 0.001
    q_offsets: float = 0.2

    @property
    def field(self) -> cat_field.FieldConfig:
        return cat_field.FieldConfig(
            n_feat=self.tri_feat, base_resolution=self.base_resolution,
            multiscale=self.multiscale, contract=self.contract)

    @property
    def ctx_dim(self) -> int:
        return 3 * self.tri_feat * len(self.multiscale)

    @property
    def slice0(self) -> int:
        return self.chcm_slices[0]

    @property
    def grid_out_dim(self) -> int:
        # slice 0's mean and scale, the scaling's and the offsets', 3 adjusters
        return self.slice0 * 2 + (6 + 3 * self.n_offsets) * 2 + 3

    def as_hac(self) -> hac.HACConfig:
        """The same scene as a HAC config, for the shared paths."""
        return hac.HACConfig(**{f: getattr(self, f) for f in self._fields
                                if f in hac.HACConfig._fields})


class CATNets(nn.Module):
    """HAC's scaffold MLPs, the field, mlp_attr (ctx_dim -> 2 feat_dim ->
    grid_out_dim), mlp_chcm (one MLP a later slice, from the slices before
    it) and the optional chcm heads of the offsets and the scaling."""

    def __init__(self, cfg: CATConfig):
        super().__init__()
        if sum(cfg.chcm_slices) != cfg.feat_dim:
            raise ValueError(f"chcm_slices {cfg.chcm_slices} do not sum to "
                             f"feat_dim {cfg.feat_dim}")
        in_dim, fd = cfg.feat_dim + 3 + 1, cfg.feat_dim
        self.mlp_opacity = MLP2(in_dim, fd, cfg.n_offsets)
        self.mlp_cov = MLP2(in_dim, fd, 7 * cfg.n_offsets)
        self.mlp_color = MLP2(in_dim, fd, 3 * cfg.n_offsets)
        self.field = cat_field.Field(cfg.field)
        self.mlp_attr = MLP2(cfg.ctx_dim, 2 * fd, cfg.grid_out_dim)
        bounds = np.cumsum(cfg.chcm_slices)
        self.mlp_chcm = nn.ModuleList([
            MLP2(int(bounds[i]), 2 * fd, 2 * cfg.chcm_slices[i + 1])
            for i in range(len(cfg.chcm_slices) - 1)])
        if cfg.chcm_for_offsets:
            self.mlp_chcm_offsets = MLP2(fd, 2 * fd, 6 * cfg.n_offsets)
        if cfg.chcm_for_scaling:
            self.mlp_chcm_scaling = MLP2(fd, 2 * fd, 12)

    @torch.no_grad()
    def init_seeded(self, rng: np.random.Generator) -> "CATNets":
        for name, child in self.named_children():
            if name == "field":
                child.init_seeded(rng)
            elif name == "mlp_chcm":
                for m in child:
                    m.init_uniform(rng)
            else:
                child.init_uniform(rng)
        return self


def init_state(cfg: CATConfig, points: np.ndarray, rng: np.random.Generator,
               device="cuda") -> hac.State:
    """HAC's seeded state with CAT's networks (the identity PCA frame until
    set_pca_frame)."""
    dev = resolve(device)
    return hac.init_state(cfg.as_hac(), points, rng, device=dev,
                          nets=CATNets(cfg).init_seeded(rng))


@torch.no_grad()
def set_pca_frame(state: hac.State, cfg: CATConfig) -> hac.State:
    """Fit the field's PCA frame to the valid anchors (the family's
    set-up on entering phase 2). The frame is set in place, so the
    optimizer's moments of those leaves carry on."""
    valid = state["valid"].cpu().numpy()
    pts = state["anchors"]["anchor"].detach().cpu().numpy()[valid]
    rot, mean, std = cat_field.fit_pca(pts)
    f = state["nets"].field
    for p, v in ((f.rotation, rot), (f.pca_mean, mean), (f.pca_std, std)):
        p.copy_(torch.from_numpy(v))
    return state


@profiling.span("cat.field")
def hyper_split(state: hac.State, cfg: CATConfig, anchor: torch.Tensor,
                planes_q: list | None = None) -> dict:
    """The triplane hyperprior of anchors [N, 3]: slice 0's mean0/scale0,
    the scaling's and the offsets' Gaussians and the three steps (the
    adjusters applied to cfg's base steps). Its forward is the span
    `cat.field`."""
    nets = state["nets"]
    out = nets.mlp_attr(cat_field.sample(nets.field, cfg.field, anchor, planes_q))
    s0, k = cfg.slice0, cfg.n_offsets
    (mean0, scale0, mean_sc, scale_sc, mean_of, scale_of,
     qf, qs, qo) = torch.split(out, [s0, s0, 6, 6, 3 * k, 3 * k, 1, 1, 1], dim=1)
    return {
        "mean0": mean0, "scale0": scale0,
        "mean_scaling": mean_sc, "scale_scaling": scale_sc,
        "mean_offsets": mean_of, "scale_offsets": scale_of,
        "q_feat": cfg.q_feat * (1 + torch.tanh(qf)),
        "q_scaling": cfg.q_scaling * (1 + torch.tanh(qs)),
        "q_offsets": cfg.q_offsets * (1 + torch.tanh(qo)),
    }


def chcm_adjust(state: hac.State, cfg: CATConfig, hyper: dict,
                feat_q: torch.Tensor) -> dict:
    """hyper with the offsets' and the scaling's Gaussians shifted by the
    optional chcm heads over the (de)coded features (off by default)."""
    out = dict(hyper)
    nets, k = state["nets"], cfg.n_offsets
    if cfg.chcm_for_offsets:
        d = nets.mlp_chcm_offsets(feat_q)
        out["mean_offsets"] = hyper["mean_offsets"] + d[:, : 3 * k]
        out["scale_offsets"] = hyper["scale_offsets"] + d[:, 3 * k:]
    if cfg.chcm_for_scaling:
        d = nets.mlp_chcm_scaling(feat_q)
        out["mean_scaling"] = hyper["mean_scaling"] + d[:, :6]
        out["scale_scaling"] = hyper["scale_scaling"] + d[:, 6:]
    return out


def chcm_slice_stats(state: hac.State, cfg: CATConfig, feat_q: torch.Tensor,
                     i: int):
    """(mean, scale) of slice i >= 1 from the (de)coded slices before it."""
    bound = int(np.sum(cfg.chcm_slices[:i]))
    out = state["nets"].mlp_chcm[i - 1](feat_q[:, :bound])
    c = cfg.chcm_slices[i]
    return out[:, :c], out[:, c:]


def feature_stats(state: hac.State, cfg: CATConfig, hyper: dict,
                  feat_q: torch.Tensor):
    """The whole feature vector's (mean, scale), every later slice's
    teacher-forced on the quantised features (training's path)."""
    means, scales = [hyper["mean0"]], [hyper["scale0"]]
    for i in range(1, len(cfg.chcm_slices)):
        m, s = chcm_slice_stats(state, cfg, feat_q, i)
        means.append(m)
        scales.append(s)
    return torch.cat(means, -1), torch.cat(scales, -1)
