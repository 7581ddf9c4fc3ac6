"""HAC++'s model over HAC's (counterpart of
gauspcc_tpu/models/hac_plus/model.py).

mlp_grid grows a per-channel `prob` head (a 10-way split of its output),
the deform MLP goes, and the features get a 5-chunk autoregressive channel
context (`channel_ctx`): chunk i's (mean, scale, prob) adjustments come
from an MLP on the decoded chunks before it (and, in the full variant, on
the hyperprior's heads), and with the hyperprior they form a 2-component
Gaussian mixture. The tiny variant (Blender scenes) gives chunk 0 three
learned rows instead of an MLP. Everything else (anchors, the scaffold
MLPs, the hash grids, rendering, densification) is HAC's, reached through
`HACPlusConfig.as_hac()`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from gauspcc_tpu_torch.core.nn import MLP2
from gauspcc_tpu_torch.device import resolve
from gauspcc_tpu_torch.fields import hashgrid
from gauspcc_tpu_torch.models.hac import model as hac

N_CHUNKS = 5


class HACPlusConfig(NamedTuple):
    """The JAX package's HACPlusConfig, same fields and defaults."""

    feat_dim: int = 50
    n_offsets: int = 10
    voxel_size: float = 0.001
    update_depth: int = 3
    update_init_factor: int = 16
    update_hierachy_factor: int = 4
    n_features_per_level: int = 2
    log2_hashmap_size: int = 19
    log2_hashmap_size_2d: int = 17
    resolutions_3d: tuple = (18, 24, 33, 44, 59, 80, 108, 148, 201, 275, 376, 514)
    resolutions_2d: tuple = (130, 258, 514, 1026)
    q_feat: float = 1.0
    q_scaling: float = 0.001
    q_offsets: float = 0.2
    tiny_ctx: bool = False  # the tiny channel context, for Blender scenes

    @property
    def chunk(self) -> int:
        if self.feat_dim % N_CHUNKS:
            raise ValueError(f"feat_dim {self.feat_dim} is not a multiple of "
                             f"{N_CHUNKS} chunks")
        return self.feat_dim // N_CHUNKS

    @property
    def grid_spec(self) -> hashgrid.MixedGridSpec:
        return self.as_hac().grid_spec

    @property
    def grid_out_dim(self) -> int:
        # HAC's heads plus feat_dim for the prob head
        return self.feat_dim * 3 + (6 + 3 * self.n_offsets) * 2 + 3

    def as_hac(self) -> hac.HACConfig:
        """The same scene as a HAC config, for the shared paths."""
        return hac.HACConfig(**{f: getattr(self, f) for f in hac.HACConfig._fields})


class _LeakyMLP(MLP2):
    """leaky_relu(x W0 + b0, 0.01) W1 + b1."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc1(F.leaky_relu(self.fc0(x), negative_slope=0.01))


class ChannelCtx(nn.Module):
    """The channel context: `mlp_d{i}` for chunks i = 0..4 (the full
    variant, on [hyperprior heads, chunks < i]), or `mean_d0` / `scale_d0`
    / `prob_d0` [1, c] for chunk 0 and `mlp_d{i}` on the chunks < i for the
    others (the tiny variant)."""

    def __init__(self, cfg: HACPlusConfig):
        super().__init__()
        c = cfg.chunk
        self.tiny = cfg.tiny_ctx
        self.chunk = c
        if self.tiny:
            for name in ("mean_d0", "scale_d0", "prob_d0"):
                self.register_parameter(name, nn.Parameter(torch.zeros(1, c)))
            for i in range(1, N_CHUNKS):
                setattr(self, f"mlp_d{i}", _LeakyMLP(c * i, c * 3, c * 3))
        else:
            hyper = cfg.feat_dim * 3
            for i in range(N_CHUNKS):
                setattr(self, f"mlp_d{i}", _LeakyMLP(hyper + c * i, 4 * c, c * 3))

    @torch.no_grad()
    def init_uniform(self, rng: np.random.Generator) -> "ChannelCtx":
        """nn.Linear's default law for every MLP (the JAX package's
        dense_init); the tiny variant's chunk-0 rows stay 0, as there."""
        for m in self.children():
            m.init_uniform(rng)
        return self

    def chunk_adjustments(self, i: int, feat_q: torch.Tensor,
                          mean_scale: torch.Tensor):
        """(mean, scale, prob) adjustments [n, c] of chunk i, from the
        chunks before it of feat_q [n, feat_dim] (chunks >= i unread) and the
        hyperprior's heads mean_scale [n, 3 feat_dim]."""
        c = self.chunk
        if self.tiny and i == 0:
            n = feat_q.shape[0]
            return tuple(getattr(self, p).expand(n, c)
                         for p in ("mean_d0", "scale_d0", "prob_d0"))
        prev = feat_q[:, : i * c]
        inp = prev if self.tiny else torch.cat([prev, mean_scale], -1)
        out = getattr(self, f"mlp_d{i}")(inp)
        return out[:, :c], out[:, c:2 * c], out[:, 2 * c:]


def channel_ctx_apply(ctx_net: ChannelCtx, cfg: HACPlusConfig,
                      feat_q: torch.Tensor, mean_scale: torch.Tensor,
                      to_dec: int = -1):
    """(mean_adj, scale_adj, prob_adj): [n, feat_dim] each when to_dec < 0,
    else chunk `to_dec`'s [n, chunk] (the codec's loop). Chunk i's MLP sees
    only chunks < i, so its GEMM has one shape on both sides of the codec."""
    if to_dec >= 0:
        return ctx_net.chunk_adjustments(to_dec, feat_q, mean_scale)
    outs = [ctx_net.chunk_adjustments(i, feat_q, mean_scale)
            for i in range(N_CHUNKS)]
    return tuple(torch.cat([o[j] for o in outs], -1) for j in range(3))


class HACPlusNets(nn.Module):
    """HAC's tables and scaffold MLPs, mlp_grid widened to grid_out_dim, and
    the channel context in place of the deform MLP."""

    def __init__(self, cfg: HACPlusConfig):
        super().__init__()
        in_dim = cfg.feat_dim + 3 + 1
        self.tables = hashgrid.MixedTables(cfg.grid_spec)
        self.mlp_opacity = MLP2(in_dim, cfg.feat_dim, cfg.n_offsets)
        self.mlp_cov = MLP2(in_dim, cfg.feat_dim, 7 * cfg.n_offsets)
        self.mlp_color = MLP2(in_dim, cfg.feat_dim, 3 * cfg.n_offsets)
        self.mlp_grid = MLP2(cfg.grid_spec.output_dim, cfg.feat_dim * 2,
                             cfg.grid_out_dim)
        self.channel_ctx = ChannelCtx(cfg)

    @torch.no_grad()
    def init_seeded(self, rng: np.random.Generator) -> "HACPlusNets":
        self.tables.init_uniform(rng)
        for name in ("mlp_opacity", "mlp_cov", "mlp_color", "mlp_grid"):
            getattr(self, name).init_uniform(rng)
        self.channel_ctx.init_uniform(rng)
        return self


def init_state(cfg: HACPlusConfig, points: np.ndarray,
               rng: np.random.Generator, device="cuda") -> hac.State:
    """HAC's seeded state with HAC++'s networks."""
    dev = resolve(device)
    return hac.init_state(cfg.as_hac(), points, rng, device=dev,
                          nets=HACPlusNets(cfg).init_seeded(rng))


def grid_mlp_split(state: hac.State, cfg: HACPlusConfig,
                   feat_context: torch.Tensor) -> dict:
    """mlp_grid's output split into HAC++'s 10 context heads."""
    out = state["nets"].mlp_grid(feat_context)
    fd, k = cfg.feat_dim, cfg.n_offsets
    (mean, scale, prob, mean_sc, scale_sc, mean_of, scale_of,
     q_feat_adj, q_sc_adj, q_of_adj) = torch.split(
        out, [fd, fd, fd, 6, 6, 3 * k, 3 * k, 1, 1, 1], dim=1)
    return {
        "mean": mean, "scale": scale, "prob": prob,
        "mean_scaling": mean_sc, "scale_scaling": scale_sc,
        "mean_offsets": mean_of, "scale_offsets": scale_of,
        "q_feat": cfg.q_feat * (1 + torch.tanh(q_feat_adj)),
        "q_scaling": cfg.q_scaling * (1 + torch.tanh(q_sc_adj)),
        "q_offsets": cfg.q_offsets * (1 + torch.tanh(q_of_adj)),
    }


def mixture_components(ctx: dict, ctx_net: ChannelCtx, cfg: HACPlusConfig,
                       feat_q: torch.Tensor, to_dec: int = -1):
    """The feature channel's 2-component mixture, (means, scales, probs),
    lists of [hyperprior, channel context]: full width, or chunk `to_dec`
    when to_dec >= 0. The probabilities are the softmax of the two prob
    heads."""
    mean_scale = torch.cat([ctx["mean"], ctx["scale"], ctx["prob"]], -1)
    mean_adj, scale_adj, prob_adj = channel_ctx_apply(
        ctx_net, cfg, feat_q, mean_scale, to_dec)
    if to_dec >= 0:
        cols = slice(to_dec * cfg.chunk, (to_dec + 1) * cfg.chunk)
    else:
        cols = slice(None)
    probs = torch.softmax(torch.stack([ctx["prob"][:, cols], prob_adj], -1), -1)
    return ([ctx["mean"][:, cols], mean_adj], [ctx["scale"][:, cols], scale_adj],
            [probs[..., 0], probs[..., 1]])
