"""HAC scene model (counterpart of gauspcc_tpu/models/hac/model.py).

Scaffold-GS anchors in fixed-capacity buffers with a `valid` mask, the
hash-grid context and its MLPs. The state is a dict laid out like the JAX
package's pytree:

    {"anchors": {"anchor", "offset", "mask", "anchor_feat", "scaling",
                 "rotation", "opacity"}, "valid": bool [cap],
     "nets": HACNets, "x_bound_min": [1, 3], "x_bound_max": [1, 3]}

`generate_neural_gaussians` has the eval branches (the STE-quantised render
and the decoded render) and the training branches: phase 1's base-Q noise,
and phase 2's context-adaptive noise with the rate terms, as the JAX package
runs them with its phase-2 bisection knobs (P2_Q_FIXED,
P2_NOISE_FEAT_ONLY, model.py:36-37) off, their default. torch cannot draw
`jax.random`'s noise, so the uniform draws can be passed in (`noise`), as
the tests do; otherwise they come from an explicit `torch.Generator`.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch
from torch import nn

from gauspcc_tpu_torch.core import entropy
from gauspcc_tpu_torch.core.nn import MLP2
from gauspcc_tpu_torch.core.quant import (ste_binary, ste_multistep, ste_round,
                                          uniform_noise_quant)
from gauspcc_tpu_torch.device import resolve
from gauspcc_tpu_torch.fields import hashgrid

State = dict[str, Any]


class HACConfig(NamedTuple):
    """The JAX package's HACConfig, same fields and defaults."""

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
    # base quantization steps
    q_feat: float = 1.0
    q_scaling: float = 0.001
    q_offsets: float = 0.2

    @property
    def grid_spec(self) -> hashgrid.MixedGridSpec:
        return hashgrid.make_mixed_spec(
            self.n_features_per_level, self.resolutions_3d,
            self.log2_hashmap_size, self.resolutions_2d,
            self.log2_hashmap_size_2d)

    @property
    def grid_out_dim(self) -> int:
        # mean/scale for feat(2x), scaling(2x6), offsets(2x3K), 3 Q adjusters
        return (self.feat_dim + 6 + 3 * self.n_offsets) * 2 + 3


def bucket_capacity(n: int, minimum: int = 1024) -> int:
    b = minimum
    while b < n:
        b = int(b * 2)
    return b


def knn_mean_dist(points: np.ndarray, k: int = 3) -> np.ndarray:
    """Mean squared distance to the k nearest neighbours."""
    from scipy.spatial import cKDTree

    d, _ = cKDTree(points).query(points, k=k + 1)
    return (d[:, 1:] ** 2).mean(axis=1)


def voxelize_points(points: np.ndarray, voxel_size: float,
                    seed: int = 0) -> np.ndarray:
    """Shuffle + unique on the voxel grid."""
    rng = np.random.default_rng(seed)
    pts = points.copy()
    rng.shuffle(pts)
    return np.unique(np.round(pts / voxel_size), axis=0) * voxel_size


class HACNets(nn.Module):
    """Hash-grid tables and the four MLPs of HAC (plus the deform MLP the
    reference keeps for size accounting)."""

    def __init__(self, cfg: HACConfig):
        super().__init__()
        in_dim = cfg.feat_dim + 3 + 1
        enc_dim = cfg.grid_spec.output_dim
        self.tables = hashgrid.MixedTables(cfg.grid_spec)
        self.mlp_opacity = MLP2(in_dim, cfg.feat_dim, cfg.n_offsets)
        self.mlp_cov = MLP2(in_dim, cfg.feat_dim, 7 * cfg.n_offsets)
        self.mlp_color = MLP2(in_dim, cfg.feat_dim, 3 * cfg.n_offsets)
        self.mlp_grid = MLP2(enc_dim, cfg.feat_dim * 2, cfg.grid_out_dim)
        self.mlp_deform = MLP2(enc_dim, cfg.feat_dim * 2, 2 * cfg.n_offsets)

    @torch.no_grad()
    def init_seeded(self, rng: np.random.Generator) -> "HACNets":
        self.tables.init_uniform(rng)
        for name in ("mlp_opacity", "mlp_cov", "mlp_color", "mlp_grid",
                     "mlp_deform"):
            getattr(self, name).init_uniform(rng)
        self.mlp_deform.fc1.bias[0::2] += 10.0
        return self


def _inverse_sigmoid(x: float) -> float:
    return float(np.log(x / (1 - x)))


def init_state(cfg: HACConfig, points: np.ndarray, rng: np.random.Generator,
               device="cuda", nets: nn.Module | None = None) -> State:
    """Seeded state from a voxelized seed cloud (create_from_pcd), with the
    shapes and fills of the JAX package's init_state; `nets` replaces HAC's
    seeded networks (another family's, HAC++)."""
    dev = resolve(device)
    n = points.shape[0]
    cap = bucket_capacity(n)
    k = cfg.n_offsets
    dist2 = np.maximum(knn_mean_dist(points), 1e-7)
    scales = np.log(np.sqrt(dist2))[:, None].repeat(6, axis=1)

    def pad(x, shape, fill=0.0):
        out = np.full(shape, fill, np.float32)
        out[:n] = x
        return torch.from_numpy(out).to(dev)

    def full(shape, fill):
        return torch.full(shape, fill, dtype=torch.float32, device=dev)

    anchors = {
        "anchor": pad(points, (cap, 3)),
        "offset": full((cap, k, 3), 0.0),
        "mask": full((cap, k, 1), 1.0),  # logits; sigmoid(1) > 0.01
        "anchor_feat": full((cap, cfg.feat_dim), 0.0),
        "scaling": pad(scales, (cap, 6)),
        "rotation": pad(np.tile([1.0, 0, 0, 0], (n, 1)), (cap, 4)),
        "opacity": full((cap, 1), _inverse_sigmoid(0.1)),
    }
    valid = torch.zeros(cap, dtype=torch.bool, device=dev)
    valid[:n] = True
    return {
        "anchors": anchors,
        "valid": valid,
        "nets": (nets if nets is not None
                 else HACNets(cfg).init_seeded(rng)).to(dev),
        "x_bound_min": full((1, 3), 0.0),
        "x_bound_max": full((1, 3), 1.0),
    }


TRAINABLE_ANCHOR_FIELDS = ("offset", "mask", "anchor_feat", "scaling")
# anchor positions train at lr 0 in the reference and rotation/opacity have
# no gradient there, so all three are frozen
FROZEN_ANCHOR_FIELDS = ("anchor", "rotation", "opacity")


def split_state(state: State):
    """(trainable params, rest); merge_state inverts. The nets (an
    nn.Module) are trainable as a whole."""
    params = {
        "anchors": {k: state["anchors"][k] for k in TRAINABLE_ANCHOR_FIELDS},
        "nets": state["nets"],
    }
    rest = {
        "anchors": {k: state["anchors"][k] for k in FROZEN_ANCHOR_FIELDS},
        "valid": state["valid"],
        "x_bound_min": state["x_bound_min"],
        "x_bound_max": state["x_bound_max"],
    }
    return params, rest


def merge_state(params, rest) -> State:
    anchors = dict(rest["anchors"])
    anchors.update(params["anchors"])
    return {
        "anchors": anchors,
        "valid": rest["valid"],
        "nets": params["nets"],
        "x_bound_min": rest["x_bound_min"],
        "x_bound_max": rest["x_bound_max"],
    }


def get_anchor(state: State, cfg: HACConfig, decoded: bool = False) -> torch.Tensor:
    a = state["anchors"]["anchor"]
    if decoded:
        return a
    return ste_round(a / cfg.voxel_size) * cfg.voxel_size


def get_scaling(state: State, decoded: bool = False) -> torch.Tensor:
    s = state["anchors"]["scaling"]
    return s if decoded else torch.exp(s)


def get_mask(state: State, decoded: bool = False) -> torch.Tensor:
    """Hard {0,1} mask with a sigmoid STE."""
    if decoded:
        return state["anchors"]["mask"]
    s = torch.sigmoid(state["anchors"]["mask"])
    return ((s > 0.01).to(torch.float32) - s).detach() + s


def get_mask_anchor(state: State, decoded: bool = False) -> torch.Tensor:
    """Anchors with any offset's mask on, among the valid ones [cap]."""
    return (get_mask(state, decoded).sum(1)[:, 0] > 0) & state["valid"]


def encoding_params_flat(state: State, binarize: bool = True) -> torch.Tensor:
    """Every hash-grid embedding, in the order xyz, xy, xz, yz, through the
    sign STE unless `binarize` is False."""
    flat = state["nets"].tables.flat()
    return ste_binary(flat) if binarize else flat


def mlp_size_bits(state: State, digit: int = 32) -> int:
    """The networks' size in the scene's total: every `mlp*` net but the
    deform one, `digit` bits a parameter (HAC++'s channel_ctx and TC-GS's
    planes and autoencoder are not counted, as in the JAX package)."""
    total = sum(p.numel() for name, net in state["nets"].named_children()
                if name.startswith("mlp") and "deform" not in name
                for p in net.parameters())
    return total * digit


def update_anchor_bound(state: State) -> State:
    """Expand the anchor AABB by 20%."""
    a = state["anchors"]["anchor"]
    v = state["valid"][:, None]
    big = 1e9
    mn = torch.where(v, a, big).amin(0, keepdim=True)
    mx = torch.where(v, a, -big).amax(0, keepdim=True)
    mn = torch.where(mn < 0, mn * 1.2, mn * 0.8)
    mx = torch.where(mx > 0, mx * 1.2, mx * 0.8)
    out = dict(state)
    out["x_bound_min"] = mn
    out["x_bound_max"] = mx
    return out


def calc_interp_feat(state: State, cfg: HACConfig, x: torch.Tensor) -> torch.Tensor:
    xn = (x - state["x_bound_min"]) / (state["x_bound_max"] - state["x_bound_min"])
    return state["nets"].tables(xn)


def grid_mlp_split(state: State, cfg: HACConfig, feat_context: torch.Tensor):
    """mlp_grid output split into the 9 context heads."""
    return context_heads(state["nets"].mlp_grid(feat_context), cfg)


def context_heads(out: torch.Tensor, cfg) -> dict:
    """A context MLP's output split into HAC's 9 heads, the three Q
    adjusters applied to cfg's base steps (TC-GS's mlp_triplane gives the
    same heads)."""
    fd, k = cfg.feat_dim, cfg.n_offsets
    (mean, scale, mean_sc, scale_sc, mean_of, scale_of,
     q_feat_adj, q_sc_adj, q_of_adj) = torch.split(
        out, [fd, fd, 6, 6, 3 * k, 3 * k, 1, 1, 1], dim=1)
    return {
        "mean": mean, "scale": scale,
        "mean_scaling": mean_sc, "scale_scaling": scale_sc,
        "mean_offsets": mean_of, "scale_offsets": scale_of,
        "q_feat": cfg.q_feat * (1 + torch.tanh(q_feat_adj)),
        "q_scaling": cfg.q_scaling * (1 + torch.tanh(q_sc_adj)),
        "q_offsets": cfg.q_offsets * (1 + torch.tanh(q_of_adj)),
    }


class NeuralGaussians(NamedTuple):
    xyz: torch.Tensor  # [cap*K, 3]
    color: torch.Tensor  # [cap*K, 3]
    opacity: torch.Tensor  # [cap*K, 1]
    scaling: torch.Tensor  # [cap*K, 3]
    rot: torch.Tensor  # [cap*K, 4]
    valid: torch.Tensor  # [cap*K] bool (anchor visible & mask & opacity > 0)
    neural_opacity: torch.Tensor  # [cap*K, 1] pre-clip opacity (for stats)


def _live_means(state: State, cfg: HACConfig):
    """Attribute means over live rows only (the capacity padding is zeros
    and would bias the STE clamp window toward 0)."""
    anchors = state["anchors"]
    valid_f = state["valid"].to(torch.float32)[:, None]
    n_live = torch.clamp_min(valid_f.sum(), 1.0)
    feat_mean = (anchors["anchor_feat"] * valid_f).sum() / (n_live * cfg.feat_dim)
    scaling_mean = (get_scaling(state) * valid_f).sum() / (n_live * 6)
    offset_mean = (anchors["offset"] * valid_f[:, :, None]).sum() / (
        n_live * 3 * cfg.n_offsets)
    return feat_mean, scaling_mean, offset_mean


def generate_neural_gaussians(state: State, cfg: HACConfig,
                              camera_center: torch.Tensor,
                              visible_mask: torch.Tensor, *,
                              training: bool = False, phase: int = 0,
                              noise=None, generator: torch.Generator | None = None,
                              decoded: bool = False):
    """Returns (NeuralGaussians, rate terms dict or None).

    visible_mask: [cap] bool from the prefilter, combined with validity.
    Eval (not `training`): unless `decoded`, the attributes are STE-quantised
    through the learned context exactly as the encoder will quantise them,
    when the state has hash tables and an mlp_grid of HAC's width
    (`cfg.grid_out_dim`); another family's state (HAC++'s wider mlp_grid,
    TC-GS's triplane) renders its float attributes, as in the JAX package
    (model.py:343-349).
    Training, by `phase`, the schedule stage the caller derives from the
    step: 0 no quantization proxy; 1 base-Q uniform noise; 2 context-adaptive
    noise and the rate estimate over the visible, mask-on anchors. `noise`
    is the phase's uniform draws in [0, 1): (feat [cap, feat_dim], scaling
    [cap, 6], offsets [cap, K, 3]), as the JAX package draws them from
    split(key, 3); if None they are drawn from `generator`."""
    k = cfg.n_offsets
    anchors = state["anchors"]
    nets = state["nets"]
    vis = visible_mask & state["valid"]

    anchor = get_anchor(state, cfg, decoded)
    feat = anchors["anchor_feat"]
    grid_offsets = anchors["offset"]
    grid_scaling = get_scaling(state, decoded)
    binary_mask = get_mask(state, decoded)  # [cap, K, 1]
    rate = None
    # HAC++ and TC-GS reuse this scaffold with a context of their own: only
    # HAC's tables and an mlp_grid of HAC's width give HAC's heads
    has_hac_ctx = (hasattr(nets, "tables") and hasattr(nets, "mlp_grid")
                   and nets.mlp_grid.fc1.out_features == cfg.grid_out_dim)
    if not training and not decoded and has_hac_ctx:
        ctx = grid_mlp_split(state, cfg, calc_interp_feat(state, cfg, anchor))
        feat_mean, scaling_mean, offset_mean = _live_means(state, cfg)
        feat = ste_multistep(feat, ctx["q_feat"], feat_mean)
        grid_scaling = ste_multistep(grid_scaling, ctx["q_scaling"], scaling_mean)
        grid_offsets = ste_multistep(
            grid_offsets, ctx["q_offsets"][:, None, :], offset_mean)
    if training and not decoded and phase in (1, 2):
        u_feat, u_scaling, u_offsets = noise if noise is not None else (
            None, None, None)
        draw = dict(generator=generator)
        if phase == 1:
            feat = uniform_noise_quant(feat, cfg.q_feat, u_feat, **draw)
            grid_scaling = uniform_noise_quant(grid_scaling, cfg.q_scaling,
                                               u_scaling, **draw)
            grid_offsets = uniform_noise_quant(grid_offsets, cfg.q_offsets,
                                               u_offsets, **draw)
        else:
            ctx = grid_mlp_split(state, cfg, calc_interp_feat(state, cfg, anchor))
            feat = uniform_noise_quant(feat, ctx["q_feat"], u_feat, **draw)
            grid_scaling = uniform_noise_quant(
                grid_scaling, ctx["q_scaling"], u_scaling, **draw)
            grid_offsets = uniform_noise_quant(
                grid_offsets, ctx["q_offsets"][:, None, :], u_offsets, **draw)
            rate = _rate_terms(state, cfg, ctx, vis, binary_mask, feat,
                               grid_scaling, grid_offsets)

    ob_view = anchor - camera_center[None, :]
    ob_dist = torch.linalg.norm(ob_view, dim=1, keepdim=True) + 1e-9
    ob_view = ob_view / ob_dist

    cat_local = torch.cat([feat, ob_view, ob_dist], 1)
    neural_opacity = nets.mlp_opacity(cat_local, torch.tanh).reshape(-1, 1)
    neural_opacity = neural_opacity * binary_mask.reshape(-1, 1)
    g_valid = (neural_opacity[:, 0] > 0.0) & torch.repeat_interleave(vis, k)

    color = nets.mlp_color(cat_local, torch.sigmoid).reshape(-1, 3)
    scale_rot = nets.mlp_cov(cat_local).reshape(-1, 7)

    scaling_rep = torch.repeat_interleave(grid_scaling, k, dim=0)  # [cap*K, 6]
    anchor_rep = torch.repeat_interleave(anchor, k, dim=0)
    offsets = grid_offsets.reshape(-1, 3)

    scaling = scaling_rep[:, 3:] * torch.sigmoid(scale_rot[:, :3])
    rot = scale_rot[:, 3:7] / (
        torch.linalg.norm(scale_rot[:, 3:7], dim=-1, keepdim=True) + 1e-9)
    xyz = anchor_rep + offsets * scaling_rep[:, :3]
    ng = NeuralGaussians(xyz=xyz, color=color, opacity=neural_opacity,
                         scaling=scaling, rot=rot, valid=g_valid,
                         neural_opacity=neural_opacity)
    return ng, rate


def _rate_terms(state, cfg, ctx, vis, binary_mask, feat, grid_scaling,
                grid_offsets) -> dict:
    """Phase 2's bits per parameter over every valid, mask-on and visible
    anchor (the reference samples 5% of them: same expectation), scaled by
    the mask-on fraction of the visible anchors. The clamp windows' means
    run over live rows only."""
    k = cfg.n_offsets
    sel = (vis & get_mask_anchor(state))[:, None].to(torch.float32)
    feat_mean, scaling_mean, offset_mean = _live_means(state, cfg)
    mask3 = torch.repeat_interleave(binary_mask, 3, dim=-1).reshape(-1, 3 * k)
    bit_feat = entropy.gaussian_bits(feat, ctx["mean"], ctx["scale"],
                                     ctx["q_feat"], x_mean=feat_mean) * sel
    bit_scaling = entropy.gaussian_bits(
        grid_scaling, ctx["mean_scaling"], ctx["scale_scaling"],
        ctx["q_scaling"], x_mean=scaling_mean) * sel
    bit_offsets = entropy.gaussian_bits(
        grid_offsets.reshape(-1, 3 * k), ctx["mean_offsets"],
        ctx["scale_offsets"], ctx["q_offsets"], x_mean=offset_mean
    ) * mask3 * sel
    n_vis = torch.clamp_min(vis.to(torch.float32).sum(), 1.0)
    mask_anchor_rate = sel.sum() / n_vis
    denom = torch.clamp_min(sel.sum(), 1.0)
    rate = {
        "bit_per_feat_param": bit_feat.sum() / (denom * cfg.feat_dim) * mask_anchor_rate,
        "bit_per_scaling_param": bit_scaling.sum() / (denom * 6) * mask_anchor_rate,
        "bit_per_offsets_param": bit_offsets.sum() / (denom * 3 * k) * mask_anchor_rate,
    }
    rate["bit_per_param"] = (
        bit_feat.sum() + bit_scaling.sum() + bit_offsets.sum()
    ) / (denom * (cfg.feat_dim + 6 + 3 * k)) * mask_anchor_rate
    return rate
