"""HAC scene model, eval path (counterpart of gauspcc_tpu/models/hac/model.py).

Scaffold-GS anchors in fixed-capacity buffers with a `valid` mask, the
hash-grid context and its MLPs. The state is a dict laid out like the JAX
package's pytree:

    {"anchors": {"anchor", "offset", "mask", "anchor_feat", "scaling",
                 "rotation", "opacity"}, "valid": bool [cap],
     "nets": HACNets, "x_bound_min": [1, 3], "x_bound_max": [1, 3]}

Only the eval branches of `generate_neural_gaussians` are here (the
STE-quantised render and the decoded render); the training branches come
with the training slice.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch
from torch import nn

from gauspcc_tpu_torch.core.nn import MLP2
from gauspcc_tpu_torch.core.quant import ste_multistep, ste_round
from gauspcc_tpu_torch.device import resolve
from gauspcc_tpu_torch.fields import hashgrid

State = dict[str, Any]


class HACConfig(NamedTuple):
    """The eval path's fields of the JAX package's HACConfig, same defaults."""

    feat_dim: int = 50
    n_offsets: int = 10
    voxel_size: float = 0.001
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
               device="cuda") -> State:
    """Seeded state from a voxelized seed cloud (create_from_pcd), with the
    shapes and fills of the JAX package's init_state."""
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
        "nets": HACNets(cfg).init_seeded(rng).to(dev),
        "x_bound_min": full((1, 3), 0.0),
        "x_bound_max": full((1, 3), 1.0),
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
    out = state["nets"].mlp_grid(feat_context)
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
                              decoded: bool = False) -> NeuralGaussians:
    """Eval-time neural Gaussians. Unless `decoded`, the attributes are
    STE-quantised through the learned context exactly as the encoder will
    quantise them (the float eval renders what ships)."""
    k = cfg.n_offsets
    anchors = state["anchors"]
    nets = state["nets"]
    vis = visible_mask & state["valid"]

    anchor = get_anchor(state, cfg, decoded)
    feat = anchors["anchor_feat"]
    grid_offsets = anchors["offset"]
    grid_scaling = get_scaling(state, decoded)
    binary_mask = get_mask(state, decoded)  # [cap, K, 1]
    if not decoded:
        ctx = grid_mlp_split(state, cfg, calc_interp_feat(state, cfg, anchor))
        feat_mean, scaling_mean, offset_mean = _live_means(state, cfg)
        feat = ste_multistep(feat, ctx["q_feat"], feat_mean)
        grid_scaling = ste_multistep(grid_scaling, ctx["q_scaling"], scaling_mean)
        grid_offsets = ste_multistep(
            grid_offsets, ctx["q_offsets"][:, None, :], offset_mean)

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
    return NeuralGaussians(xyz=xyz, color=color, opacity=neural_opacity,
                           scaling=scaling, rot=rot, valid=g_valid)
