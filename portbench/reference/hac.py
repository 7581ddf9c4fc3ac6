"""Plain float32 reference of HAC: the hash-grid context, the neural
Gaussians, the phase-2 objective with its rate terms, the per-group Adam
update, the eval render and the raster-cap rules.

Frozen copies of the port's plain code, rewritten over a flat dict of
tensors (the leaves by the port's names, "anchors/offset",
"nets/mlp_color/fc0/weight", ...) instead of modules:

- hash grid: gauspcc_tpu_torch/fields/hashgrid.py:65-111 (`encode`) and
  :146-157 (`MixedTables.forward`).
- STEs and the noise proxy: gauspcc_tpu_torch/core/quant.py:22-55, :94-107.
- bits: gauspcc_tpu_torch/core/entropy.py:21-74, :89-96.
- neural Gaussians and rate terms: gauspcc_tpu_torch/models/hac/model.py
  :223-425 (the training phase-2 branch and the eval branch only; the
  decoded and phase-1 branches are not on the benchmark's path).
- objective: gauspcc_tpu_torch/models/hac/render.py:100-155.
- image terms: gauspcc_tpu_torch/utils/image.py:13-68.
- Adam and its schedules: gauspcc_tpu_torch/utils/optim.py:20-88 and
  gauspcc_tpu_torch/models/hac/train.py:27-107 (OptConfig's defaults and
  the group of each leaf).
- caps: gauspcc_tpu_torch/models/hac/pipeline.py:59-131 (`select_eval_d`,
  `select_eval_k`, `adapt_caps`).

Departures: the rasterizer is `reference/raster.py` (its blend is the plain
function, with a chunked gradient); every matrix product runs in float32
with TF32 off unless `precision(tf32=True)` asks for the control; the
step's screen-space statistics, which nothing compares, are not kept.

Imports nothing of the program.
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import numpy as np
import torch

from portbench.reference import raster

# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------


class HACShape(NamedTuple):
    feat_dim: int
    n_offsets: int
    voxel_size: float
    n_features_per_level: int
    log2_hashmap_size: int
    log2_hashmap_size_2d: int
    resolutions_3d: tuple
    resolutions_2d: tuple
    q_feat: float
    q_scaling: float
    q_offsets: float

    @classmethod
    def from_config(cls, conf: dict) -> "HACShape":
        m = conf["model"]
        return cls(feat_dim=m["feat_dim"], n_offsets=m["n_offsets"],
                   voxel_size=m["voxel_size"],
                   n_features_per_level=m["n_features_per_level"],
                   log2_hashmap_size=m["log2_hashmap_size"],
                   log2_hashmap_size_2d=m["log2_hashmap_size_2d"],
                   resolutions_3d=tuple(m["resolutions_3d"]),
                   resolutions_2d=tuple(m["resolutions_2d"]),
                   q_feat=m["q_feat"], q_scaling=m["q_scaling"],
                   q_offsets=m["q_offsets"])

    @property
    def grid_out_dim(self) -> int:
        return (self.feat_dim + 6 + 3 * self.n_offsets) * 2 + 3

    @property
    def enc_dim(self) -> int:
        f = self.n_features_per_level
        return f * len(self.resolutions_3d) + 3 * f * len(self.resolutions_2d)


def table_rows(num_dim: int, resolutions, log2_size: int) -> list[int]:
    """Rows of each level of a hash table (hashgrid.py:47-56)."""
    out = []
    for r in resolutions:
        rows = min(2**log2_size, r**num_dim)
        out.append(int(np.ceil(rows / 8) * 8))
    return out


def leaf_shapes(shape: HACShape, cap: int) -> dict[str, tuple]:
    """Every trainable leaf's shape, by the port's name, in the port's
    order (the anchors' four fields, then the nets' parameters)."""
    k, fd = shape.n_offsets, shape.feat_dim
    out = {"anchors/offset": (cap, k, 3), "anchors/mask": (cap, k, 1),
           "anchors/anchor_feat": (cap, fd), "anchors/scaling": (cap, 6)}
    n3 = sum(table_rows(3, shape.resolutions_3d, shape.log2_hashmap_size))
    n2 = sum(table_rows(2, shape.resolutions_2d, shape.log2_hashmap_size_2d))
    f = shape.n_features_per_level
    for name, rows in (("xyz", n3), ("xy", n2), ("xz", n2), ("yz", n2)):
        out[f"nets/tables/{name}"] = (rows, f)
    in_dim = fd + 4
    for name, d_in, d_h, d_out in (
            ("mlp_opacity", in_dim, fd, k), ("mlp_cov", in_dim, fd, 7 * k),
            ("mlp_color", in_dim, fd, 3 * k),
            ("mlp_grid", shape.enc_dim, 2 * fd, shape.grid_out_dim),
            ("mlp_deform", shape.enc_dim, 2 * fd, 2 * k)):
        out[f"nets/{name}/fc0/weight"] = (d_h, d_in)
        out[f"nets/{name}/fc0/bias"] = (d_h,)
        out[f"nets/{name}/fc1/weight"] = (d_out, d_h)
        out[f"nets/{name}/fc1/bias"] = (d_out,)
    return out


@contextlib.contextmanager
def precision(tf32: bool = False):
    """Matrix products and convolutions in full float32 (the reference),
    or in TF32 (the control); the process's settings are restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


# ---------------------------------------------------------------------------
# STEs, noise, bits
# ---------------------------------------------------------------------------

CLAMP_STEPS = 15_000
LIKELIHOOD_BOUND = 1e-6


class _STEBinary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.where(x >= 0, 1.0, -1.0).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * (x.abs() <= 1.0).to(g.dtype)


class _STEMultistep(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, q, x_mean):
        x = torch.clamp(x, x_mean - CLAMP_STEPS * q, x_mean + CLAMP_STEPS * q)
        return torch.round(x / q) * q

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _LowBound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.clamp_min(x, LIKELIHOOD_BOUND)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * ((x >= LIKELIHOOD_BOUND) | (g < 0.0)).to(g.dtype)


def ste_round(x):
    return x + (torch.round(x) - x).detach()


def noise_quant(x, q, u):
    return x + (u - 0.5) * q


def gaussian_bits(x, mean, scale, q, x_mean):
    lo = (x_mean - CLAMP_STEPS * q).detach()
    hi = (x_mean + CLAMP_STEPS * q).detach()
    x = torch.clamp(x, lo, hi)
    scale = torch.clamp_min(scale, 1e-9)

    def cdf(v):
        return 0.5 * torch.special.erfc(-(v - mean) / (scale * math.sqrt(2.0)))

    diff = cdf(x + 0.5 * q) - cdf(x - 0.5 * q)
    mass = torch.where(diff >= 0, diff, -diff)
    return -torch.log2(_LowBound.apply(mass))


def binary_size_bits(binary01):
    total = binary01.numel()
    pos = binary01.sum()
    p1 = torch.clamp(pos / total, 1e-6, 1.0 - 1e-6)
    return pos * (-torch.log2(p1)) + (total - pos) * (-torch.log2(1.0 - p1)) + 32.0


# ---------------------------------------------------------------------------
# the context
# ---------------------------------------------------------------------------

_PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF


def grid_encode(num_dim: int, resolutions, rows_per_level, table, x):
    d = num_dim
    i = torch.arange(2**d, device=x.device)
    corners = (i[:, None] >> torch.arange(d, device=x.device)) & 1
    oob = ((x < 0.0) | (x > 1.0)).any(-1)
    outs = []
    offset = 0
    for r, rows in zip(resolutions, rows_per_level):
        pos = x * float(r - 2) + 0.5
        pos_grid = torch.floor(pos)
        frac = pos - pos_grid
        pos_grid = pos_grid.to(torch.int64)
        cg = torch.clamp_max(pos_grid[:, None, :] + corners[None], r - 1)
        w = torch.where(corners[None] == 0, 1.0 - frac[:, None, :],
                        frac[:, None, :]).prod(-1)
        border = ((cg == 0) | (cg == r - 1)).any(-1)
        w = torch.where(border, 0.0, w)
        w = w / (w.sum(-1, keepdim=True) + 1e-9)
        if r**d <= rows:
            idx = sum(cg[..., k] * r**k for k in range(d))
        else:
            h = torch.zeros(cg.shape[:2], dtype=torch.int64, device=x.device)
            for k in range(d):
                h = h ^ (((cg[..., k] & _U32) * _PRIMES[k]) & _U32)
            idx = h % rows
        idx = (idx % rows) + offset
        outs.append((table[idx] * w[..., None]).sum(1))
        offset += rows
    out = torch.cat(outs, -1)
    return torch.where(oob[:, None], 0.0, out)


def context_features(P: dict, shape: HACShape, xn):
    r3 = table_rows(3, shape.resolutions_3d, shape.log2_hashmap_size)
    r2 = table_rows(2, shape.resolutions_2d, shape.log2_hashmap_size_2d)
    tb = {n: _STEBinary.apply(P[f"nets/tables/{n}"])
          for n in ("xyz", "xy", "xz", "yz")}
    return torch.cat([
        grid_encode(3, shape.resolutions_3d, r3, tb["xyz"], xn),
        grid_encode(2, shape.resolutions_2d, r2, tb["xy"], xn[:, 0:2]),
        grid_encode(2, shape.resolutions_2d, r2, tb["xz"], xn[:, 0::2]),
        grid_encode(2, shape.resolutions_2d, r2, tb["yz"], xn[:, 1:3]),
    ], -1)


def mlp(P: dict, name: str, x, out_act=None):
    h = torch.relu(x @ P[f"nets/{name}/fc0/weight"].T + P[f"nets/{name}/fc0/bias"])
    y = h @ P[f"nets/{name}/fc1/weight"].T + P[f"nets/{name}/fc1/bias"]
    return out_act(y) if out_act is not None else y


def context_heads(out, shape: HACShape) -> dict:
    fd, k = shape.feat_dim, shape.n_offsets
    (mean, scale, mean_sc, scale_sc, mean_of, scale_of,
     q_feat_adj, q_sc_adj, q_of_adj) = torch.split(
        out, [fd, fd, 6, 6, 3 * k, 3 * k, 1, 1, 1], dim=1)
    return {"mean": mean, "scale": scale, "mean_scaling": mean_sc,
            "scale_scaling": scale_sc, "mean_offsets": mean_of,
            "scale_offsets": scale_of,
            "q_feat": shape.q_feat * (1 + torch.tanh(q_feat_adj)),
            "q_scaling": shape.q_scaling * (1 + torch.tanh(q_sc_adj)),
            "q_offsets": shape.q_offsets * (1 + torch.tanh(q_of_adj))}


def anchor_bound(anchor, valid):
    """The context's box: the valid anchors' AABB grown by 20%
    (model.py:270-283)."""
    v = valid[:, None]
    big = 1e9
    mn = torch.where(v, anchor, big).amin(0, keepdim=True)
    mx = torch.where(v, anchor, -big).amax(0, keepdim=True)
    mn = torch.where(mn < 0, mn * 1.2, mn * 0.8)
    mx = torch.where(mx > 0, mx * 1.2, mx * 0.8)
    return mn, mx


# ---------------------------------------------------------------------------
# the scene: neural Gaussians, render, objective
# ---------------------------------------------------------------------------


class Camera(NamedTuple):
    viewmatrix: torch.Tensor  # [4, 4] W2V^T
    camera_center: torch.Tensor  # [3]
    image: torch.Tensor | None = None  # [3, H, W]


def _mask(P):
    s = torch.sigmoid(P["anchors/mask"])
    return ((s > 0.01).to(torch.float32) - s).detach() + s


def _live_means(P, rest, shape: HACShape):
    valid_f = rest["valid"].to(torch.float32)[:, None]
    n_live = torch.clamp_min(valid_f.sum(), 1.0)
    feat_mean = (P["anchors/anchor_feat"] * valid_f).sum() / (n_live * shape.feat_dim)
    scaling_mean = (torch.exp(P["anchors/scaling"]) * valid_f).sum() / (n_live * 6)
    offset_mean = (P["anchors/offset"] * valid_f[:, :, None]).sum() / (
        n_live * 3 * shape.n_offsets)
    return feat_mean, scaling_mean, offset_mean


def visible_anchors(P, rest, shape: HACShape, cam: Camera,
                    rcfg: raster.RasterConfig):
    with torch.no_grad():
        anchor = ste_round(rest["anchor"] / shape.voxel_size) * shape.voxel_size
        return raster.project(anchor, torch.exp(P["anchors/scaling"])[:, :3],
                              rest["rotation"], cam.viewmatrix, rcfg,
                              rest["valid"]).radius > 0


def neural_gaussians(P, rest, shape: HACShape, cam: Camera, vis, *,
                     training: bool, noise=None):
    """(xyz, color, opacity, scaling, rot, valid, rate) of every anchor's
    K Gaussians: training is phase 2 (context-adaptive noise `noise` and
    the rate terms), eval the STE-quantised attributes."""
    k = shape.n_offsets
    vis = vis & rest["valid"]
    anchor = ste_round(rest["anchor"] / shape.voxel_size) * shape.voxel_size
    feat = P["anchors/anchor_feat"]
    grid_offsets = P["anchors/offset"]
    grid_scaling = torch.exp(P["anchors/scaling"])
    binary_mask = _mask(P)
    xn = (anchor - rest["x_bound_min"]) / (rest["x_bound_max"] - rest["x_bound_min"])
    ctx = context_heads(mlp(P, "mlp_grid", context_features(P, shape, xn)), shape)
    feat_mean, scaling_mean, offset_mean = _live_means(P, rest, shape)
    rate = None
    if training:
        u_feat, u_scaling, u_offsets = noise
        feat = noise_quant(feat, ctx["q_feat"], u_feat)
        grid_scaling = noise_quant(grid_scaling, ctx["q_scaling"], u_scaling)
        grid_offsets = noise_quant(grid_offsets, ctx["q_offsets"][:, None, :],
                                   u_offsets)
        rate = _rate(P, rest, shape, ctx, vis, binary_mask, feat,
                     grid_scaling, grid_offsets, feat_mean, scaling_mean,
                     offset_mean)
    else:
        feat = _STEMultistep.apply(feat, ctx["q_feat"], feat_mean)
        grid_scaling = _STEMultistep.apply(grid_scaling, ctx["q_scaling"],
                                           scaling_mean)
        grid_offsets = _STEMultistep.apply(
            grid_offsets, ctx["q_offsets"][:, None, :], offset_mean)

    ob_view = anchor - cam.camera_center[None, :]
    ob_dist = torch.linalg.norm(ob_view, dim=1, keepdim=True) + 1e-9
    ob_view = ob_view / ob_dist
    cat_local = torch.cat([feat, ob_view, ob_dist], 1)
    opacity = mlp(P, "mlp_opacity", cat_local, torch.tanh).reshape(-1, 1)
    opacity = opacity * binary_mask.reshape(-1, 1)
    g_valid = (opacity[:, 0] > 0.0) & torch.repeat_interleave(vis, k)
    color = mlp(P, "mlp_color", cat_local, torch.sigmoid).reshape(-1, 3)
    scale_rot = mlp(P, "mlp_cov", cat_local).reshape(-1, 7)
    scaling_rep = torch.repeat_interleave(grid_scaling, k, dim=0)
    anchor_rep = torch.repeat_interleave(anchor, k, dim=0)
    offsets = grid_offsets.reshape(-1, 3)
    scaling = scaling_rep[:, 3:] * torch.sigmoid(scale_rot[:, :3])
    rot = scale_rot[:, 3:7] / (
        torch.linalg.norm(scale_rot[:, 3:7], dim=-1, keepdim=True) + 1e-9)
    xyz = anchor_rep + offsets * scaling_rep[:, :3]
    return xyz, color, opacity, scaling, rot, g_valid, rate


def _rate(P, rest, shape, ctx, vis, binary_mask, feat, grid_scaling,
          grid_offsets, feat_mean, scaling_mean, offset_mean):
    k = shape.n_offsets
    mask_anchor = (_mask(P).sum(1)[:, 0] > 0) & rest["valid"]
    sel = (vis & mask_anchor)[:, None].to(torch.float32)
    mask3 = torch.repeat_interleave(binary_mask, 3, dim=-1).reshape(-1, 3 * k)
    bit_feat = gaussian_bits(feat, ctx["mean"], ctx["scale"], ctx["q_feat"],
                             feat_mean) * sel
    bit_scaling = gaussian_bits(grid_scaling, ctx["mean_scaling"],
                                ctx["scale_scaling"], ctx["q_scaling"],
                                scaling_mean) * sel
    bit_offsets = gaussian_bits(
        grid_offsets.reshape(-1, 3 * k), ctx["mean_offsets"],
        ctx["scale_offsets"], ctx["q_offsets"], offset_mean) * mask3 * sel
    n_vis = torch.clamp_min(vis.to(torch.float32).sum(), 1.0)
    mask_anchor_rate = sel.sum() / n_vis
    denom = torch.clamp_min(sel.sum(), 1.0)
    return (bit_feat.sum() + bit_scaling.sum() + bit_offsets.sum()) / (
        denom * (shape.feat_dim + 6 + 3 * k)) * mask_anchor_rate


def _band(n: int, device) -> torch.Tensor:
    x = np.arange(11) - 5
    g = np.exp(-(x**2) / (2 * 1.5**2))
    win = (g / g.sum()).astype(np.float32)
    t = np.arange(n)[None, :] - np.arange(n)[:, None] + 5
    inside = (t >= 0) & (t < 11)
    return torch.from_numpy(np.where(inside, win[np.clip(t, 0, 10)], 0.0
                                     ).astype(np.float32)).to(device)


def ssim(a, b):
    _, h, w = a.shape
    bh, bw = _band(h, a.device), _band(w, a.device)

    def filt(img):
        return bh @ img @ bw.T

    c1, c2 = 0.01**2, 0.03**2
    mu_a, mu_b = filt(a), filt(b)
    mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    sigma_aa = filt(a * a) - mu_aa
    sigma_bb = filt(b * b) - mu_bb
    sigma_ab = filt(a * b) - mu_ab
    m = ((2 * mu_ab + c1) * (2 * sigma_ab + c2)) / (
        (mu_aa + mu_bb + c1) * (sigma_aa + sigma_bb + c2))
    return m.mean()


def render(P, rest, shape: HACShape, cam: Camera, rcfg: raster.RasterConfig,
           bg, *, training: bool = False, noise=None):
    """(image [3, H, W], rate or None, scaling and valid of the Gaussians)."""
    vis = visible_anchors(P, rest, shape, cam, rcfg)
    xyz, color, opacity, scaling, rot, g_valid, rate = neural_gaussians(
        P, rest, shape, cam, vis, training=training, noise=noise)
    img, _ = raster.rasterize(xyz, color, opacity, scaling, rot,
                              cam.viewmatrix, bg, rcfg, valid=g_valid)
    return img, rate, scaling, g_valid


def loss_phase2(P, rest, shape: HACShape, cam: Camera,
                rcfg: raster.RasterConfig, bg, noise, lmbda: float,
                lambda_dssim: float):
    """HAC's phase-2 objective on one view (render.py:100-155)."""
    img, rate, scaling, g_valid = render(P, rest, shape, cam, rcfg, bg,
                                         training=True, noise=noise)
    gt = cam.image
    l1 = (img - gt).abs().mean()
    vmask = g_valid.to(torch.float32)
    volume = scaling[:, 0] * scaling[:, 1] * scaling[:, 2]
    scaling_reg = (volume * vmask).sum() / torch.clamp_min(vmask.sum(), 1.0)
    loss = (1.0 - lambda_dssim) * l1 + lambda_dssim * (1.0 - ssim(img, gt))
    loss = loss + 0.01 * scaling_reg
    flat = torch.cat([P[f"nets/tables/{n}"] for n in ("xyz", "xy", "xz", "yz")])
    bit_hash = binary_size_bits((_STEBinary.apply(flat) + 1.0) / 2.0)
    n_valid = torch.clamp_min(rest["valid"].to(torch.float32).sum(), 1.0)
    denom = n_valid * (shape.feat_dim + 6 + 3 * shape.n_offsets)
    loss = loss + lmbda * (rate + bit_hash / denom)
    return loss + 5e-4 * torch.sigmoid(P["anchors/mask"]).mean()


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------

# OptConfig's defaults (models/hac/train.py:31-69): (init, final, delay_mult)
LR = {
    "offset": (0.01, 0.0001, 0.01), "mask": (0.01, 0.0001, 0.01),
    "anchor_feat": (0.0075, 0.0075, 1.0), "scaling": (0.007, 0.007, 1.0),
    "mlp_opacity": (2e-3, 2e-5, 1.0), "mlp_cov": (4e-3, 4e-3, 1.0),
    "mlp_color": (8e-3, 5e-5, 1.0), "tables": (5e-3, 1e-5, 0.33),
    "mlp_grid": (5e-3, 1e-5, 1.0), "mlp_deform": (5e-3, 5e-4, 1.0),
}
SPATIAL = ("offset", "mask")  # scaled by the scene's extent
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-15


def expon_lr(lr_init, lr_final, max_steps, step) -> float:
    """get_expon_lr_func in float32, without a delay (none of HAC's groups
    sets lr_delay_steps, so lr_delay_mult never acts)."""
    f32 = np.float32
    if lr_init == 0.0 or lr_final == 0.0:
        return 0.0
    t = np.clip(f32(step) / f32(max_steps), f32(0), f32(1))
    lr = f32(np.exp(f32(np.log(lr_init)) * (f32(1) - t)
                    + f32(np.log(lr_final)) * t))
    return 0.0 if step < 0 else float(lr)


def group_of(name: str) -> str:
    keys = name.split("/")
    return keys[1]


def adam_step_(P: dict, grads: dict, mu: dict, nu: dict, count: int,
               extent: float, iterations: int) -> None:
    """One Adam update of every leaf in place, at step `count` (the
    counter after its increment)."""
    f32 = np.float32
    bc1 = float(f32(1) - f32(ADAM_B1) ** f32(count))
    bc2 = float(f32(1) - f32(ADAM_B2) ** f32(count))
    for name, p in P.items():
        g = grads[name]
        mu[name].mul_(ADAM_B1).add_((1 - ADAM_B1) * g)
        nu[name].mul_(ADAM_B2).add_((1 - ADAM_B2) * (g * g))
        grp = group_of(name)
        lr_init, lr_final, _ = LR[grp]
        scale = extent if grp in SPATIAL else 1.0
        lr = expon_lr(lr_init * scale, lr_final * scale, iterations, count)
        u = (mu[name] / bc1) / (torch.sqrt(nu[name] / bc2) + ADAM_EPS)
        p.add_(-lr * u)


def train_steps(P0: dict, rest: dict, shape: HACShape, cams: list,
                noises: list, rcfg: raster.RasterConfig, *, count0: int,
                extent: float, iterations: int, lmbda: float,
                lambda_dssim: float, white_background: bool):
    """Phase-2 steps from the leaves P0 (copied), one camera and one noise
    draw a step, with moments that start at zero and the counter at
    count0. Returns (losses [n], the first step's gradients, the leaves
    after the first step, the leaves after the last step)."""
    P = {k: v.detach().clone() for k, v in P0.items()}
    mu = {k: torch.zeros_like(v) for k, v in P.items()}
    nu = {k: torch.zeros_like(v) for k, v in P.items()}
    dev = next(iter(P.values())).device
    bg = torch.full((3,), 1.0 if white_background else 0.0, device=dev)
    losses, first, after1 = [], None, None
    for i, (cam, noise) in enumerate(zip(cams, noises)):
        leaves = {k: v.requires_grad_(True) for k, v in P.items()}
        with torch.enable_grad():
            loss = loss_phase2(leaves, rest, shape, cam, rcfg, bg, noise,
                               lmbda, lambda_dssim)
            got = torch.autograd.grad(loss, list(leaves.values()),
                                      allow_unused=True)
        grads = {}
        for (k, v), g in zip(leaves.items(), got):
            g = torch.zeros_like(v) if g is None else g
            grads[k] = torch.where(torch.isfinite(g), g, 0.0)
            v.requires_grad_(False)
        if i == 0:
            first = {k: g.clone() for k, g in grads.items()}
        adam_step_(P, grads, mu, nu, count0 + i + 1, extent, iterations)
        if i == 0:
            after1 = {k: v.detach().clone() for k, v in P.items()}
        losses.append(float(loss.detach()))
    return losses, first, after1, P


# ---------------------------------------------------------------------------
# caps
# ---------------------------------------------------------------------------


@torch.no_grad()
def adapt_caps(P, rest, shape: HACShape, rcfg: raster.RasterConfig,
               cam: Camera, max_d: int = 256, max_k: int = 1024):
    """One check of the training caps (pipeline.py:107-131): double D when
    over 5% of the visible Gaussians overflow it, K when over 2% of the
    occupied tiles do. Returns (rcfg, grew)."""
    vis = visible_anchors(P, rest, shape, cam, rcfg)
    xyz, _, _, scaling, rot, g_valid, _ = neural_gaussians(
        P, rest, shape, cam, vis, training=False)
    sat = raster.tile_saturation(xyz, scaling, rot, cam.viewmatrix, rcfg,
                                 valid=g_valid)
    over_d, over_k = float(sat["frac_gauss_over_d"]), float(sat["frac_tiles_over_k"])
    grew = False
    if over_d > 0.05 and rcfg.max_tiles_per_gaussian < max_d:
        rcfg = rcfg._replace(max_tiles_per_gaussian=rcfg.max_tiles_per_gaussian * 2)
        grew = True
    if over_k > 0.02 and rcfg.max_gaussians_per_tile < max_k:
        rcfg = rcfg._replace(max_gaussians_per_tile=rcfg.max_gaussians_per_tile * 2)
        grew = True
    return rcfg, grew


def psnr(a, b):
    mse = ((a - b) ** 2).mean()
    return 20.0 * torch.log10(1.0 / torch.sqrt(torch.clamp_min(mse, 1e-12)))


@torch.no_grad()
def render_image(P, rest, shape, cam, rcfg, bg):
    return render(P, rest, shape, cam, rcfg, bg)[0]


@torch.no_grad()
def select_eval_k(P, rest, shape, cam, rcfg, bg, start_k=256, max_k=4096,
                  tol_db=45.0) -> int:
    """The smallest K whose render matches the 2K render to 45 dB
    (pipeline.py:82-104); `rcfg` gives the frame and D 32."""
    k = start_k
    img_k = render_image(P, rest, shape, cam, rcfg._replace(
        max_gaussians_per_tile=k), bg)
    while k < max_k:
        img_2k = render_image(P, rest, shape, cam, rcfg._replace(
            max_gaussians_per_tile=2 * k), bg)
        if float(psnr(img_k, img_2k)) >= tol_db:
            return k
        k *= 2
        img_k = img_2k
    return k


@torch.no_grad()
def select_eval_d(P, rest, shape, cams, rcfg, cap: int = 128) -> int:
    """The smallest power-of-two D from 4 covering every footprint, at most
    `cap` (pipeline.py:59-79)."""
    worst = 0
    for cam in cams:
        vis = visible_anchors(P, rest, shape, cam, rcfg)
        xyz, _, _, scaling, rot, g_valid, _ = neural_gaussians(
            P, rest, shape, cam, vis, training=False)
        fp = raster.max_tile_footprint(xyz, scaling, rot, cam.viewmatrix,
                                       rcfg, valid=g_valid)
        worst = max(worst, int(fp))
    d = 4
    while d < min(worst, cap):
        d *= 2
    return d
