"""Plain float32 reference of CAT-3DGS's phase-5 training step: the PCA
triplane hyperprior, the channel-wise context, the ARMs' rate of the
planes, the view-frequency-weighted mask, the objective and CAT's Adam
groups.

Written from the semantics of GausPcc's CAT-3DGS (scene/triplane.py,
scene/arm.py, scene/gaussian_model.py, train.py:156-258 as the port's
gauspcc_tpu_torch/models/cat3dgs/ restates them), over a flat dict of
tensors (the leaves by the port's names, "nets/field/scales/0",
"nets/mlp_chcm/1/fc0/weight", ...), not by calling or copying the port:

- the frame: z = (x - mean) R / (3 std + 1e-9), contracted into the
  radius-2 ball and halved into [-1, 1];
- the bilinear triplane sample: align_corners=False pixel centres, four
  taps read from the plane padded by one zero pixel a side (a tap outside
  the plane reads zero);
- the planes quantised with additive noise at a gain of 2^g a scale, read
  back over the gain;
- the ARM: the 12 causal neighbours of a pixel are the first 12 entries
  of its 5x5 window (`F.unfold` over the zero-padded plane), four 16-wide
  layers (a layer mapping a width to itself adds its input back), a
  (mu, log scale) head; the rate is -log2 of the Laplace bin mass, floored
  at 2^-16;
- the feature slices' Gaussians: slice 0's from mlp_attr, slice i's from
  mlp_chcm[i - 1] over the slices before it (teacher-forced on the noisy
  features);
- the objective: HAC's image terms, max(1e-3, 0.3 lmbda) mean(sigmoid(mask))
  and lmbda times (the attributes' bits over the selected anchors + the
  planes' bits) over max(selected, 1) (F + 6 + 3K); the mask's logits are
  scaled by the view-frequency weights where it selects anchors for the
  rate (not where it gates the Gaussians' opacity);
- Adam: HAC's per-group rates (reference/hac.py `LR`), a net without a group
  of its own (the field, mlp_attr, mlp_chcm) at mlp_grid's;
- the frame's fit (`fit_frame`): the anchors' Local Outlier Factor (50
  neighbours, the 5% largest factors dropped, as scikit-learn's
  LocalOutlierFactor), then the inliers' mean and the eigenvectors of
  their covariance by decreasing eigenvalue, in float64.

Shared with the HAC reference (reference/hac.py): the STE round, the
Gaussian bits, the MLP, SSIM, the prefilter, the learning-rate schedule;
the rasterizer is reference/raster.py. Every matrix product runs in
float32 with TF32 off unless `hac.precision(tf32=True)` asks for the
control. The optional chcm heads of the offsets and the scaling are not
written here (the configuration has them off).

Imports nothing of the program.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import hac as ref_hac
from portbench.reference import raster

PLANE_AXES = ((1, 2), (0, 2), (0, 1))  # plane p is read at (u, v) = these axes
ARM_OF_PLANE = ("xy", "xz", "yz")  # plane p's ARM, by the port's key
N_CTX = 12
RATE_FLOOR = 2.0**-16


class CATShape(NamedTuple):
    feat_dim: int
    n_offsets: int
    voxel_size: float
    chcm_slices: tuple
    tri_feat: int
    base_resolution: int
    multiscale: tuple
    contract: bool
    arm_layers: tuple
    q_feat: float
    q_scaling: float
    q_offsets: float

    @classmethod
    def from_config(cls, conf: dict) -> "CATShape":
        m = conf["model"]
        if m.get("chcm_for_offsets") or m.get("chcm_for_scaling"):
            raise ValueError("the reference has no chcm heads of the offsets "
                             "or the scaling")
        return cls(feat_dim=m["feat_dim"], n_offsets=m["n_offsets"],
                   voxel_size=m["voxel_size"],
                   chcm_slices=tuple(m["chcm_slices"]), tri_feat=m["tri_feat"],
                   base_resolution=m["base_resolution"],
                   multiscale=tuple(m["multiscale"]), contract=m["contract"],
                   arm_layers=tuple(m["arm_layers"]), q_feat=m["q_feat"],
                   q_scaling=m["q_scaling"], q_offsets=m["q_offsets"])

    @property
    def resolutions(self) -> list:
        return [self.base_resolution * s for s in self.multiscale]

    @property
    def ctx_dim(self) -> int:
        return 3 * self.tri_feat * len(self.multiscale)

    @property
    def grid_out_dim(self) -> int:
        return 2 * self.chcm_slices[0] + 2 * (6 + 3 * self.n_offsets) + 3

    @property
    def params_per_anchor(self) -> int:
        return self.feat_dim + 6 + 3 * self.n_offsets


def arm_widths(shape: CATShape) -> list:
    """(in, out, key) of each ARM layer: `res_lin` where a layer maps a
    width to itself, else `lin`; the head last."""
    out, d_in = [], N_CTX
    for d in shape.arm_layers:
        out.append((d_in, d, "res_lin" if d_in == d else "lin"))
        d_in = d
    out.append((d_in, 2, "lin"))
    return out


def leaf_shapes(shape: CATShape, cap: int) -> dict[str, tuple]:
    """Every trainable leaf's shape, by the port's name."""
    k, fd = shape.n_offsets, shape.feat_dim
    out = {"anchors/offset": (cap, k, 3), "anchors/mask": (cap, k, 1),
           "anchors/anchor_feat": (cap, fd), "anchors/scaling": (cap, 6)}

    def dense(name, d_in, d_out):
        out[f"{name}/weight"] = (d_out, d_in)
        out[f"{name}/bias"] = (d_out,)

    for name, d_out in (("mlp_opacity", k), ("mlp_cov", 7 * k),
                        ("mlp_color", 3 * k)):
        dense(f"nets/{name}/fc0", fd + 4, fd)
        dense(f"nets/{name}/fc1", fd, d_out)
    for i, r in enumerate(shape.resolutions):
        out[f"nets/field/scales/{i}"] = (3, shape.tri_feat, r, r)
    for g in ARM_OF_PLANE:
        for j, (d_in, d_out, key) in enumerate(arm_widths(shape)):
            dense(f"nets/field/arms/{g}/layers/{j}/{key}", d_in, d_out)
    out["nets/field/gains"] = (len(shape.multiscale),)
    out["nets/field/rotation"] = (3, 3)
    out["nets/field/pca_mean"] = (3,)
    out["nets/field/pca_std"] = (3,)
    dense("nets/mlp_attr/fc0", shape.ctx_dim, 2 * fd)
    dense("nets/mlp_attr/fc1", 2 * fd, shape.grid_out_dim)
    bounds = np.cumsum(shape.chcm_slices)
    for i in range(len(shape.chcm_slices) - 1):
        dense(f"nets/mlp_chcm/{i}/fc0", int(bounds[i]), 2 * fd)
        dense(f"nets/mlp_chcm/{i}/fc1", 2 * fd, 2 * shape.chcm_slices[i + 1])
    return out


# ---------------------------------------------------------------------------
# the triplane field
# ---------------------------------------------------------------------------


def lof_inliers(x, n_neighbors: int = 50, contamination: float = 0.05,
                chunk: int = 1024):
    """bool [N]: the points x [N, 3] (float64) whose Local Outlier Factor is
    not among the `contamination` share of the largest. Each point's
    n_neighbors nearest others by brute force, their reachability distances
    max(d, k-distance of the neighbour), the local reachability density
    1 / (mean + 1e-10), the factor mean(lrd[neighbours]) / lrd."""
    n = x.shape[0]
    k = min(n_neighbors, n - 1)
    dist = torch.empty((n, k), dtype=x.dtype, device=x.device)
    idx = torch.empty((n, k), dtype=torch.int64, device=x.device)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        d2 = sum((x[lo:hi, c, None] - x[None, :, c]) ** 2 for c in range(3))
        rows = torch.arange(hi - lo, device=x.device)
        d2[rows, rows + lo] = float("inf")  # a point is not its own neighbour
        d2k, ik = torch.topk(d2, k, dim=1, largest=False)
        dist[lo:hi], idx[lo:hi] = torch.sqrt(d2k), ik
    reach = torch.maximum(dist, dist[idx, k - 1])
    lrd = 1.0 / (reach.mean(1) + 1e-10)
    factor = (lrd[idx] / lrd[:, None]).mean(1)
    return -factor >= torch.quantile(-factor, contamination)


def fit_frame(points, n_neighbors: int = 50, contamination: float = 0.05):
    """(rotation [3, 3], its columns the principal axes by decreasing
    variance; mean [3]; std [3]) of the anchors [N, 3], float64, after
    dropping the local outliers when there are more than twice
    n_neighbors points."""
    x = points.to(torch.float64)
    if x.shape[0] > 2 * n_neighbors:
        x = x[lof_inliers(x, n_neighbors, contamination)]
    mean = x.mean(0)
    d = x - mean
    eigval, eigvec = torch.linalg.eigh(d.T @ d / (x.shape[0] - 1))
    order = torch.argsort(eigval, descending=True)
    return (eigvec[:, order], mean,
            torch.sqrt(torch.clamp_min(eigval[order], 1e-12)))



def frame(P: dict, shape: CATShape, x):
    """Anchors [N, 3] into the field's [-1, 1] frame."""
    z = (x - P["nets/field/pca_mean"]) @ P["nets/field/rotation"]
    z = z / (3.0 * P["nets/field/pca_std"] + 1e-9)
    if not shape.contract:
        return z
    r2 = torch.clamp_min((z * z).sum(-1, keepdim=True),
                         float(np.finfo(np.float32).eps))
    r = torch.sqrt(r2)
    return torch.where(r2 <= 1.0, z, (2.0 - 1.0 / r) * z / r) * 0.5


def bilinear(plane, u, v):
    """plane [C, H, W] at (u, v) in [-1, 1] (u along W, v along H), zero
    outside: [N, C]."""
    _, h, w = plane.shape
    padded = F.pad(plane, (1, 1, 1, 1))  # a zero pixel on every side
    x = (u + 1.0) * 0.5 * w - 0.5
    y = (v + 1.0) * 0.5 * h - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0)[:, None], (y - y0)[:, None]
    xi = x0.to(torch.int64) + 1  # into the padded plane
    yi = y0.to(torch.int64) + 1

    def tap(dy, dx):
        yy = torch.clamp(yi + dy, 0, h + 1)
        xx = torch.clamp(xi + dx, 0, w + 1)
        return padded[:, yy, xx].T

    return (tap(0, 0) * (1 - fx) * (1 - fy) + tap(0, 1) * fx * (1 - fy)
            + tap(1, 0) * (1 - fx) * fy + tap(1, 1) * fx * fy)


def noisy_planes(P: dict, shape: CATShape, u_planes: list) -> list:
    """Each scale's planes times 2^gain plus the step's noise."""
    return [P[f"nets/field/scales/{i}"] * torch.pow(2.0, P["nets/field/gains"][i])
            + u_planes[i] for i in range(len(shape.multiscale))]


def field_features(P: dict, shape: CATShape, x, planes_q: list):
    """The triplane features of anchors x [N, 3]: for each scale, its three
    planes over the gain, side by side: [N, 3 C S]."""
    z = frame(P, shape, x)
    out = []
    for i, pq in enumerate(planes_q):
        planes = pq / torch.pow(2.0, P["nets/field/gains"][i])
        for p, (a, b) in enumerate(PLANE_AXES):
            out.append(bilinear(planes[p], z[:, a], z[:, b]))
    return torch.cat(out, -1)


# ---------------------------------------------------------------------------
# the ARMs' rate of the planes
# ---------------------------------------------------------------------------


def causal_context(latent):
    """[H, W] -> each pixel's 12 causal neighbours [H W, 12], zero outside."""
    win = F.unfold(latent[None, None], kernel_size=5, padding=2)  # [1, 25, HW]
    return win[0, :N_CTX].T


def arm_raw(P: dict, shape: CATShape, group: str, ctx):
    x = ctx
    layers = arm_widths(shape)
    for j, (d_in, d_out, key) in enumerate(layers):
        name = f"nets/field/arms/{group}/layers/{j}/{key}"
        y = x @ P[name + "/weight"].T + P[name + "/bias"]
        if j == len(layers) - 1:
            return y
        x = torch.relu(y + x if d_in == d_out else y)


def laplace_mass(x, mu, scale):
    def cdf(t):
        d = t - mu
        return 0.5 - 0.5 * torch.sign(d) * torch.expm1(-torch.abs(d) / scale)

    return cdf(x + 0.5) - cdf(x - 0.5)


def planes_bits(P: dict, shape: CATShape, planes_q: list):
    """The bits of every latent pixel of every plane and channel under its
    group's ARM."""
    total = 0.0
    for pq in planes_q:
        for p, group in enumerate(ARM_OF_PLANE):
            for c in range(pq.shape[1]):
                latent = pq[p, c]
                raw = arm_raw(P, shape, group, causal_context(latent))
                mu = raw[:, 0]
                scale = torch.exp(-0.5 * torch.clamp(raw[:, 1], -10.0, 13.8155))
                mass = laplace_mass(latent.reshape(-1), mu, scale)
                total = total + (-torch.log2(torch.clamp_min(mass, RATE_FLOOR))).sum()
    return total


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------


def hard_mask(logits):
    s = torch.sigmoid(logits)
    return ((s > 0.01).to(torch.float32) - s).detach() + s


def view_weights(P: dict, rest: dict, shape: CATShape, cams: list,
                 rcfg: raster.RasterConfig):
    """Each anchor's count of the cameras that see it over the valid
    anchors' mean count (1 on invalid rows)."""
    with torch.no_grad():
        counts = sum(ref_hac.visible_anchors(P, rest, shape, cam, rcfg)
                     .to(torch.float32) for cam in cams)
        valid = rest["valid"]
        mean = torch.where(valid, counts, 0.0).sum() / torch.clamp_min(
            valid.to(torch.float32).sum(), 1.0)
        return torch.where(valid, counts / torch.clamp_min(mean, 1e-9), 1.0)


def scaffold_gaussians(P, rest, shape: CATShape, cam, vis, feat, scaling,
                       offsets):
    """(xyz, color, opacity, scaling, rot, valid) of every anchor's K
    Gaussians from its attributes (HAC's scaffold, its hard mask unweighted)."""
    k = shape.n_offsets
    vis = vis & rest["valid"]
    anchor = ref_hac.ste_round(rest["anchor"] / shape.voxel_size) * shape.voxel_size
    ob_view = anchor - cam.camera_center[None, :]
    ob_dist = torch.linalg.norm(ob_view, dim=1, keepdim=True) + 1e-9
    local = torch.cat([feat, ob_view / ob_dist, ob_dist], 1)
    opacity = ref_hac.mlp(P, "mlp_opacity", local, torch.tanh).reshape(-1, 1)
    opacity = opacity * hard_mask(P["anchors/mask"]).reshape(-1, 1)
    g_valid = (opacity[:, 0] > 0.0) & torch.repeat_interleave(vis, k)
    color = ref_hac.mlp(P, "mlp_color", local, torch.sigmoid).reshape(-1, 3)
    cov = ref_hac.mlp(P, "mlp_cov", local).reshape(-1, 7)
    s_rep = torch.repeat_interleave(scaling, k, dim=0)
    g_scaling = s_rep[:, 3:] * torch.sigmoid(cov[:, :3])
    rot = cov[:, 3:7] / (torch.linalg.norm(cov[:, 3:7], dim=-1, keepdim=True) + 1e-9)
    xyz = (torch.repeat_interleave(anchor, k, dim=0)
           + offsets.reshape(-1, 3) * s_rep[:, :3])
    return xyz, color, opacity, g_scaling, rot, g_valid


def rate_and_attributes(P, rest, shape: CATShape, vis, noise, weights):
    """(rate in bits a parameter, the planes' bits, the rate's denominator,
    the noisy features, scaling and offsets)."""
    k, fd = shape.n_offsets, shape.feat_dim
    u_feat, u_scaling, u_offsets, u_planes = noise
    planes_q = noisy_planes(P, shape, u_planes)
    anchor = ref_hac.ste_round(rest["anchor"] / shape.voxel_size) * shape.voxel_size
    out = ref_hac.mlp(P, "mlp_attr", field_features(P, shape, anchor, planes_q))
    s0 = shape.chcm_slices[0]
    mean0, scale0, mean_sc, scale_sc, mean_of, scale_of, qf, qs, qo = torch.split(
        out, [s0, s0, 6, 6, 3 * k, 3 * k, 1, 1, 1], dim=1)
    q_feat = shape.q_feat * (1 + torch.tanh(qf))
    q_scaling = shape.q_scaling * (1 + torch.tanh(qs))
    q_offsets = shape.q_offsets * (1 + torch.tanh(qo))
    scaling0 = torch.exp(P["anchors/scaling"])
    feat = P["anchors/anchor_feat"] + (u_feat - 0.5) * q_feat
    scaling = scaling0 + (u_scaling - 0.5) * q_scaling
    offsets = P["anchors/offset"] + (u_offsets - 0.5) * q_offsets[:, None, :]
    means, scales = [mean0], [scale0]
    lo = 0
    for i in range(1, len(shape.chcm_slices)):
        lo += shape.chcm_slices[i - 1]
        c = shape.chcm_slices[i]
        o = ref_hac.mlp(P, f"mlp_chcm/{i - 1}", feat[:, :lo])
        means.append(o[:, :c])
        scales.append(o[:, c:])
    mask = hard_mask(P["anchors/mask"] * weights[:, None, None])
    chosen = (mask.sum(1)[:, 0] > 0) & rest["valid"] & vis
    sel = chosen[:, None].to(torch.float32)
    bits_feat = ref_hac.gaussian_bits(feat, torch.cat(means, -1),
                                      torch.cat(scales, -1), q_feat,
                                      P["anchors/anchor_feat"].mean()) * sel
    bits_sc = ref_hac.gaussian_bits(scaling, mean_sc, scale_sc, q_scaling,
                                    scaling0.mean()) * sel
    mask3 = torch.repeat_interleave(mask, 3, dim=-1).reshape(-1, 3 * k)
    bits_of = ref_hac.gaussian_bits(offsets.reshape(-1, 3 * k), mean_of,
                                    scale_of, q_offsets,
                                    P["anchors/offset"].mean()) * mask3 * sel
    plane_bits = planes_bits(P, shape, planes_q)
    denom = torch.clamp_min(sel.sum(), 1.0) * (fd + 6 + 3 * k)
    rate = (bits_feat.sum() + bits_sc.sum() + bits_of.sum() + plane_bits) / denom
    return rate, plane_bits, denom, feat, torch.clamp_min(scaling, 1e-9), offsets


def loss_phase5(P, rest, shape: CATShape, cam, rcfg, bg, noise, weights,
                lmbda: float, lambda_dssim: float):
    """CAT-3DGS's phase-5 objective on one view: (loss, aux) with the
    planes' bits (`plane_bits`), the rate's denominator (`denom`) and which
    Gaussians were drawn (`drawn`, [N K])."""
    vis = ref_hac.visible_anchors(P, rest, shape, cam, rcfg)
    rate, plane_bits, denom, feat, scaling, offsets = rate_and_attributes(
        P, rest, shape, vis, noise, weights)
    xyz, color, opacity, g_scaling, rot, g_valid = scaffold_gaussians(
        P, rest, shape, cam, vis, feat, scaling, offsets)
    img, _ = raster.rasterize(xyz, color, opacity, g_scaling, rot,
                              cam.viewmatrix, bg, rcfg, valid=g_valid)
    gt = cam.image
    vmask = g_valid.to(torch.float32)
    volume = g_scaling[:, 0] * g_scaling[:, 1] * g_scaling[:, 2]
    reg = (volume * vmask).sum() / torch.clamp_min(vmask.sum(), 1.0)
    loss = ((1.0 - lambda_dssim) * (img - gt).abs().mean()
            + lambda_dssim * (1.0 - ref_hac.ssim(img, gt)) + 0.01 * reg)
    loss = loss + max(1e-3, 0.3 * lmbda) * torch.sigmoid(P["anchors/mask"]).mean()
    return loss + lmbda * rate, {"plane_bits": plane_bits, "denom": denom,
                                 "drawn": g_valid}


def group_of(name: str) -> str:
    """CAT's Adam group of a leaf: an anchor field's own, a net's own where
    HAC has one (the scaffold MLPs), else mlp_grid's."""
    keys = name.split("/")
    if keys[0] == "anchors":
        return keys[1]
    return keys[1] if keys[1] in ref_hac.LR else "mlp_grid"


def adam_step_(P: dict, grads: dict, mu: dict, nu: dict, count: int,
               extent: float, iterations: int) -> None:
    f32 = np.float32
    b1, b2 = ref_hac.ADAM_B1, ref_hac.ADAM_B2
    bc1 = float(f32(1) - f32(b1) ** f32(count))
    bc2 = float(f32(1) - f32(b2) ** f32(count))
    for name, p in P.items():
        g = grads[name]
        mu[name].mul_(b1).add_((1 - b1) * g)
        nu[name].mul_(b2).add_((1 - b2) * (g * g))
        grp = group_of(name)
        lr_init, lr_final, _ = ref_hac.LR[grp]
        scale = extent if grp in ref_hac.SPATIAL else 1.0
        lr = ref_hac.expon_lr(lr_init * scale, lr_final * scale, iterations, count)
        p.add_(-lr * (mu[name] / bc1) / (torch.sqrt(nu[name] / bc2)
                                         + ref_hac.ADAM_EPS))


class StepReadings(NamedTuple):
    """What the reference's first steps give: the losses, the first step's
    planes' bits a parameter, the first gradients, the leaves after the
    first step and after the last, and of the first step: the planes' bits
    a parameter in float64 from the same leaves and noise (`arm1_f64`), the
    mask's gradient with every weight 1 (`mask_grad_unit`) and which of the
    anchors' Gaussians were drawn (`drawn`, [N, K, 1])."""

    losses: list
    arm1: float
    first: dict
    after1: dict
    after: dict
    arm1_f64: float
    mask_grad_unit: torch.Tensor
    drawn: torch.Tensor


def planes_bits_f64(P: dict, shape: CATShape, u_planes: list):
    """planes_bits in float64 from the same leaves and noise."""
    P64 = {k: v.detach().to(torch.float64) for k, v in P.items()
           if k.startswith("nets/field/")}
    planes_q = noisy_planes(P64, shape, [u.to(torch.float64) for u in u_planes])
    return planes_bits(P64, shape, planes_q)


def train_steps(P0: dict, rest: dict, shape: CATShape, cams: list,
                noises: list, weights, rcfg: raster.RasterConfig, *,
                count0: int, extent: float, iterations: int, lmbda: float,
                lambda_dssim: float, white_background: bool) -> StepReadings:
    """Phase-5 steps from the leaves P0 (copied), a camera and a noise draw
    a step, Adam's moments from zero at counter count0."""
    P = {k: v.detach().clone() for k, v in P0.items()}
    mu = {k: torch.zeros_like(v) for k, v in P.items()}
    nu = {k: torch.zeros_like(v) for k, v in P.items()}
    dev = next(iter(P.values())).device
    bg = torch.full((3,), 1.0 if white_background else 0.0, device=dev)
    losses, first, after1, extra = [], None, None, {}
    for i, (cam, noise) in enumerate(zip(cams, noises)):
        leaves = {k: v.requires_grad_(True) for k, v in P.items()}
        with torch.enable_grad():
            loss, aux = loss_phase5(leaves, rest, shape, cam, rcfg, bg,
                                    noise, weights, lmbda, lambda_dssim)
            got = torch.autograd.grad(loss, list(leaves.values()),
                                      allow_unused=True)
            if i == 0:
                unit, _ = loss_phase5(leaves, rest, shape, cam, rcfg, bg, noise,
                                      torch.ones_like(weights), lmbda,
                                      lambda_dssim)
                (g_unit,) = torch.autograd.grad(unit, [leaves["anchors/mask"]])
                denom = float(aux["denom"])
                extra = {"arm1": float((aux["plane_bits"] / aux["denom"]).detach()),
                         "arm1_f64": float(planes_bits_f64(P, shape, noise[3]))
                         / denom,
                         "mask_grad_unit": torch.where(torch.isfinite(g_unit),
                                                       g_unit, 0.0),
                         "drawn": aux["drawn"].reshape(-1, shape.n_offsets, 1)}
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
    return StepReadings(losses, extra["arm1"], first, after1, P,
                        extra["arm1_f64"], extra["mask_grad_unit"],
                        extra["drawn"])


@torch.no_grad()
def adapt_caps(P, rest, shape: CATShape, rcfg: raster.RasterConfig, cam,
               max_d: int = 256, max_k: int = 1024):
    """One check of the training caps on the float attributes (the eval
    render of a CAT-3DGS state): double D when over 5% of the visible
    Gaussians overflow it, K when over 2% of the occupied tiles do."""
    vis = ref_hac.visible_anchors(P, rest, shape, cam, rcfg)
    xyz, _, _, scaling, rot, g_valid = scaffold_gaussians(
        P, rest, shape, cam, vis, P["anchors/anchor_feat"],
        torch.exp(P["anchors/scaling"]), P["anchors/offset"])
    sat = raster.tile_saturation(xyz, scaling, rot, cam.viewmatrix, rcfg,
                                 valid=g_valid)
    grew = False
    if float(sat["frac_gauss_over_d"]) > 0.05 and rcfg.max_tiles_per_gaussian < max_d:
        rcfg = rcfg._replace(max_tiles_per_gaussian=rcfg.max_tiles_per_gaussian * 2)
        grew = True
    if float(sat["frac_tiles_over_k"]) > 0.02 and rcfg.max_gaussians_per_tile < max_k:
        rcfg = rcfg._replace(max_gaussians_per_tile=rcfg.max_gaussians_per_tile * 2)
        grew = True
    return rcfg, grew
