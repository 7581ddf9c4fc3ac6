"""HAC scene training: the train step, densification and the optimizer
(counterpart of gauspcc_tpu/models/hac/train.py:27-390).

The step takes the gradient of the objective with respect to every
trainable leaf and to a zero `means2d_extra` (the screen-space gradient),
drops non-finite gradient components, updates the leaves with per-group
Adam and accumulates the densification statistics, all on the device: its
metrics stay tensors, so a step makes no host sync of its own. Anchor
growth and pruning run on the host in numpy every `update_interval`
steps, rewrite the fixed-capacity buffers and remap the Adam moments of
the per-anchor groups. `sort_anchors` puts the anchors in the order the
scene codec codes them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from gauspcc_tpu_torch.models.hac import model as hac
from gauspcc_tpu_torch.models.hac import render as hac_render
from gauspcc_tpu_torch.ops import sparse
from gauspcc_tpu_torch.render import raster
from gauspcc_tpu_torch.utils import optim, profiling


@dataclass
class OptConfig:
    """The reference's OptimizationParams defaults, as the JAX package's."""

    iterations: int = 30_000
    offset_lr_init: float = 0.01
    offset_lr_final: float = 0.0001
    mask_lr_init: float = 0.01
    mask_lr_final: float = 0.0001
    feature_lr: float = 0.0075
    scaling_lr: float = 0.007
    mlp_opacity_lr_init: float = 2e-3
    mlp_opacity_lr_final: float = 2e-5
    mlp_cov_lr_init: float = 4e-3
    mlp_cov_lr_final: float = 4e-3
    mlp_color_lr_init: float = 8e-3
    mlp_color_lr_final: float = 5e-5
    encoding_lr_init: float = 5e-3
    encoding_lr_final: float = 1e-5
    encoding_lr_delay_mult: float = 0.33
    mlp_grid_lr_init: float = 5e-3
    mlp_grid_lr_final: float = 1e-5
    mlp_deform_lr_init: float = 5e-3
    mlp_deform_lr_final: float = 5e-4
    lambda_dssim: float = 0.2
    lmbda: float = 1e-3  # rate weight
    start_stat: int = 500
    update_from: int = 1500
    update_interval: int = 100
    update_until: int = 15_000
    min_opacity: float = 0.005
    success_threshold: float = 0.8
    densify_grad_threshold: float = 0.0002
    # cap for every per-group lr schedule; None = iterations
    lr_max_steps: int | None = None


def param_leaves(params) -> dict[str, torch.Tensor]:
    """The trainable leaves by name: "anchors/<field>" and
    "nets/<module>/<...>/<parameter>"."""
    leaves = {f"anchors/{k}": v for k, v in params["anchors"].items()}
    for name, p in params["nets"].named_parameters():
        leaves["nets/" + name.replace(".", "/")] = p
    return leaves


def make_optimizer(opt: OptConfig, spatial_lr_scale: float) -> optim.GroupAdam:
    """Per-group Adam; a net without a schedule of its own takes mlp_grid's."""
    m = opt.lr_max_steps or opt.iterations
    lrs = {
        "offset": optim.expon_lr(opt.offset_lr_init * spatial_lr_scale,
                                 opt.offset_lr_final * spatial_lr_scale, m,
                                 lr_delay_mult=0.01),
        "mask": optim.expon_lr(opt.mask_lr_init * spatial_lr_scale,
                               opt.mask_lr_final * spatial_lr_scale, m,
                               lr_delay_mult=0.01),
        "anchor_feat": optim.expon_lr(opt.feature_lr, opt.feature_lr, m),
        "scaling": optim.expon_lr(opt.scaling_lr, opt.scaling_lr, m),
        "mlp_opacity": optim.expon_lr(opt.mlp_opacity_lr_init,
                                      opt.mlp_opacity_lr_final, m),
        "mlp_cov": optim.expon_lr(opt.mlp_cov_lr_init, opt.mlp_cov_lr_final, m),
        "mlp_color": optim.expon_lr(opt.mlp_color_lr_init,
                                    opt.mlp_color_lr_final, m),
        "tables": optim.expon_lr(opt.encoding_lr_init, opt.encoding_lr_final,
                                 m, lr_delay_mult=opt.encoding_lr_delay_mult),
        "mlp_grid": optim.expon_lr(opt.mlp_grid_lr_init, opt.mlp_grid_lr_final, m),
        "mlp_deform": optim.expon_lr(opt.mlp_deform_lr_init,
                                     opt.mlp_deform_lr_final, m),
    }

    def group_of(name: str) -> str:
        # a family's own nets (HAC++'s channel_ctx) take mlp_grid's schedule
        keys = name.split("/")
        if keys[0] == "anchors":
            return keys[1]  # offset/mask/anchor_feat/scaling
        return keys[1] if keys[1] in lrs else "mlp_grid"

    return optim.GroupAdam(lrs, group_of)


def phase_of_step(step: int) -> int:
    """The schedule stage of a step (the reference's renderer gates)."""
    if step <= 3000:
        return 0
    if step <= 10000:
        return 1
    return 2


def zero_stats(capacity: int, n_offsets: int, device="cpu") -> dict:
    def z(rows):
        return torch.zeros((rows, 1), dtype=torch.float32, device=device)

    return {
        "opacity_accum": z(capacity),
        "anchor_demon": z(capacity),
        "offset_gradient_accum": z(capacity * n_offsets),
        "offset_denom": z(capacity * n_offsets),
    }


class StepGradients(NamedTuple):
    """What one camera's objective gives a step: the loss, the objective's
    aux output, the gradient of every trainable leaf (by name), the
    screen-space gradient `g_m2d` [cap*K, 2] and this step's increments of
    the four densification statistics."""

    loss: torch.Tensor
    aux: dict
    grads: dict[str, torch.Tensor]
    g_m2d: torch.Tensor
    increments: dict[str, torch.Tensor]


def step_gradients(cfg, rcfg: raster.RasterConfig, opt: OptConfig, params,
                   rest, cam, phase: int = 0, noise=None, generator=None, *,
                   loss_fn=None, grad_mask=None, white_background: bool = False,
                   mask_weights=None) -> StepGradients:
    """The body of a train step up to the update, on one camera: the
    objective's gradients (the family's frozen groups zeroed by
    `grad_mask(grads, phase)`) and the statistics' increments
    (training_statis). `mask_weights` (per-anchor [cap], or None) goes to
    the family's objective only when given: CAT-3DGS's view-frequency
    weights of its mask (`models/cat3dgs/render.py` `weighted_mask`). The
    single step and the data-parallel step (`parallel/dp_scene.py`) both
    run this."""
    if loss_fn is None:
        loss_fn = hac_render.training_loss
    leaves = param_leaves(params)
    dev = params["anchors"]["offset"].device
    cap_k = params["anchors"]["offset"].shape[0] * cfg.n_offsets
    m2d = torch.zeros((cap_k, 2), dtype=torch.float32, device=dev,
                      requires_grad=True)
    bg = torch.full((3,), 1.0 if white_background else 0.0, device=dev)
    with torch.enable_grad():
        for t in leaves.values():
            t.requires_grad_(True)
        weights = {} if mask_weights is None else {"mask_weights": mask_weights}
        loss, aux = loss_fn(
            params, rest, cfg, cam, rcfg, bg, phase, noise, m2d, opt.lmbda,
            opt.lambda_dssim, generator=generator, **weights)
        with profiling.span("hac.backward"):
            got = torch.autograd.grad(loss, [*leaves.values(), m2d],
                                      allow_unused=True)
    g_m2d = got[-1] if got[-1] is not None else torch.zeros_like(m2d)
    grads = {name: g if g is not None else torch.zeros_like(t)
             for (name, t), g in zip(leaves.items(), got[:-1])}
    if grad_mask is not None:
        grads = grad_mask(grads, phase)
    with torch.no_grad(), profiling.span("hac.stats"):
        k = cfg.n_offsets
        vis = aux["visible_anchor"] & rest["valid"]
        opac = torch.clamp_min(aux["neural_opacity"].reshape(-1, k), 0.0)
        update_filter = aux["g_valid"] & (aux["radii"] > 0)
        # screen positions are in pixels; the reference's viewspace
        # gradients are NDC-scaled by half the resolution, which its
        # densify_grad_threshold is tuned for
        g_ndc = torch.stack([g_m2d[:, 0] * (0.5 * rcfg.width),
                             g_m2d[:, 1] * (0.5 * rcfg.height)], -1)
        gnorm = torch.linalg.norm(g_ndc, dim=-1, keepdim=True)
        increments = {
            "opacity_accum": torch.where(vis[:, None],
                                         opac.sum(1, keepdim=True), 0.0),
            "anchor_demon": vis[:, None].to(torch.float32),
            "offset_gradient_accum": torch.where(update_filter[:, None],
                                                 gnorm, 0.0),
            "offset_denom": update_filter[:, None].to(torch.float32),
        }
    return StepGradients(loss.detach(), aux, grads, g_m2d, increments)


def apply_gradients(optimizer: optim.GroupAdam, grads: dict, opt_state: dict,
                    leaves: dict) -> tuple[dict, torch.Tensor]:
    """Drop the non-finite gradient components (in `grads`, in place),
    then one update of the leaves and moments in place. Returns
    (opt_state, the dropped count).

    A non-finite gradient would poison the Adam moments: the component is
    dropped (not nan_to_num, which would keep +-inf as +-max)."""
    nonfinite = sum((~torch.isfinite(g)).sum() for g in grads.values())
    for k, g in grads.items():
        grads[k] = torch.where(torch.isfinite(g), g, 0.0)
    return optimizer.update(grads, opt_state, leaves), nonfinite


@torch.no_grad()
@profiling.span("hac.stats")
def add_stats_(stats: dict, increments: dict) -> dict:
    for name, inc in increments.items():
        stats[name] += inc
    return stats


def make_train_step(cfg, rcfg: raster.RasterConfig, optimizer: optim.GroupAdam,
                    opt: OptConfig, loss_fn=None, grad_mask=None,
                    white_background: bool = False):
    """step(params, rest, opt_state, stats, cam, phase=0, noise=None,
    generator=None, mask_weights=None) -> (params, opt_state, stats,
    metrics).

    `cam` carries its ground-truth image (CameraArrays.from_camera(...,
    with_image=True)); `noise`/`generator` feed the phase's quantization
    noise (see generate_neural_gaussians); `mask_weights` as for
    step_gradients. `loss_fn` is the family's objective, HAC's by default
    (same signature and aux); `grad_mask(grads, phase)` returns the
    gradients (by leaf name) with the family's frozen groups zeroed. The
    leaves, the moments and the statistics are updated in place. metrics
    (tensors: no host sync): loss, l1, psnr, bit_per_param,
    nonfinite_grads, and arm_bit_per_param where the objective gives it
    (CAT-3DGS's planes' share of the rate)."""

    @profiling.span("hac.step")
    def step_fn(params, rest, opt_state, stats, cam, phase: int = 0,
                noise=None, generator=None, mask_weights=None):
        g = step_gradients(cfg, rcfg, opt, params, rest, cam, phase, noise,
                           generator, loss_fn=loss_fn, grad_mask=grad_mask,
                           white_background=white_background,
                           mask_weights=mask_weights)
        opt_state, nonfinite = apply_gradients(optimizer, g.grads, opt_state,
                                               param_leaves(params))
        add_stats_(stats, g.increments)
        metrics = {
            "loss": g.loss, "l1": g.aux["l1"].detach(),
            "psnr": g.aux["psnr"].detach(),
            "bit_per_param": g.aux["bit_per_param"].detach(),
            "nonfinite_grads": nonfinite}
        if "arm_bit_per_param" in g.aux:
            metrics["arm_bit_per_param"] = g.aux["arm_bit_per_param"].detach()
        return params, opt_state, stats, metrics

    return step_fn


# ---------------------------------------------------------------------------
# densification (host side)
# ---------------------------------------------------------------------------

def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def adjust_anchor(state, stats, opt_state, cfg: hac.HACConfig, opt: OptConfig,
                  rng: np.random.Generator):
    """Anchor growth and pruning (the reference's adjust_anchor /
    anchor_growing), on the host over the valid prefix, as the JAX package
    does it. Rewrites the fixed-capacity buffers (growing the bucket if
    needed) and remaps the Adam moments of the per-anchor groups.
    Returns (state, stats, opt_state, info)."""
    k = cfg.n_offsets
    dev = state["anchors"]["anchor"].device
    anchors = {n: _np(v) for n, v in state["anchors"].items()}
    valid = _np(state["valid"])
    cap = valid.shape[0]
    idx_valid = np.nonzero(valid)[0]
    st = {n: _np(v) for n, v in stats.items()}

    grads = st["offset_gradient_accum"] / np.maximum(st["offset_denom"], 1e-12)
    grads = np.nan_to_num(grads, nan=0.0)
    grads_norm = np.abs(grads[:, 0])  # the accumulator is a norm already
    offset_mask = (st["offset_denom"][:, 0]
                   > opt.update_interval * opt.success_threshold * 0.5)
    offset_mask &= np.repeat(valid, k)

    scaling = np.exp(anchors["scaling"][:, :3])
    anchor_q = np.round(anchors["anchor"] / cfg.voxel_size) * cfg.voxel_size
    all_xyz = (anchor_q[:, None, :] + anchors["offset"] * scaling[:, None, :]
               ).reshape(-1, 3)

    new_rows = {name: [] for name in anchors}
    existing = set(map(tuple, np.round(
        anchor_q[idx_valid] / cfg.voxel_size).astype(np.int64).tolist()))

    for i in range(cfg.update_depth):
        cur_threshold = opt.densify_grad_threshold * (
            (cfg.update_hierachy_factor // 2) ** i)
        candidate = (grads_norm >= cur_threshold) & offset_mask
        rand_keep = rng.random(candidate.shape[0]) > (0.5 ** (i + 1))
        candidate &= rand_keep
        if not candidate.any():
            continue
        size_factor = cfg.update_init_factor // (cfg.update_hierachy_factor**i)
        cur_size = cfg.voxel_size * max(size_factor, 1)
        sel_xyz = all_xyz[candidate]
        grid = np.round(sel_xyz / cur_size).astype(np.int64)
        uniq, inv = np.unique(grid, axis=0, return_inverse=True)
        inv = inv.reshape(-1)
        # drop candidates whose coarse cell already hosts an anchor
        coarse_existing = set(map(tuple, np.round(
            anchor_q[idx_valid] / cur_size).astype(np.int64).tolist()))
        keep = np.array([tuple(g) not in coarse_existing for g in uniq.tolist()],
                        bool)
        if not keep.any():
            continue
        cand_anchor = uniq[keep].astype(np.float32) * cur_size
        # fine-grid uniqueness against existing and earlier added anchors
        fine = np.round(cand_anchor / cfg.voxel_size).astype(np.int64)
        keep2 = np.array([tuple(g) not in existing for g in fine.tolist()], bool)
        cand_anchor = cand_anchor[keep2]
        if cand_anchor.shape[0] == 0:
            continue
        existing.update(map(tuple, np.round(
            cand_anchor / cfg.voxel_size).astype(np.int64).tolist()))

        # feature seeding: element-wise max over every candidate landing in
        # the cell (the reference's scatter_max)
        sel_feat = np.repeat(anchors["anchor_feat"], k, axis=0)[candidate]
        feat_max = np.full((uniq.shape[0], sel_feat.shape[1]), -np.inf,
                           sel_feat.dtype)
        np.maximum.at(feat_max, inv, sel_feat)
        feat_src = feat_max[keep][keep2]

        m = cand_anchor.shape[0]
        new_rows["anchor"].append(cand_anchor)
        new_rows["scaling"].append(np.log(np.full((m, 6), cur_size, np.float32)))
        new_rows["rotation"].append(
            np.tile([1.0, 0, 0, 0], (m, 1)).astype(np.float32))
        new_rows["anchor_feat"].append(feat_src)
        new_rows["offset"].append(np.zeros((m, k, 3), np.float32))
        new_rows["mask"].append(np.ones((m, k, 1), np.float32))
        new_rows["opacity"].append(
            np.full((m, 1), hac._inverse_sigmoid(0.1), np.float32))

    n_new = sum(a.shape[0] for a in new_rows["anchor"])

    # pruning
    op_accum = st["opacity_accum"][:, 0]
    demon = st["anchor_demon"][:, 0]
    prune = (op_accum < opt.min_opacity * demon) & (
        demon > opt.update_interval * opt.success_threshold) & valid
    keep_idx = np.nonzero(valid & ~prune)[0]
    merged = {name: np.concatenate([anchors[name][keep_idx]] + new_rows[name],
                                   axis=0) for name in anchors}
    n_total = merged["anchor"].shape[0]
    new_cap = cap if n_total <= cap else hac.bucket_capacity(n_total,
                                                             minimum=cap * 2)

    def pad_to(x, c):
        out = np.zeros((c,) + x.shape[1:], x.dtype)
        out[: x.shape[0]] = x
        return out

    def to_dev(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    new_valid = np.zeros(new_cap, bool)
    new_valid[:n_total] = True
    new_state = dict(state)
    new_state["anchors"] = {n_: to_dev(pad_to(v, new_cap)) for n_, v in merged.items()}
    new_state["valid"] = to_dev(new_valid)

    # the Adam moments of the per-anchor groups: kept anchors keep theirs,
    # new anchors start at zero
    def remap(moments):
        out = dict(moments)
        for name in hac.TRAINABLE_ANCHOR_FIELDS:
            old = _np(moments[f"anchors/{name}"])
            out[f"anchors/{name}"] = to_dev(pad_to(old[keep_idx], new_cap))
        return out

    opt_state = dict(opt_state, mu=remap(opt_state["mu"]), nu=remap(opt_state["nu"]))

    # selective resets: only growth-counted offset entries and prune-counted
    # anchors restart their accumulators; the others keep accumulating
    off_acc = st["offset_gradient_accum"].copy()
    off_den = st["offset_denom"].copy()
    off_acc[offset_mask] = 0.0
    off_den[offset_mask] = 0.0
    counted = demon > opt.update_interval * opt.success_threshold
    op_acc2 = op_accum.copy()
    dem2 = demon.copy()
    op_acc2[counted] = 0.0
    dem2[counted] = 0.0

    def remap_stat(per_anchor: np.ndarray, width: int) -> torch.Tensor:
        rows = per_anchor.reshape(cap, width)[keep_idx]
        out = np.zeros((new_cap, width), rows.dtype)
        out[: rows.shape[0]] = rows
        return to_dev(out.reshape(new_cap * width, 1) if width == k else out)

    new_stats = {
        "opacity_accum": remap_stat(op_acc2[:, None], 1),
        "anchor_demon": remap_stat(dem2[:, None], 1),
        "offset_gradient_accum": remap_stat(off_acc, k),
        "offset_denom": remap_stat(off_den, k),
    }
    return new_state, new_stats, opt_state, {
        "n_anchors": n_total, "n_added": int(n_new),
        "n_pruned": int(prune.sum()), "recompiled": new_cap != cap,
    }


@torch.no_grad()
def sort_anchors(state, stats, opt_state, cfg: hac.HACConfig):
    """Put the valid anchors first, in the order the scene codec codes them
    (the morton order of their voxels, `models/hac/codec.py`), moving their
    Adam moments and densification statistics with them. A render blends
    Gaussians whose tile-sort keys are equal (the key keeps about 2^-10 of
    the depth) in the order of their rows, so a scene that trains in this
    order renders after decoding as it rendered in training. Returns
    (state, stats, opt_state)."""
    valid = state["valid"]
    dev = valid.device
    idx = torch.nonzero(valid)[:, 0]
    anchor_int = torch.round(hac.get_anchor(state, cfg)[idx] / cfg.voxel_size)
    order = sparse.morton_order_np(anchor_int.to(torch.int64).cpu().numpy())
    rows = torch.cat([idx[torch.as_tensor(order, device=dev)],
                      torch.nonzero(~valid)[:, 0]])
    k = cfg.n_offsets
    offset_rows = (rows[:, None] * k + torch.arange(k, device=dev)).reshape(-1)
    state = dict(state, anchors={n: v[rows] for n, v in state["anchors"].items()},
                 valid=valid[rows])
    stats = {n: v[offset_rows if n.startswith("offset") else rows]
             for n, v in stats.items()}

    def permute(moments):
        return {n: v[rows] if n.startswith("anchors/") else v
                for n, v in moments.items()}

    opt_state = dict(opt_state, mu=permute(opt_state["mu"]),
                     nu=permute(opt_state["nu"]))
    return state, stats, opt_state
