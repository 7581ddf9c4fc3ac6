"""CAT-3DGS's training objective (counterpart of
gauspcc_tpu/models/cat3dgs/render.py: `phase_of_step` :28, `grad_mask`
:59, `weighted_mask` :84, `training_loss` :94, `update_view_frequency`
:197, `view_frequency_weights` :202).

Phases 0 and 1 render through HAC's scaffold (`cfg.as_hac()`, phase 1's
base-step noise). From phase 2 the planes are quantised with uniform noise,
the triplane hyperprior and the channel-wise context set the attributes'
noise steps and Gaussians, the ARMs give the planes' bits, and the
Gaussians are rebuilt from the noisy attributes through HAC's eval path.
The rate is (the attributes' bits over the selected anchors + the planes'
bits) over max(selected anchors, 1) times the parameters an anchor. The
loss is HAC's image terms, from phase 1 max(1e-3, 0.3 lmbda)
mean(sigmoid(mask)), from phase 2 lmbda times the rate; phase 3's loss is
the planes' bits over that denominator alone. `grad_mask` freezes the
groups each phase leaves alone.

Spans (`utils/profiling.py`, recorded only under a profiler):
`cat.chcm`, the channel-wise context's forward; the field's and the ARMs'
own in `model.py` and `field.py`.

The noise is the caller's draws `noise` = (u_feat, u_scaling, u_offsets)
in [0, 1) as HAC's, with from phase 2 a fourth entry, the planes' noise in
[-0.5, 0.5) (one tensor a scale); or comes from `generator`.
"""

from __future__ import annotations

import torch

from gauspcc_tpu_torch.core import entropy
from gauspcc_tpu_torch.core.quant import uniform_noise_quant
from gauspcc_tpu_torch.models.cat3dgs import field as cat_field
from gauspcc_tpu_torch.models.cat3dgs import model as cat
from gauspcc_tpu_torch.models.hac import model as hac
from gauspcc_tpu_torch.models.hac import render as hac_render
from gauspcc_tpu_torch.render import raster
from gauspcc_tpu_torch.utils import profiling

FIT_ITER = 10_000


def phase_of_step(step: int, fit_iter: int = FIT_ITER) -> int:
    """0: warm-up to step 3,000; 1: the mask's regulariser to fit_iter
    (the PCA fit on the 1 -> 2 edge); 2: the rate, ARMs frozen, for 5,000
    steps; 3: the planes' rate alone, only the ARMs train, for 1,000; 4:
    the rate, planes frozen, for 3,000; 5: the rate, everything trains."""
    for phase, last in ((0, 3000), (1, fit_iter), (2, fit_iter + 5000),
                        (3, fit_iter + 6000), (4, fit_iter + 9000)):
        if step <= last:
            return phase
    return 5


_ARMS = "nets/field/arms/"
_PLANES = "nets/field/scales/"


def _frozen(name: str, phase: int) -> bool:
    arm = name.startswith(_ARMS)
    return {2: arm, 3: not arm, 4: name.startswith(_PLANES)}.get(phase, False)


def grad_mask(grads: dict, phase: int) -> dict:
    """The gradients by leaf name with each phase's frozen groups zeroed:
    phase 2 the ARMs', phase 3 all but the ARMs', phase 4 the planes'.
    A frozen leaf still moves by the Adam moments earlier steps left, as
    in the JAX package."""
    if phase not in (2, 3, 4):
        return grads
    return {n: torch.zeros_like(g) if _frozen(n, phase) else g
            for n, g in grads.items()}


def weighted_mask(state, weights: torch.Tensor | None = None) -> torch.Tensor:
    """The offsets' hard {0, 1} mask with a sigmoid STE, the logits scaled
    by per-anchor view-frequency weights when given."""
    logits = state["anchors"]["mask"]
    if weights is not None:
        logits = logits * weights[:, None, None]
    s = torch.sigmoid(logits)
    return ((s > 0.01).to(torch.float32) - s).detach() + s


def rate_gaussians(state, cfg: cat.CATConfig, camera_center, visible, noise,
                    generator, mask_weights):
    """Phase 2 and later: (the Gaussians of the noisy attributes, the rate
    in bits per parameter, the planes' share of it). `visible`: the
    prefilter's mask; `noise`, `generator` and `mask_weights` as for
    training_loss."""
    base = cfg.as_hac()
    anchors = state["anchors"]
    nets = state["nets"]
    k = cfg.n_offsets
    binary_mask = weighted_mask(state, mask_weights)
    mask_anchor = (binary_mask.sum(1)[:, 0] > 0) & state["valid"]
    sel = (visible & state["valid"] & mask_anchor)[:, None].to(torch.float32)

    u_feat, u_scaling, u_offsets, u_planes = (
        noise if noise is not None else (None,) * 4)
    if u_planes is None:
        u_planes = cat_field.plane_noise(nets.field, generator)
    planes_q = cat_field.quantized_planes(nets.field, u_planes)
    hyper = cat.hyper_split(state, cfg, hac.get_anchor(state, base), planes_q)
    scaling0 = hac.get_scaling(state)
    feat = uniform_noise_quant(anchors["anchor_feat"], hyper["q_feat"], u_feat,
                               generator=generator)
    grid_scaling = uniform_noise_quant(scaling0, hyper["q_scaling"], u_scaling,
                                       generator=generator)
    grid_offsets = uniform_noise_quant(anchors["offset"],
                                       hyper["q_offsets"][:, None, :], u_offsets,
                                       generator=generator)
    with profiling.span("cat.chcm"):
        hyper = cat.chcm_adjust(state, cfg, hyper, feat)
        f_mean, f_scale = cat.feature_stats(state, cfg, hyper, feat)
    bit_feat = entropy.gaussian_bits(
        feat, f_mean, f_scale, hyper["q_feat"],
        x_mean=anchors["anchor_feat"].mean()) * sel
    bit_scaling = entropy.gaussian_bits(
        grid_scaling, hyper["mean_scaling"], hyper["scale_scaling"],
        hyper["q_scaling"], x_mean=scaling0.mean()) * sel
    mask3 = torch.repeat_interleave(binary_mask, 3, dim=-1).reshape(-1, 3 * k)
    bit_offsets = entropy.gaussian_bits(
        grid_offsets.reshape(-1, 3 * k), hyper["mean_offsets"],
        hyper["scale_offsets"], hyper["q_offsets"],
        x_mean=anchors["offset"].mean()) * mask3 * sel
    arm_bits = cat_field.field_rate_bits(nets.field, planes_q)
    denom = torch.clamp_min(sel.sum(), 1.0) * (cfg.feat_dim + 6 + 3 * k)
    rate = (bit_feat.sum() + bit_scaling.sum() + bit_offsets.sum()
            + arm_bits) / denom

    # the Gaussians of the noisy attributes, through HAC's shared tail; the
    # scaling is stored as its log
    noisy = dict(state, anchors=dict(
        anchors, anchor_feat=feat, offset=grid_offsets,
        scaling=torch.log(torch.clamp_min(grid_scaling, 1e-9))))
    ng, _ = hac.generate_neural_gaussians(noisy, base, camera_center, visible)
    return ng, rate, arm_bits / denom


def training_loss(params, rest, cfg: cat.CATConfig,
                  cam: hac_render.CameraArrays, rcfg: raster.RasterConfig,
                  bg_color, phase: int, noise, means2d_extra, lmbda: float,
                  lambda_dssim: float = 0.2, mask_weights=None, *,
                  generator: torch.Generator | None = None):
    """CAT-3DGS's objective for one view (the module's docstring). Returns
    (loss, aux), aux as HAC's, from phase 2 with `arm_bit_per_param`, the
    planes' bits over the rate's denominator."""
    state = hac.merge_state(params, rest)
    base = cfg.as_hac()
    visible = hac_render.prefilter_voxel(state, base, cam, rcfg)
    rate = arm_rate = None
    if phase < 2:
        ng, _ = hac.generate_neural_gaussians(
            state, base, cam.camera_center, visible, training=True,
            phase=min(phase, 1), noise=None if noise is None else noise[:3],
            generator=generator)
    else:
        ng, rate, arm_rate = rate_gaussians(state, cfg, cam.camera_center,
                                             visible, noise, generator,
                                             mask_weights)
    out = hac_render.draw(ng, rate, visible, cam, rcfg, bg_color,
                          means2d_extra)
    loss, aux = hac_render.image_objective(cam.image, out, lambda_dssim)
    if phase >= 1:
        loss = loss + max(1e-3, 0.3 * lmbda) * torch.sigmoid(
            state["anchors"]["mask"]).mean()
    if rate is not None:
        loss = loss + lmbda * rate
        aux["bit_per_param"] = rate
        aux["arm_bit_per_param"] = arm_rate
    if phase == 3:
        loss = arm_rate
    return loss, aux


def update_view_frequency(counts: torch.Tensor,
                          visible: torch.Tensor) -> torch.Tensor:
    """Per-anchor visibility counts plus this view's."""
    return counts + visible.to(torch.float32)


def view_frequency_weights(counts: torch.Tensor,
                           valid: torch.Tensor) -> torch.Tensor:
    """counts over their mean over the valid anchors (1 on invalid rows):
    weighted_mask's weights."""
    valid_f = valid.to(torch.float32)
    mean_p = torch.where(valid, counts, 0.0).sum() / torch.clamp_min(
        valid_f.sum(), 1.0)
    return torch.where(valid, counts / torch.clamp_min(mean_p, 1e-9), 1.0)
