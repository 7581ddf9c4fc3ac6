"""HAC++'s training objective: HAC's render with mixture-coded features
(counterpart of gauspcc_tpu/models/hac_plus/render.py).

Phases 0 and 1 and every eval render are HAC's, through `cfg.as_hac()`.
Phase 2 adds noise at the context's steps, estimates the rate with the
features under their 2-component mixture, and rebuilds the Gaussians from
the noisy attributes through HAC's eval path (whose quantiser leaves
HAC++'s wider mlp_grid alone). The noise is the caller's draws
(u_feat, u_scaling, u_offsets), or comes from `generator`.
"""

from __future__ import annotations

import torch

from gauspcc_tpu_torch.core import entropy
from gauspcc_tpu_torch.core.quant import uniform_noise_quant
from gauspcc_tpu_torch.models.hac import model as hac
from gauspcc_tpu_torch.models.hac import render as hac_render
from gauspcc_tpu_torch.models.hac_plus import model as hacp
from gauspcc_tpu_torch.render import raster


def rate_terms(state, cfg: hacp.HACPlusConfig, anchor, feat, grid_scaling,
               grid_offsets, binary_mask, sel, noise=None,
               generator: torch.Generator | None = None):
    """Bits per parameter of the noise-quantised attributes over the rows
    `sel` [cap, 1] selects, and the noisy (feat, scaling, offsets). The
    clamp windows' means run over every capacity row, as in the JAX
    package's HAC++ (HAC's run over live rows)."""
    k = cfg.n_offsets
    u_feat, u_scaling, u_offsets = noise if noise is not None else (None,) * 3
    ctx = hacp.grid_mlp_split(
        state, cfg, hac.calc_interp_feat(state, cfg.as_hac(), anchor))
    feat = uniform_noise_quant(feat, ctx["q_feat"], u_feat, generator=generator)
    grid_scaling = uniform_noise_quant(grid_scaling, ctx["q_scaling"],
                                       u_scaling, generator=generator)
    grid_offsets = uniform_noise_quant(grid_offsets, ctx["q_offsets"][:, None, :],
                                       u_offsets, generator=generator)
    means, scales, probs = hacp.mixture_components(
        ctx, state["nets"].channel_ctx, cfg, feat)
    bit_feat = entropy.gaussian_mixture_bits(
        feat, means, scales, probs, ctx["q_feat"],
        x_mean=state["anchors"]["anchor_feat"].mean()) * sel
    bit_scaling = entropy.gaussian_bits(
        grid_scaling, ctx["mean_scaling"], ctx["scale_scaling"],
        ctx["q_scaling"], x_mean=hac.get_scaling(state).mean()) * sel
    mask3 = torch.repeat_interleave(binary_mask, 3, dim=-1).reshape(-1, 3 * k)
    bit_offsets = entropy.gaussian_bits(
        grid_offsets.reshape(-1, 3 * k), ctx["mean_offsets"],
        ctx["scale_offsets"], ctx["q_offsets"],
        x_mean=state["anchors"]["offset"].mean()) * mask3 * sel
    denom = torch.clamp_min(sel.sum(), 1.0)
    rate = {
        "bit_per_feat_param": bit_feat.sum() / (denom * cfg.feat_dim),
        "bit_per_scaling_param": bit_scaling.sum() / (denom * 6),
        "bit_per_offsets_param": bit_offsets.sum() / (denom * 3 * k),
    }
    rate["bit_per_param"] = (
        bit_feat.sum() + bit_scaling.sum() + bit_offsets.sum()
    ) / (denom * (cfg.feat_dim + 6 + 3 * k))
    return rate, (feat, grid_scaling, grid_offsets)


def generate_neural_gaussians(state, cfg: hacp.HACPlusConfig, camera_center,
                              visible_mask, *, training: bool = False,
                              phase: int = 0, noise=None,
                              generator: torch.Generator | None = None,
                              decoded: bool = False):
    """HAC++'s hac.generate_neural_gaussians: (NeuralGaussians, rate terms
    or None); phase 2 of training goes through the mixture's rate terms."""
    base = cfg.as_hac()
    if not (training and not decoded and phase == 2):
        return hac.generate_neural_gaussians(
            state, base, camera_center, visible_mask, training=training,
            phase=phase, noise=noise, generator=generator, decoded=decoded)
    anchors = state["anchors"]
    sel = (visible_mask & state["valid"]
           & hac.get_mask_anchor(state))[:, None].to(torch.float32)
    rate, (feat, grid_scaling, grid_offsets) = rate_terms(
        state, cfg, hac.get_anchor(state, base), anchors["anchor_feat"],
        hac.get_scaling(state), anchors["offset"], hac.get_mask(state), sel,
        noise, generator)
    # the Gaussians of the noisy attributes, through HAC's shared tail; the
    # scaling is stored as its log
    noisy = dict(state, anchors=dict(
        anchors, anchor_feat=feat, offset=grid_offsets,
        scaling=torch.log(torch.clamp_min(grid_scaling, 1e-9))))
    ng, _ = hac.generate_neural_gaussians(noisy, base, camera_center,
                                          visible_mask)
    return ng, rate


def training_loss(params, rest, cfg: hacp.HACPlusConfig,
                  cam: hac_render.CameraArrays, rcfg: raster.RasterConfig,
                  bg_color, phase: int, noise, means2d_extra, lmbda: float,
                  lambda_dssim: float = 0.2, *,
                  generator: torch.Generator | None = None):
    """HAC's objective (`hac_render.objective`) over HAC++'s render.
    Returns (loss, aux)."""
    state = hac.merge_state(params, rest)
    visible = hac_render.prefilter_voxel(state, cfg.as_hac(), cam, rcfg)
    ng, rate = generate_neural_gaussians(
        state, cfg, cam.camera_center, visible, training=True, phase=phase,
        noise=noise, generator=generator)
    out = hac_render.draw(ng, rate, visible, cam, rcfg, bg_color,
                          means2d_extra)
    return hac_render.objective(state, cfg, cam.image, out, lmbda, lambda_dssim)
