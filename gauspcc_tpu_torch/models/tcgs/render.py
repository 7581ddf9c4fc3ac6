"""TC-GS's training objective (counterpart of
gauspcc_tpu/models/tcgs/render.py).

Phases 0 and 1 and every eval render are HAC's, through `cfg.as_hac()`
(phase 1's base steps, with TC-GS's base of 0.3 for the offsets). From
phase 2 the triplane context sets the noise's steps and the rate, and the
Gaussians are rebuilt from the noisy attributes through HAC's eval path
(whose quantiser leaves a TC-GS state alone). Phase 3 adds `lae`, the L1
between the planes and their autoencoder's reconstruction. The noise is
the caller's draws (u_feat, u_scaling, u_offsets), or comes from
`generator`.

The loss is HAC's image terms, then lmbda times the bits per parameter
(the attributes' bits over max(sum of the selected rows, 1) rows, no hash
term, no division by the live rows), 5e-4 mean(sigmoid(mask)) and
lambda_ae lae. The clamp windows' means run over every capacity row, as
in the JAX package's TC-GS (HAC's run over live rows).
"""

from __future__ import annotations

import torch

from gauspcc_tpu_torch.core import entropy
from gauspcc_tpu_torch.core.quant import uniform_noise_quant
from gauspcc_tpu_torch.models.hac import model as hac
from gauspcc_tpu_torch.models.hac import render as hac_render
from gauspcc_tpu_torch.models.tcgs import model as tcgs
from gauspcc_tpu_torch.render import raster
from gauspcc_tpu_torch.utils import image as img_lib


def phase_of_step(step: int) -> int:
    """0: warm-up to step 3,000; 1: base-step noise to 10,000; 2: the
    triplane context and the rate to 15,000; 3: and the autoencoder's
    loss."""
    if step <= 3000:
        return 0
    if step <= 10000:
        return 1
    if step <= 15000:
        return 2
    return 3


def generate_neural_gaussians(state, cfg: tcgs.TCGSConfig, camera_center,
                              visible_mask, *, training: bool = False,
                              phase: int = 0, noise=None,
                              generator: torch.Generator | None = None,
                              decoded: bool = False):
    """TC-GS's hac.generate_neural_gaussians: (NeuralGaussians, rate terms
    or None, lae or None)."""
    base = cfg.as_hac()
    if not (training and not decoded and phase >= 2):
        return (*hac.generate_neural_gaussians(
            state, base, camera_center, visible_mask, training=training,
            phase=min(phase, 1), noise=noise, generator=generator,
            decoded=decoded), None)
    anchors = state["anchors"]
    k = cfg.n_offsets
    sel = (visible_mask & state["valid"]
           & hac.get_mask_anchor(state))[:, None].to(torch.float32)
    ctx_feats = tcgs.triplane_context(state, cfg, hac.get_anchor(state, base))
    lae = None
    if phase >= 3:
        _, recon = tcgs.reconstructed_planes(state)
        lae = img_lib.l1_loss(state["nets"].planes, recon)
    ctx = tcgs.grid_mlp_split(state, cfg, ctx_feats)

    u_feat, u_scaling, u_offsets = noise if noise is not None else (None,) * 3
    scaling0 = hac.get_scaling(state)
    feat = uniform_noise_quant(anchors["anchor_feat"], ctx["q_feat"], u_feat,
                               generator=generator)
    grid_scaling = uniform_noise_quant(scaling0, ctx["q_scaling"], u_scaling,
                                       generator=generator)
    grid_offsets = uniform_noise_quant(anchors["offset"],
                                       ctx["q_offsets"][:, None, :], u_offsets,
                                       generator=generator)
    mask3 = torch.repeat_interleave(hac.get_mask(state), 3, dim=-1).reshape(
        -1, 3 * k)
    bit_feat = entropy.gaussian_bits(
        feat, ctx["mean"], ctx["scale"], ctx["q_feat"],
        x_mean=anchors["anchor_feat"].mean()) * sel
    bit_scaling = entropy.gaussian_bits(
        grid_scaling, ctx["mean_scaling"], ctx["scale_scaling"],
        ctx["q_scaling"], x_mean=scaling0.mean()) * sel
    bit_offsets = entropy.gaussian_bits(
        grid_offsets.reshape(-1, 3 * k), ctx["mean_offsets"],
        ctx["scale_offsets"], ctx["q_offsets"],
        x_mean=anchors["offset"].mean()) * mask3 * sel
    denom = torch.clamp_min(sel.sum(), 1.0)
    rate = {"bit_per_param": (
        bit_feat.sum() + bit_scaling.sum() + bit_offsets.sum()
    ) / (denom * (cfg.feat_dim + 6 + 3 * k))}

    # the Gaussians of the noisy attributes, through HAC's shared tail; the
    # scaling is stored as its log
    noisy = dict(state, anchors=dict(
        anchors, anchor_feat=feat, offset=grid_offsets,
        scaling=torch.log(torch.clamp_min(grid_scaling, 1e-9))))
    ng, _ = hac.generate_neural_gaussians(noisy, base, camera_center,
                                          visible_mask)
    return ng, rate, lae


def training_loss(params, rest, cfg: tcgs.TCGSConfig,
                  cam: hac_render.CameraArrays, rcfg: raster.RasterConfig,
                  bg_color, phase: int, noise, means2d_extra, lmbda: float,
                  lambda_dssim: float = 0.2, lambda_ae: float = 1.0, *,
                  generator: torch.Generator | None = None):
    """TC-GS's objective for one view (the module's docstring). Returns
    (loss, aux), aux as HAC's with "lae" (0 before phase 3)."""
    state = hac.merge_state(params, rest)
    visible = hac_render.prefilter_voxel(state, cfg.as_hac(), cam, rcfg)
    ng, rate, lae = generate_neural_gaussians(
        state, cfg, cam.camera_center, visible, training=True, phase=phase,
        noise=noise, generator=generator)
    out = hac_render.draw(ng, rate, visible, cam, rcfg, bg_color,
                          means2d_extra)
    loss, aux = hac_render.image_objective(cam.image, out, lambda_dssim)
    if rate is not None:
        loss = loss + lmbda * rate["bit_per_param"]
        loss = loss + 5e-4 * torch.sigmoid(state["anchors"]["mask"]).mean()
        aux["bit_per_param"] = rate["bit_per_param"]
    if lae is not None:
        loss = loss + lambda_ae * lae
    aux["lae"] = lae if lae is not None else torch.zeros_like(loss)
    return loss, aux
