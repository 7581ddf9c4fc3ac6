"""TC-GS's scene bitstream (counterpart of
gauspcc_tpu/models/tcgs/codec.py: `_batch_context` :35, `_batch_knn` :43,
`conduct_encoding` :53, `conduct_decoding` :143).

HAC's stream (`models/hac/codec.py`) with the triplane in place of the
hash tables: the planes ship as their autoencoder's latent in float16
(triplane_latent.npz, 16 bits a value), and both sides sample the
context from that latent's reconstruction, `decode_latent(f16 latent)`.
In knn mode both sides take the K sampling positions from the coded,
morton-ordered anchors. Anchors, features, scalings, offsets and masks
are coded as HAC codes them; there is no hash.b.

As in HAC's codec, the decoder recomputes every model bit for bit: both
sides reconstruct the planes from the same float16 values, pad each
batch's context to BATCH rows and compute inside the codec's
full-precision GEMM context. The decoded state's planes are the
reconstruction (the stream holds no others).

Files in `out_dir`: xyz_pcc.bin, triplane_latent.npz, feat_<s>.b,
scaling_<s>.b, offsets_<s>.b per batch s, masks.b and meta.json, as the
JAX package writes them.
"""

from __future__ import annotations

import copy
import json
import os
import time

import numpy as np
import torch

from gauspcc_tpu_torch.codecs.gauspcgc import codec as pcc
from gauspcc_tpu_torch.codecs.gauspcgc import model as pcc_model
from gauspcc_tpu_torch.fields import triplane as tri
from gauspcc_tpu_torch.models.hac import codec as hac_codec
from gauspcc_tpu_torch.models.hac import model as hac
from gauspcc_tpu_torch.models.tcgs import model as tcgs
from gauspcc_tpu_torch.ops import coder
from gauspcc_tpu_torch.ops import entropy_coding as ec

BATCH = hac_codec.BATCH
BIT2MB = hac_codec.BIT2MB
LATENT_FILE = "triplane_latent.npz"


@torch.no_grad()
def _batch_context(state, cfg: tcgs.TCGSConfig, anchor_batch: torch.Tensor,
                   planes: torch.Tensor, knn_pos: torch.Tensor | None = None):
    """The triplane context and mlp_triplane's heads for one batch [B, 3],
    sampled from `planes` (at `knn_pos` [B, K, 3] in knn mode)."""
    return tcgs.grid_mlp_split(state, cfg, tcgs.triplane_context(
        state, cfg, anchor_batch, planes, knn_pos=knn_pos))


def _batch_knn(knn_all: torch.Tensor | None, lo: int, hi: int):
    """The knn positions of anchors lo..hi padded to BATCH rows with
    zeros, or None in repeat mode."""
    if knn_all is None:
        return None
    return hac_codec._pad(knn_all[lo:hi], (BATCH,) + tuple(knn_all.shape[1:]))


def _context_source(state, cfg: tcgs.TCGSConfig, latent16: np.ndarray,
                    pos: torch.Tensor, clock):
    """(the planes reconstructed from the float16 latent, the knn positions
    [n, K, 3] or None), as encoder and decoder derive them alike."""
    latent = torch.from_numpy(latent16.astype(np.float32)).to(pos.device)
    with clock:
        planes = tri.decode_latent(state["nets"].autoencoder, latent)
    knn_all = None
    if cfg.knn_sampling:
        knn_all = torch.from_numpy(tcgs.knn_positions(
            pos.cpu().numpy(), cfg.tri_samples)).to(pos.device)
    return planes, knn_all


def _padded_context(state, cfg, pos, lo, hi, clock, planes, knn_all) -> dict:
    return hac_codec._padded_context(
        state, cfg, pos, lo, hi, clock,
        lambda st, c, batch: _batch_context(st, c, batch, planes,
                                            _batch_knn(knn_all, lo, hi)))


def conduct_encoding(state, cfg: tcgs.TCGSConfig, out_dir: str, pcc_params,
                     pcc_cfg=pcc_model.NetConfig(), values: dict | None = None,
                     profile: dict | None = None) -> tuple[dict, str]:
    """Encode the scene to `out_dir` on the state's device. Returns (sizes
    in bits per component and in total, a log line). `values`, when a
    dict, gets what the decoder will give: feat [n, F], scaling [n, 6] and
    offset [n, K, 3] in the coded order, the float16 latent ("latent") and
    the planes reconstructed from it ("planes"); `profile`, when a dict,
    gets the seconds of the anchors' codec, the context's device ms (the
    latent's reconstruction included) and the host coder's seconds."""
    os.makedirs(out_dir, exist_ok=True)
    base = cfg.as_hac()
    dev = hac_codec._device(state)
    hac_codec._sync(dev)
    t_start = time.perf_counter()
    coder_s0 = coder.seconds
    k, fd = cfg.n_offsets, cfg.feat_dim
    clock = hac_codec._DeviceClock(dev)
    with torch.no_grad(), pcc._exact_gemms():
        data = hac_codec._gather_sorted_attributes(state, base)
        n = data["anchor_int"].shape[0]
        t0 = time.perf_counter()
        out = pcc.compress_point_cloud(
            data["anchor_int"], pcc_params, os.path.join(out_dir, "xyz_pcc.bin"),
            config=pcc_cfg, device=dev)
        hac_codec._sync(dev)
        anchors_s = time.perf_counter() - t0

        latent, _ = tcgs.reconstructed_planes(state)
        latent16 = latent.cpu().numpy().astype(np.float16)
        np.savez(os.path.join(out_dir, LATENT_FILE), latent=latent16)
        pos = hac_codec._positions(data["anchor_int"], base, dev)
        planes, knn_all = _context_source(state, cfg, latent16, pos, clock)
        means = {f: float(data[f].mean()) if n else 0.0
                 for f in ("feat", "scaling", "offset")}

        bits = {"feat": 0, "scaling": 0, "offsets": 0}
        got = {"feat": [], "scaling": [], "offset": []}
        for s in range((n + BATCH - 1) // BATCH):
            lo, hi = s * BATCH, min((s + 1) * BATCH, n)
            ctx = _padded_context(state, cfg, pos, lo, hi, clock, planes,
                                  knn_all)
            hac_codec._encode_batch(data, ctx, lo, hi, means, out_dir, s, cfg,
                                    bits, got if values is not None else None)
        bit_masks = ec.encode_binary(data["mask"].reshape(-1),
                                     os.path.join(out_dir, "masks.b"))
    if values is not None:
        empty = {"feat": (0, fd), "scaling": (0, 6), "offset": (0, k, 3)}
        for name, chunks in got.items():
            values[name] = (torch.cat(chunks) if chunks else
                            torch.zeros(empty[name], device=dev))
        values["latent"] = torch.from_numpy(latent16)
        values["planes"] = planes

    meta = {"n_anchors": int(n), "batch": BATCH,
            **{f"{f}_mean": v for f, v in means.items()}}
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f)

    enc_time = time.perf_counter() - t_start
    sizes = {"anchor": out["file_size_bits"], **bits,
             "triplane": latent16.size * 16, "masks": bit_masks,
             "mlps": hac.mlp_size_bits(state)}
    sizes["total"] = sum(sizes.values())
    if profile is not None:
        profile.update(total_s=enc_time, anchors_s=anchors_s,
                       context_ms=clock.ms, coder_s=coder.seconds - coder_s0)
    log = "Encoded sizes in MB: " + ", ".join(
        f"{k_} {v / BIT2MB:.4f}" for k_, v in sizes.items()
    ) + f", EncTime {enc_time:.4f}"
    return sizes, log


def conduct_decoding(state, cfg: tcgs.TCGSConfig, out_dir: str, pcc_params,
                     pcc_cfg=pcc_model.NetConfig(),
                     profile: dict | None = None):
    """Decode the scene in `out_dir` into a decoded state on the device of
    `state`, which gives the networks (copied, with the planes
    reconstructed from the latent) and the context's bounds. Returns
    (decoded state, a log line); `profile` as in conduct_encoding."""
    base = cfg.as_hac()
    dev = hac_codec._device(state)
    hac_codec._sync(dev)
    t_start = time.perf_counter()
    coder_s0 = coder.seconds
    with open(os.path.join(out_dir, "meta.json")) as f:
        meta = json.load(f)
    n, k = meta["n_anchors"], cfg.n_offsets
    clock = hac_codec._DeviceClock(dev)
    with torch.no_grad(), pcc._exact_gemms():
        latent16 = np.load(os.path.join(out_dir, LATENT_FILE))["latent"]
        masks01 = ec.decode_binary(n * k, os.path.join(out_dir, "masks.b"),
                                   dev).reshape(n, k, 1)
        dec_state, pos, anchors_s = hac_codec._decoded_anchors(
            state, base, out_dir, pcc_params, pcc_cfg, masks01,
            copy.deepcopy(state["nets"]))
        planes, knn_all = _context_source(dec_state, cfg, latent16, pos, clock)
        dec_state["nets"].planes.copy_(planes)

        batches = []
        for s in range((n + BATCH - 1) // BATCH):
            lo, hi = s * BATCH, min((s + 1) * BATCH, n)
            ctx = _padded_context(dec_state, cfg, pos, lo, hi, clock, planes,
                                  knn_all)
            batches.append(hac_codec._decode_batch(ctx, masks01[lo:hi],
                                                   out_dir, s, cfg))
        hac_codec._fill_attributes(dec_state, batches, cfg)
    hac_codec._sync(dev)
    dec_time = time.perf_counter() - t_start
    if profile is not None:
        profile.update(total_s=dec_time, anchors_s=anchors_s,
                       context_ms=clock.ms, coder_s=coder.seconds - coder_s0)
    return dec_state, f"DecTime {dec_time:.4f}"
