"""CAT-3DGS's scene bitstream (counterpart of
gauspcc_tpu/models/cat3dgs/codec.py: `BATCH` :33, `encode_triplanes` :53,
`decode_triplanes` :76, `conduct_encoding` :96, `conduct_decoding` :190).

The planes first: each scale's latents rounded at their gain, coded plane
by plane in wavefront order under the fixed-point ARM of their group
(`arm.py`), whose integer weights ship in arm_q.bin, so the decoder
rebuilds the latents on any machine. Then per batch of 500 anchors, as in
HAC's stream (`models/hac/codec.py`): the feature slices in order, slice 0
under the triplane hyperprior at the coded anchors (read from the decoded
latents), each later slice under `mlp_chcm` over the slices decoded before
it; then the scaling and the (mask-on) offsets under the hyperprior,
adjusted by the optional chcm heads. Anchors go through GausPcgc, masks
through the binary coder.

The field's PCA frame and gains are not in the stream, nor the float
ARMs: the decoder takes them from the state it is given, as the JAX
package's does (its mlps size counts the `mlp*` nets only).

As in HAC's codec, the decoder recomputes every model bit for bit: both
sides read the context from the same integer latents, feed the channel
context the values the decoder decodes, pad each batch's GEMMs to BATCH
rows and compute inside the codec's full-precision GEMM context.

Files in `out_dir`: xyz_pcc.bin, arm_q.bin, tri_<scale>_<group>_<c>.b,
feat_<s>_<slice>.b, scaling_<s>.b and offsets_<s>.b per batch s, masks.b
and meta.json, as the JAX package writes them.
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
from gauspcc_tpu_torch.core.quant import ste_multistep
from gauspcc_tpu_torch.models.cat3dgs import arm
from gauspcc_tpu_torch.models.cat3dgs import field as cat_field
from gauspcc_tpu_torch.models.cat3dgs import model as cat
from gauspcc_tpu_torch.models.hac import codec as hac_codec
from gauspcc_tpu_torch.models.hac import model as hac
from gauspcc_tpu_torch.ops import coder
from gauspcc_tpu_torch.ops import entropy_coding as ec

BATCH = 500  # anchors a batch (the reference's MAX_batch_size for CAT)
BIT2MB = hac_codec.BIT2MB
SYM_BOUND = 256  # the planes' symbols are clipped to +-SYM_BOUND


def _arm_file(out_dir: str) -> str:
    return os.path.join(out_dir, "arm_q.bin")


def _plane_file(out_dir: str, si: int, g: str, c: int) -> str:
    return os.path.join(out_dir, f"tri_{si}_{g}_{c}.b")


@torch.no_grad()
def coded_planes(state) -> list:
    """The integer latents the stream carries: each scale's planes rounded
    at their gain and clipped to +-SYM_BOUND, float32 on the state's
    device."""
    return [torch.clamp(p, -SYM_BOUND, SYM_BOUND)
            for p in cat_field.quantized_planes(state["nets"].field)]


def encode_triplanes(state, cfg: cat.CATConfig, out_dir: str) -> int:
    """arm_q.bin (the three groups' integer ARMs), then every plane of
    every scale under its group's. Returns the bits written, the weights'
    included."""
    f = state["nets"].field
    qarms = {g: arm.quantize_arm(f.arms[g]) for g in cat_field.GROUPS}
    blob = b"".join(arm.pack_arm(qarms[g]) for g in cat_field.GROUPS)
    with open(_arm_file(out_dir), "wb") as fh:
        fh.write(blob)
    bits = len(blob) * 8
    for si, planes in enumerate(coded_planes(state)):
        planes = planes.cpu().numpy()
        for p, g in enumerate(cat_field.GROUPS):
            for c in range(planes.shape[1]):
                stream = arm.encode_plane_fixed(qarms[g], planes[p, c], SYM_BOUND)
                with open(_plane_file(out_dir, si, g, c), "wb") as fh:
                    fh.write(stream)
                bits += len(stream) * 8
    return bits


def decode_triplanes(cfg: cat.CATConfig, out_dir: str, device) -> list:
    """The integer latents [3, tri_feat, R, R] of each scale, float32 on
    `device`, from the stream's integer ARMs alone."""
    with open(_arm_file(out_dir), "rb") as fh:
        blob = fh.read()
    qarms, off = {}, 0
    for g in cat_field.GROUPS:
        qarms[g], used = arm.unpack_arm(blob, off)
        off += used
    planes_q = []
    for si, r in enumerate(cfg.field.resolutions()):
        planes = np.zeros((3, cfg.tri_feat, r, r), np.float32)
        for p, g in enumerate(cat_field.GROUPS):
            for c in range(cfg.tri_feat):
                with open(_plane_file(out_dir, si, g, c), "rb") as fh:
                    planes[p, c] = arm.decode_plane_fixed(qarms[g], fh.read())
        planes_q.append(torch.from_numpy(planes).to(device))
    return planes_q


def _padded(x: torch.Tensor) -> torch.Tensor:
    """x's rows in the first rows of BATCH rows of zeros."""
    return hac_codec._pad(x, (BATCH,) + tuple(x.shape[1:]))


@torch.no_grad()
def _batch_hyper(state, cfg: cat.CATConfig, pos: torch.Tensor, lo: int,
                 hi: int, planes_q: list, clock) -> dict:
    """The triplane hyperprior of anchors lo..hi, computed on BATCH rows."""
    with clock:
        hyper = cat.hyper_split(state, cfg, _padded(pos[lo:hi]), planes_q)
    return {k: v[: hi - lo] for k, v in hyper.items()}


@torch.no_grad()
def _slice_stats(state, cfg: cat.CATConfig, hyper: dict, feat: torch.Tensor,
                 i: int, clock):
    """(mean, scale) of feature slice i: the hyperprior's for slice 0, else
    mlp_chcm over the slices before it, computed on BATCH rows."""
    if i == 0:
        return hyper["mean0"], hyper["scale0"]
    b = feat.shape[0]
    with clock:
        m, s = cat.chcm_slice_stats(state, cfg, _padded(feat), i)
    return m[:b], s[:b]


@torch.no_grad()
def _adjusted(state, cfg: cat.CATConfig, hyper: dict, feat: torch.Tensor,
              clock) -> dict:
    """chcm_adjust on BATCH rows (hyper as it is when both heads are off)."""
    if not (cfg.chcm_for_offsets or cfg.chcm_for_scaling):
        return hyper
    b = feat.shape[0]
    with clock:
        adj = cat.chcm_adjust(state, cfg, {k: _padded(v) for k, v in hyper.items()},
                              _padded(feat))
    return {k: v[:b] for k, v in adj.items()}


def _slices(cfg: cat.CATConfig) -> list:
    bounds = np.cumsum([0] + list(cfg.chcm_slices))
    return [slice(int(bounds[i]), int(bounds[i + 1]))
            for i in range(len(cfg.chcm_slices))]


def conduct_encoding(state, cfg: cat.CATConfig, out_dir: str, pcc_params,
                     pcc_cfg=pcc_model.NetConfig(), values: dict | None = None,
                     profile: dict | None = None) -> tuple[dict, str]:
    """Encode the scene to `out_dir` on the state's device. Returns (sizes
    in bits per component and in total, a log line). `values`, when a
    dict, gets what the decoder will give: feat [n, F], scaling [n, 6] and
    offset [n, K, 3] in the coded order, and the integer latents ("planes",
    one [3, C, R, R] a scale); `profile`, when a dict, gets the seconds of
    the anchors' codec and of the triplane coder (its host coder's share
    included), the context's device ms, and the host coder's seconds
    outside the triplane coder."""
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

        t0, tri_coder0 = time.perf_counter(), coder.seconds
        bits_triplane = encode_triplanes(state, cfg, out_dir)
        planes_q = coded_planes(state)
        triplane_s = time.perf_counter() - t0
        tri_coder_s = coder.seconds - tri_coder0

        pos = hac_codec._positions(data["anchor_int"], base, dev)
        means = {f: float(data[f].mean()) if n else 0.0
                 for f in ("feat", "scaling", "offset")}
        bits = {"feat": 0, "scaling": 0, "offsets": 0}
        got = {"feat": [], "scaling": [], "offset": []}
        for s in range((n + BATCH - 1) // BATCH):
            lo, hi = s * BATCH, min((s + 1) * BATCH, n)
            b = hi - lo
            hyper = _batch_hyper(state, cfg, pos, lo, hi, planes_q, clock)
            feat_q = ste_multistep(data["feat"][lo:hi], hyper["q_feat"],
                                   means["feat"])
            q_full = hyper["q_feat"].expand(b, fd)
            # the slices as the decoder will hold them: the channel context
            # reads these
            dec_feat = torch.zeros((b, fd), dtype=torch.float32, device=dev)
            for i, cols in enumerate(_slices(cfg)):
                m, sc = _slice_stats(state, cfg, hyper, dec_feat, i, clock)
                args = (feat_q[:, cols], m, torch.clamp_min(sc, 1e-9),
                        q_full[:, cols])
                bits["feat"] += ec.encode_gaussian(
                    *args, os.path.join(out_dir, f"feat_{s}_{i}.b"))
                dec_feat[:, cols] = ec.gaussian_values(*args).reshape(
                    b, cols.stop - cols.start)
            got["feat"].append(dec_feat)
            hyper = _adjusted(state, cfg, hyper, dec_feat, clock)
            hac_codec._encode_scaling_offsets(
                data, hyper, lo, hi, means, out_dir, s, k, bits,
                got if values is not None else None)
        bit_masks = ec.encode_binary(data["mask"].reshape(-1),
                                     os.path.join(out_dir, "masks.b"))
    if values is not None:
        empty = {"feat": (0, fd), "scaling": (0, 6), "offset": (0, k, 3)}
        for name, chunks in got.items():
            values[name] = (torch.cat(chunks) if chunks else
                            torch.zeros(empty[name], device=dev))
        values["planes"] = planes_q

    meta = {"n_anchors": int(n), "batch": BATCH,
            **{f"{f}_mean": v for f, v in means.items()}}
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f)

    enc_time = time.perf_counter() - t_start
    sizes = {"anchor": out["file_size_bits"], **bits,
             "triplane": bits_triplane, "masks": bit_masks,
             "mlps": hac.mlp_size_bits(state)}
    sizes["total"] = sum(sizes.values())
    if profile is not None:
        profile.update(total_s=enc_time, anchors_s=anchors_s,
                       triplane_s=triplane_s, context_ms=clock.ms,
                       coder_s=coder.seconds - coder_s0 - tri_coder_s)
    log = "Encoded sizes in MB: " + ", ".join(
        f"{k_} {v / BIT2MB:.4f}" for k_, v in sizes.items()
    ) + f", EncTime {enc_time:.4f}"
    return sizes, log


def conduct_decoding(state, cfg: cat.CATConfig, out_dir: str, pcc_params,
                     pcc_cfg=pcc_model.NetConfig(),
                     profile: dict | None = None):
    """Decode the scene in `out_dir` into a decoded state on the device of
    `state`, which gives the networks (copied; the field's planes replaced
    by the decoded latents over their gains) and the context's bounds.
    Returns (decoded state, a log line); `profile` as in
    conduct_encoding."""
    base = cfg.as_hac()
    dev = hac_codec._device(state)
    hac_codec._sync(dev)
    t_start = time.perf_counter()
    coder_s0 = coder.seconds
    with open(os.path.join(out_dir, "meta.json")) as f:
        meta = json.load(f)
    n, k, fd = meta["n_anchors"], cfg.n_offsets, cfg.feat_dim
    clock = hac_codec._DeviceClock(dev)
    with torch.no_grad(), pcc._exact_gemms():
        t0 = time.perf_counter()
        planes_q = decode_triplanes(cfg, out_dir, dev)
        triplane_s = time.perf_counter() - t0
        tri_coder_s = coder.seconds - coder_s0
        masks01 = ec.decode_binary(n * k, os.path.join(out_dir, "masks.b"),
                                   dev).reshape(n, k, 1)
        dec_state, pos, anchors_s = hac_codec._decoded_anchors(
            state, base, out_dir, pcc_params, pcc_cfg, masks01,
            copy.deepcopy(state["nets"]))
        field = dec_state["nets"].field
        for i, p in enumerate(field.scales):
            p.copy_(planes_q[i] / cat_field.gain(field, i))

        batches = []
        for s in range((n + BATCH - 1) // BATCH):
            lo, hi = s * BATCH, min((s + 1) * BATCH, n)
            b = hi - lo
            hyper = _batch_hyper(dec_state, cfg, pos, lo, hi, planes_q, clock)
            q_full = hyper["q_feat"].expand(b, fd)
            feat = torch.zeros((b, fd), dtype=torch.float32, device=dev)
            for i, cols in enumerate(_slices(cfg)):
                m, sc = _slice_stats(dec_state, cfg, hyper, feat, i, clock)
                feat[:, cols] = ec.decode_gaussian(
                    m, torch.clamp_min(sc, 1e-9), q_full[:, cols],
                    os.path.join(out_dir, f"feat_{s}_{i}.b")).reshape(
                        b, cols.stop - cols.start)
            hyper = _adjusted(dec_state, cfg, hyper, feat, clock)
            batches.append((feat, *hac_codec._decode_scaling_offsets(
                hyper, masks01[lo:hi], out_dir, s, k)))
        hac_codec._fill_attributes(dec_state, batches, cfg)
    hac_codec._sync(dev)
    dec_time = time.perf_counter() - t_start
    if profile is not None:
        profile.update(total_s=dec_time, anchors_s=anchors_s,
                       triplane_s=triplane_s, context_ms=clock.ms,
                       coder_s=coder.seconds - coder_s0 - tri_coder_s)
    return dec_state, f"DecTime {dec_time:.4f}"
