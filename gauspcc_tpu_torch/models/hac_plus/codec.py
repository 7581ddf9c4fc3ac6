"""HAC++'s scene bitstream (counterpart of
gauspcc_tpu/models/hac_plus/codec.py: `_batch_context` :33,
`_chunk_mixture` :39, `conduct_encoding` :46, `conduct_decoding` :135).

HAC's stream (`models/hac/codec.py`) with the features coded chunk by
chunk: per batch of 3,000 anchors, five streams feat_<s>_<c>.b, each under
the softmaxed 2-component mixture of the hyperprior and the channel
context, whose MLP reads the chunks before it. The decoder decodes a chunk
and feeds it to the next chunk's context. Anchors, scaling, offsets, hash
signs and masks are HAC's.

As in HAC's codec, the decoder recomputes every model bit for bit: both
sides pad a batch's context to BATCH rows, run the chunk mixtures on the
batch's rows with one GEMM shape a chunk (the MLP of chunk c reads chunks
< c only, and their decoded values equal the encoder's quantised ones),
and compute inside the codec's full-precision GEMM context.
"""

from __future__ import annotations

import json
import os
import time

import torch

from gauspcc_tpu_torch.codecs.gauspcgc import codec as pcc
from gauspcc_tpu_torch.codecs.gauspcgc import model as pcc_model
from gauspcc_tpu_torch.core.quant import ste_multistep
from gauspcc_tpu_torch.models.hac import codec as hac_codec
from gauspcc_tpu_torch.models.hac import model as hac
from gauspcc_tpu_torch.models.hac_plus import model as hacp
from gauspcc_tpu_torch.ops import coder
from gauspcc_tpu_torch.ops import entropy_coding as ec

BATCH = hac_codec.BATCH
BIT2MB = hac_codec.BIT2MB


@torch.no_grad()
def _batch_context(state, cfg: hacp.HACPlusConfig, anchor_batch: torch.Tensor):
    """Hash-grid context and HAC++'s mlp_grid heads for one batch [B, 3]."""
    return hacp.grid_mlp_split(
        state, cfg, hac.calc_interp_feat(state, cfg.as_hac(), anchor_batch))


@torch.no_grad()
def _chunk_mixture(state, cfg: hacp.HACPlusConfig, ctx: dict,
                   feat_partial: torch.Tensor, to_dec: int):
    """Chunk `to_dec`'s mixture, each list entry flat [b * chunk], the
    scales floored at 1e-9 as the coder needs them."""
    means, scales, probs = hacp.mixture_components(
        ctx, state["nets"].channel_ctx, cfg, feat_partial, to_dec)
    return ([m.reshape(-1) for m in means],
            [torch.clamp_min(s, 1e-9).reshape(-1) for s in scales],
            [p.reshape(-1) for p in probs])


def conduct_encoding(state, cfg: hacp.HACPlusConfig, out_dir: str, pcc_params,
                     pcc_cfg=pcc_model.NetConfig(), values: dict | None = None,
                     profile: dict | None = None) -> tuple[dict, str]:
    """Encode the scene to `out_dir` on the state's device. Returns (sizes
    in bits per component and in total, a log line). `values`, when a
    dict, gets what the decoder will give for feat [n, F], scaling [n, 6]
    and offset [n, K, 3], in the coded order; `profile`, when a dict, gets
    the seconds of the anchors' codec, the context's and the chunk
    mixtures' device ms and the host coder's seconds."""
    os.makedirs(out_dir, exist_ok=True)
    base = cfg.as_hac()
    dev = hac_codec._device(state)
    hac_codec._sync(dev)
    t_start = time.perf_counter()
    coder_s0 = coder.seconds
    k, fd, c = cfg.n_offsets, cfg.feat_dim, cfg.chunk
    clock = hac_codec._DeviceClock(dev)
    mix_clock = hac_codec._DeviceClock(dev)
    with torch.no_grad(), pcc._exact_gemms():
        data = hac_codec._gather_sorted_attributes(state, base)
        n = data["anchor_int"].shape[0]
        t0 = time.perf_counter()
        out = pcc.compress_point_cloud(
            data["anchor_int"], pcc_params, os.path.join(out_dir, "xyz_pcc.bin"),
            config=pcc_cfg, device=dev)
        hac_codec._sync(dev)
        anchors_s = time.perf_counter() - t0
        pos = hac_codec._positions(data["anchor_int"], base, dev)
        means = {f: float(data[f].mean()) if n else 0.0
                 for f in ("feat", "scaling", "offset")}

        bits = {"feat": 0, "scaling": 0, "offsets": 0}
        got = {"feat": [], "scaling": [], "offset": []}
        for s in range((n + BATCH - 1) // BATCH):
            lo, hi = s * BATCH, min((s + 1) * BATCH, n)
            b = hi - lo
            ctx = hac_codec._padded_context(state, cfg, pos, lo, hi, clock,
                                            _batch_context)
            feat_q = ste_multistep(data["feat"][lo:hi], ctx["q_feat"],
                                   means["feat"])
            q_feat = ctx["q_feat"].expand(b, fd)
            dec_feat = torch.zeros((b, fd), dtype=torch.float32, device=dev)
            for cc in range(hacp.N_CHUNKS):
                cols = slice(cc * c, (cc + 1) * c)
                with mix_clock:
                    mix = _chunk_mixture(state, cfg, ctx, feat_q, cc)
                args = (feat_q[:, cols], *mix, q_feat[:, cols])
                bits["feat"] += ec.encode_gaussian_mixed(
                    *args, os.path.join(out_dir, f"feat_{s}_{cc}.b"))
                if values is not None:
                    dec_feat[:, cols] = ec.mixture_values(*args).reshape(b, c)
            got["feat"].append(dec_feat)
            hac_codec._encode_scaling_offsets(
                data, ctx, lo, hi, means, out_dir, s, k, bits,
                got if values is not None else None)

        flat = hac.encoding_params_flat(state)
        bit_hash = ec.encode_binary((flat.reshape(-1) + 1.0) / 2.0,
                                    os.path.join(out_dir, "hash.b"))
        bit_masks = ec.encode_binary(data["mask"].reshape(-1),
                                     os.path.join(out_dir, "masks.b"))
    if values is not None:
        empty = {"feat": (0, fd), "scaling": (0, 6), "offset": (0, k, 3)}
        for name, chunks in got.items():
            values[name] = (torch.cat(chunks) if chunks else
                            torch.zeros(empty[name], device=dev))

    meta = {"n_anchors": int(n), "batch": BATCH,
            "feat_mean": means["feat"], "scaling_mean": means["scaling"],
            "offsets_mean": means["offset"]}
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f)

    enc_time = time.perf_counter() - t_start
    sizes = {"anchor": out["file_size_bits"], **bits, "hash": bit_hash,
             "masks": bit_masks, "mlps": hac.mlp_size_bits(state)}
    sizes["total"] = sum(sizes.values())
    if profile is not None:
        profile.update(total_s=enc_time, anchors_s=anchors_s,
                       context_ms=clock.ms, mixture_ms=mix_clock.ms,
                       coder_s=coder.seconds - coder_s0)
    log = "Encoded sizes in MB: " + ", ".join(
        f"{k_} {v / BIT2MB:.4f}" for k_, v in sizes.items()
    ) + f", EncTime {enc_time:.4f}"
    return sizes, log


def conduct_decoding(state, cfg: hacp.HACPlusConfig, out_dir: str, pcc_params,
                     pcc_cfg=pcc_model.NetConfig(),
                     profile: dict | None = None):
    """Decode the scene in `out_dir` into a decoded state on the device of
    `state`, which gives the networks (copied, with the decoded tables) and
    the context's bounds. Returns (decoded state, a log line); `profile`
    as in conduct_encoding."""
    base = cfg.as_hac()
    dev = hac_codec._device(state)
    hac_codec._sync(dev)
    t_start = time.perf_counter()
    coder_s0 = coder.seconds
    with open(os.path.join(out_dir, "meta.json")) as f:
        meta = json.load(f)
    n, k, fd, c = meta["n_anchors"], cfg.n_offsets, cfg.feat_dim, cfg.chunk
    clock = hac_codec._DeviceClock(dev)
    mix_clock = hac_codec._DeviceClock(dev)
    with torch.no_grad(), pcc._exact_gemms():
        dec_state, pos, masks01, anchors_s = hac_codec._decoded_skeleton(
            state, base, out_dir, pcc_params, pcc_cfg, n)

        batches = []
        for s in range((n + BATCH - 1) // BATCH):
            lo, hi = s * BATCH, min((s + 1) * BATCH, n)
            b = hi - lo
            ctx = hac_codec._padded_context(dec_state, cfg, pos, lo, hi, clock,
                                            _batch_context)
            q_feat = ctx["q_feat"].expand(b, fd)
            feat = torch.zeros((b, fd), dtype=torch.float32, device=dev)
            for cc in range(hacp.N_CHUNKS):
                cols = slice(cc * c, (cc + 1) * c)
                with mix_clock:
                    mix = _chunk_mixture(dec_state, cfg, ctx, feat, cc)
                feat[:, cols] = ec.decode_gaussian_mixed(
                    *mix, q_feat[:, cols],
                    os.path.join(out_dir, f"feat_{s}_{cc}.b")).reshape(b, c)
            batches.append((feat, *hac_codec._decode_scaling_offsets(
                ctx, masks01[lo:hi], out_dir, s, k)))
        hac_codec._fill_attributes(dec_state, batches, cfg)
    hac_codec._sync(dev)
    dec_time = time.perf_counter() - t_start
    if profile is not None:
        profile.update(total_s=dec_time, anchors_s=anchors_s,
                       context_ms=clock.ms, mixture_ms=mix_clock.ms,
                       coder_s=coder.seconds - coder_s0)
    return dec_state, f"DecTime {dec_time:.4f}"
