"""HAC's scene bitstream (counterpart of gauspcc_tpu/models/hac/codec.py:
`estimate_final_bits` :84, `_gather_sorted_attributes` :95,
`conduct_encoding` :112, `conduct_decoding` :200).

The anchors with any mask on are voxel-rounded and put in morton order.
Their positions go through the port's GausPcgc codec (version byte 5, on
the state's device, its rANS through the CUDA kernels on the card). Their
features, scalings and offsets are coded 3,000 anchors at a time, under
Gaussian models that the hash-grid context and `mlp_grid` give at the
anchors' coded positions; the hash tables' signs and the offsets' masks
go through the binary coder with one global p1. The coding itself is the
native host coder's (`ops/entropy_coding.py`).

The decoder recomputes the encoder's models from the decoded anchors and
tables, and a wrong bit of a model gives a wrong symbol. So both sides pad
every batch to BATCH rows, so that the GEMMs have one shape, and compute
with full-precision float32 GEMMs (no TF32), set here and not left to the
caller: a stream decodes on the device type, and the build of the coder
and of cuBLAS, that wrote it.

Files in `out_dir`: xyz_pcc.bin, feat_<s>.b, scaling_<s>.b, offsets_<s>.b
per batch s, hash.b, masks.b and meta.json, as the JAX package writes them.
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
from gauspcc_tpu_torch.core import entropy
from gauspcc_tpu_torch.core.quant import ANCHOR_ROUND_DIGITS, ste_multistep
from gauspcc_tpu_torch.fields import hashgrid
from gauspcc_tpu_torch.models.hac import model as hac
from gauspcc_tpu_torch.ops import coder, sparse
from gauspcc_tpu_torch.ops import entropy_coding as ec

BIT2MB = 8 * 1024 * 1024
BATCH = 3000  # anchors a batch (the reference's MAX_batch_size)


class _DeviceClock:
    """Summed milliseconds of timed device work: CUDA events on the card
    (read once, at `ms`), the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.spans: list = []

    def __enter__(self):
        if self.cuda:
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record()
        else:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self.spans.append((self.start, end))
        else:
            self.spans.append((time.perf_counter() - self.t0) * 1e3)

    @property
    def ms(self) -> float:
        if not self.cuda:
            return float(sum(self.spans))
        torch.cuda.synchronize()
        return float(sum(a.elapsed_time(b) for a, b in self.spans))


def _device(state) -> torch.device:
    return state["anchors"]["anchor"].device


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@torch.no_grad()
def _batch_context(state, cfg: hac.HACConfig, anchor_batch: torch.Tensor):
    """Hash-grid context and mlp_grid heads for one anchor batch [B, 3]."""
    return hac.grid_mlp_split(state, cfg,
                              hac.calc_interp_feat(state, cfg, anchor_batch))


@torch.no_grad()
def _estimate_bits(state, cfg: hac.HACConfig) -> dict:
    """The analytic size of every component over the valid, mask-on
    anchors (bits, as tensors)."""
    mask_anchor = hac.get_mask_anchor(state)
    sel = mask_anchor[:, None].to(torch.float32)
    anchors = state["anchors"]
    k = cfg.n_offsets
    ctx = _batch_context(state, cfg, hac.get_anchor(state, cfg))
    scaling0 = hac.get_scaling(state)
    feat = ste_multistep(anchors["anchor_feat"], ctx["q_feat"],
                         anchors["anchor_feat"].mean())
    scaling = ste_multistep(scaling0, ctx["q_scaling"], scaling0.mean())
    offsets = ste_multistep(anchors["offset"], ctx["q_offsets"][:, None, :],
                            anchors["offset"].mean()).reshape(-1, 3 * k)
    m = hac.get_mask(state)
    mask3 = torch.repeat_interleave(m, 3, dim=-1).reshape(-1, 3 * k)
    bit_feat = (entropy.gaussian_bits(feat, ctx["mean"], ctx["scale"],
                                      ctx["q_feat"]) * sel).sum()
    bit_scaling = (entropy.gaussian_bits(
        scaling, ctx["mean_scaling"], ctx["scale_scaling"],
        ctx["q_scaling"]) * sel).sum()
    bit_offsets = (entropy.gaussian_bits(
        offsets, ctx["mean_offsets"], ctx["scale_offsets"],
        ctx["q_offsets"]) * mask3 * sel).sum()
    flat = hac.encoding_params_flat(state)
    _, bit_hash = entropy.binary_size_bits((flat + 1.0) / 2.0)
    _, bit_masks = entropy.binary_size_bits(m * sel[:, :, None])
    return {
        "anchor": mask_anchor.sum() * 3 * ANCHOR_ROUND_DIGITS,
        "feat": bit_feat, "scaling": bit_scaling, "offsets": bit_offsets,
        "hash": bit_hash, "masks": bit_masks,
    }


def estimate_final_bits(state, cfg: hac.HACConfig) -> tuple[dict, str]:
    """(estimated bits per component and in total, a log line)."""
    bits = {k: float(v) for k, v in _estimate_bits(state, cfg).items()}
    bits["mlps"] = float(hac.mlp_size_bits(state))
    bits["total"] = sum(bits.values())
    log = "Estimated sizes in MB: " + ", ".join(
        f"{k} {v / BIT2MB:.4f}" for k, v in bits.items())
    return bits, log


@torch.no_grad()
def _gather_sorted_attributes(state, cfg: hac.HACConfig) -> dict:
    """The valid, mask-on anchors, voxel-rounded and in morton order:
    anchor_int (int64 numpy [n, 3], on the host for the geometry codec and
    the order) and index (their rows in the state), feat, offset, scaling,
    mask (on the state's device)."""
    dev = _device(state)
    idx = torch.nonzero(hac.get_mask_anchor(state))[:, 0]
    anchor = hac.get_anchor(state, cfg)[idx]
    anchor_int = torch.round(anchor / cfg.voxel_size).to(torch.int64).cpu().numpy()
    order = sparse.morton_order_np(anchor_int)
    idx = idx[torch.as_tensor(order, device=dev)]
    anchors = state["anchors"]
    return {
        "anchor_int": anchor_int[order],
        "index": idx,
        "feat": anchors["anchor_feat"][idx],
        "offset": anchors["offset"][idx],
        "scaling": hac.get_scaling(state)[idx],
        "mask": hac.get_mask(state)[idx],
    }


def _positions(anchor_int: np.ndarray, cfg: hac.HACConfig,
               dev: torch.device) -> torch.Tensor:
    """Coded anchor positions, float32 [n, 3], computed alike on both sides."""
    return torch.from_numpy(anchor_int.astype(np.float32) * cfg.voxel_size).to(dev)


def _padded_context(state, cfg, pos: torch.Tensor, lo: int, hi: int,
                    clock: _DeviceClock, context=None) -> dict:
    """The context of anchors lo..hi, computed on a batch padded to BATCH
    by `context` (HAC's `_batch_context` unless a family gives its own)."""
    batch = torch.zeros((BATCH, 3), dtype=torch.float32, device=pos.device)
    batch[: hi - lo] = pos[lo:hi]
    with clock:
        ctx = (context or _batch_context)(state, cfg, batch)
    return {k: v[: hi - lo] for k, v in ctx.items()}


def _pad(x: torch.Tensor, shape) -> torch.Tensor:
    """x in the first rows of float32 zeros of `shape`, on x's device."""
    out = torch.zeros(shape, dtype=torch.float32, device=x.device)
    out[: x.shape[0]] = x
    return out


def _offset_mask(mask: torch.Tensor) -> torch.Tensor:
    """[b, K, 1] {0, 1} masks -> bool [b * 3K], one per offset coordinate."""
    return torch.repeat_interleave(mask, 3, dim=-1).reshape(-1) > 0


def _encode_scaling_offsets(data: dict, ctx: dict, lo: int, hi: int,
                            means: dict, out_dir: str, s: int, k: int,
                            bits: dict, got: dict | None) -> None:
    """Code batch s's scalings and (mask-on) offsets under the context's
    Gaussians into scaling_<s>.b and offsets_<s>.b, adding their bits to
    `bits` and, with `got`, what the decoder will give to its lists."""
    b = hi - lo
    args = (ste_multistep(data["scaling"][lo:hi], ctx["q_scaling"],
                          means["scaling"]),
            ctx["mean_scaling"], ctx["scale_scaling"],
            ctx["q_scaling"].expand(b, 6))
    bits["scaling"] += ec.encode_gaussian(
        *args, os.path.join(out_dir, f"scaling_{s}.b"))
    offs = ste_multistep(data["offset"][lo:hi], ctx["q_offsets"][:, None, :],
                         means["offset"]).reshape(-1)
    msk = _offset_mask(data["mask"][lo:hi])
    off_args = (offs[msk], ctx["mean_offsets"].reshape(-1)[msk],
                ctx["scale_offsets"].reshape(-1)[msk],
                ctx["q_offsets"].expand(b, 3 * k).reshape(-1)[msk])
    bits["offsets"] += ec.encode_gaussian(
        *off_args, os.path.join(out_dir, f"offsets_{s}.b"))
    if got is not None:
        got["scaling"].append(ec.gaussian_values(*args).reshape(b, 6))
        dec_off = torch.zeros(b * 3 * k, dtype=torch.float32, device=offs.device)
        dec_off[msk] = ec.gaussian_values(*off_args)
        got["offset"].append(dec_off.reshape(b, k, 3))


def _encode_batch(data: dict, ctx: dict, lo: int, hi: int, means: dict,
                  out_dir: str, s: int, cfg, bits: dict,
                  got: dict | None) -> None:
    """Code batch s's features into feat_<s>.b under the context's
    Gaussians, then its scalings and offsets (_encode_scaling_offsets)."""
    b, fd = hi - lo, cfg.feat_dim
    args = (ste_multistep(data["feat"][lo:hi], ctx["q_feat"], means["feat"]),
            ctx["mean"], ctx["scale"], ctx["q_feat"].expand(b, fd))
    bits["feat"] += ec.encode_gaussian(*args,
                                       os.path.join(out_dir, f"feat_{s}.b"))
    if got is not None:
        got["feat"].append(ec.gaussian_values(*args).reshape(b, fd))
    _encode_scaling_offsets(data, ctx, lo, hi, means, out_dir, s,
                            cfg.n_offsets, bits, got)


def _decode_batch(ctx: dict, masks01: torch.Tensor, out_dir: str, s: int,
                  cfg):
    """Inverse of _encode_batch: (feat [b, F], scaling [b, 6], offsets
    [b, K, 3], 0 where masked off)."""
    b, fd = masks01.shape[0], cfg.feat_dim
    feat = ec.decode_gaussian(
        ctx["mean"], ctx["scale"], ctx["q_feat"].expand(b, fd),
        os.path.join(out_dir, f"feat_{s}.b")).reshape(b, fd)
    return (feat, *_decode_scaling_offsets(ctx, masks01, out_dir, s,
                                           cfg.n_offsets))


def _decode_scaling_offsets(ctx: dict, masks01: torch.Tensor, out_dir: str,
                            s: int, k: int):
    """Inverse of _encode_scaling_offsets for one batch: (scaling [b, 6],
    offsets [b, K, 3], 0 where masked off)."""
    b = masks01.shape[0]
    scal = ec.decode_gaussian(
        ctx["mean_scaling"], ctx["scale_scaling"], ctx["q_scaling"].expand(b, 6),
        os.path.join(out_dir, f"scaling_{s}.b")).reshape(b, 6)
    msk = _offset_mask(masks01)
    dec_off = torch.zeros(b * 3 * k, dtype=torch.float32, device=masks01.device)
    if bool(msk.any()):
        dec_off[msk] = ec.decode_gaussian(
            ctx["mean_offsets"].reshape(-1)[msk],
            ctx["scale_offsets"].reshape(-1)[msk],
            ctx["q_offsets"].expand(b, 3 * k).reshape(-1)[msk],
            os.path.join(out_dir, f"offsets_{s}.b"))
    return scal, dec_off.reshape(b, k, 3)


def conduct_encoding(state, cfg: hac.HACConfig, out_dir: str, pcc_params,
                     pcc_cfg=pcc_model.NetConfig(), values: dict | None = None,
                     profile: dict | None = None) -> tuple[dict, str]:
    """Encode the scene to `out_dir` on the state's device. Returns (sizes
    in bits per component and in total, a log line). `values`, when a
    dict, gets what the decoder will give for feat [n, F], scaling [n, 6]
    and offset [n, K, 3] (0 where masked off), in the coded order;
    `profile`, when a dict, gets the seconds of the anchors' codec, the
    context's device ms and the host coder's seconds."""
    os.makedirs(out_dir, exist_ok=True)
    dev = _device(state)
    _sync(dev)
    t_start = time.perf_counter()
    coder_s0 = coder.seconds
    k, fd = cfg.n_offsets, cfg.feat_dim
    clock = _DeviceClock(dev)
    with torch.no_grad(), pcc._exact_gemms():
        data = _gather_sorted_attributes(state, cfg)
        n = data["anchor_int"].shape[0]
        t0 = time.perf_counter()
        out = pcc.compress_point_cloud(
            data["anchor_int"], pcc_params, os.path.join(out_dir, "xyz_pcc.bin"),
            config=pcc_cfg, device=dev)
        _sync(dev)
        anchors_s = time.perf_counter() - t0
        pos = _positions(data["anchor_int"], cfg, dev)
        means = {f: float(data[f].mean()) if n else 0.0
                 for f in ("feat", "scaling", "offset")}

        bits = {"feat": 0, "scaling": 0, "offsets": 0}
        got = {"feat": [], "scaling": [], "offset": []}
        for s in range((n + BATCH - 1) // BATCH):
            lo, hi = s * BATCH, min((s + 1) * BATCH, n)
            ctx = _padded_context(state, cfg, pos, lo, hi, clock)
            _encode_batch(data, ctx, lo, hi, means, out_dir, s, cfg, bits,
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
                       context_ms=clock.ms, coder_s=coder.seconds - coder_s0)
    log = "Encoded sizes in MB: " + ", ".join(
        f"{k_} {v / BIT2MB:.4f}" for k_, v in sizes.items()
    ) + f", EncTime {enc_time:.4f}"
    return sizes, log


def _decoded_skeleton(state, cfg, out_dir: str, pcc_params, pcc_cfg, n: int):
    """The decoder's first steps, HAC's and HAC++'s: the hash tables (the
    context's source), then the masks, then the anchors, into a decoded
    state of zero attributes on the device of `state`, whose networks it
    copies with the decoded tables. Returns (the state, the coded positions
    [n, 3], the masks [n, K, 1], the anchors' seconds)."""
    dev = _device(state)
    k = cfg.n_offsets
    spec = cfg.grid_spec
    n_hash = spec.xyz.n_rows * spec.xyz.n_features + 3 * (
        spec.plane.n_rows * spec.plane.n_features)
    flat01 = ec.decode_binary(n_hash, os.path.join(out_dir, "hash.b"), dev)
    tables = hashgrid.unflatten_tables(
        spec, (flat01 * 2.0 - 1.0).reshape(-1, cfg.n_features_per_level))
    masks01 = ec.decode_binary(n * k, os.path.join(out_dir, "masks.b"),
                               dev).reshape(n, k, 1)
    nets = copy.deepcopy(state["nets"])
    nets.tables = tables
    dec_state, pos, anchors_s = _decoded_anchors(
        state, cfg, out_dir, pcc_params, pcc_cfg, masks01, nets)
    return dec_state, pos, masks01, anchors_s


def _decoded_anchors(state, cfg, out_dir: str, pcc_params, pcc_cfg,
                     masks01: torch.Tensor, nets):
    """Decode the anchors of out_dir/xyz_pcc.bin into a decoded state on
    the device of `state`: the anchors with zero attributes, the decoded
    masks masks01 [n, K, 1], the networks `nets` and the bounds of
    `state`. Returns (the state, the coded positions [n, 3], the anchors'
    seconds)."""
    dev = _device(state)
    n, k = masks01.shape[0], cfg.n_offsets
    t0 = time.perf_counter()
    dec = pcc.decompress_point_cloud(os.path.join(out_dir, "xyz_pcc.bin"),
                                     pcc_params, config=pcc_cfg, device=dev)
    _sync(dev)
    anchors_s = time.perf_counter() - t0
    anchor_int = dec["point_cloud"].astype(np.int64)
    anchor_int = anchor_int[sparse.morton_order_np(anchor_int)]
    if anchor_int.shape[0] != n:
        raise ValueError(f"decoded {anchor_int.shape[0]} anchors, the "
                         f"stream holds {n}")
    pos = _positions(anchor_int, cfg, dev)
    cap = hac.bucket_capacity(n)
    rotation = torch.zeros((cap, 4), dtype=torch.float32, device=dev)
    rotation[:n, 0] = 1.0
    dec_state = {
        "anchors": {
            "anchor": _pad(pos, (cap, 3)),
            "offset": torch.zeros((cap, k, 3), device=dev),
            "mask": _pad(masks01, (cap, k, 1)),
            "anchor_feat": torch.zeros((cap, cfg.feat_dim), device=dev),
            "scaling": torch.zeros((cap, 6), device=dev),
            "rotation": rotation,
            "opacity": torch.zeros((cap, 1), device=dev),
        },
        "valid": torch.arange(cap, device=dev) < n,
        "nets": nets,
        "x_bound_min": state["x_bound_min"],
        "x_bound_max": state["x_bound_max"],
    }
    return dec_state, pos, anchors_s


def _fill_attributes(dec_state, batches: list, cfg) -> None:
    """Write the decoded batches' (feat, scaling, offsets) into the first
    rows of the decoded state's anchors."""
    if not batches:
        return
    a = dec_state["anchors"]
    cap, k = dec_state["valid"].shape[0], cfg.n_offsets
    feat, scaling, offset = (torch.cat(parts) for parts in zip(*batches))
    a["anchor_feat"] = _pad(feat, (cap, cfg.feat_dim))
    a["scaling"] = _pad(scaling, (cap, 6))
    a["offset"] = _pad(offset, (cap, k, 3))


def conduct_decoding(state, cfg: hac.HACConfig, out_dir: str, pcc_params,
                     pcc_cfg=pcc_model.NetConfig(),
                     profile: dict | None = None):
    """Decode the scene in `out_dir` into a decoded state on the device of
    `state`, which gives the networks (copied, with the decoded tables) and
    the context's bounds. Returns (decoded state, a log line); `profile`
    as in conduct_encoding."""
    dev = _device(state)
    _sync(dev)
    t_start = time.perf_counter()
    coder_s0 = coder.seconds
    with open(os.path.join(out_dir, "meta.json")) as f:
        meta = json.load(f)
    n = meta["n_anchors"]
    clock = _DeviceClock(dev)
    with torch.no_grad(), pcc._exact_gemms():
        dec_state, pos, masks01, anchors_s = _decoded_skeleton(
            state, cfg, out_dir, pcc_params, pcc_cfg, n)

        batches = []
        for s in range((n + BATCH - 1) // BATCH):
            lo, hi = s * BATCH, min((s + 1) * BATCH, n)
            ctx = _padded_context(dec_state, cfg, pos, lo, hi, clock)
            batches.append(_decode_batch(ctx, masks01[lo:hi], out_dir, s, cfg))
        _fill_attributes(dec_state, batches, cfg)
    _sync(dev)
    dec_time = time.perf_counter() - t_start
    if profile is not None:
        profile.update(total_s=dec_time, anchors_s=anchors_s,
                       context_ms=clock.ms, coder_s=coder.seconds - coder_s0)
    return dec_state, f"DecTime {dec_time:.4f}"
