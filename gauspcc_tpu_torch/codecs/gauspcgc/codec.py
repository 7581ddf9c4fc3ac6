"""GausPcgc point-cloud geometry codec, the sibling-packed engine: the
port's counterpart of gauspcc_tpu/codecs/gauspcgc/codec.py (`_bucket`
:120, `_stage_cdf_sib` :262, `_SibLevelGeometry` :275,
`_encode_levels_sib` :358, `_decode_levels_sib` :393,
`compress_point_cloud` :658, `decompress_point_cloud` :723).

Quantized coords in, a self-contained .bin out, losslessly decodable with
the same network weights. The bitstream is the JAX package's v4 framing:
  u32 magic 'GPCT' | u8 version | f16 posQ | i32[3] coord shift |
  i32 base_len | i32[base_len, 3] base coords | u8[base_len] base occ |
  framed per-level rANS streams (coarse to fine),
with its own version byte, 5. The version pins the engine that computed
the CDF tables: a decoder reproduces the encoder's tables bit for bit only
when it runs the same operations on the same device type and dtype, so a
stream decodes only on the engine, device type and dtype that wrote it,
and the decoder refuses every other version.

Per level, coarse to fine: the geometry (children, sibling packing, the
two k=3 cell maps) in torch on the codec's device (ops/hostmap.py); the
context conv stacks; four stage tables; four rANS stages (ops/rans.py,
the CUDA kernels on the card). Encode teacher-forces the earlier bits
from the ground truth and runs stages 3..0; decode runs 0..3, each
decoded stage feeding the next stage's table. Both sides run the same
torch operations on the same shapes, with no atomics on the context path
and cuBLAS's reduced-precision reductions off, so their tables agree.
"""

from __future__ import annotations

import time
from contextlib import contextmanager

import numpy as np
import torch

from gauspcc_tpu_torch.codecs.gauspcgc import model as net
from gauspcc_tpu_torch.core import bitstream, cdf as cdf_lib
from gauspcc_tpu_torch.device import resolve
from gauspcc_tpu_torch.ops import hostmap, rans, sibconv, sparse

MAGIC = 0x47504354  # 'GPCT'
VERSION_TORCH = 5  # the port's engine (the JAX package writes 2, 3 and 4)
MIN_BASE_POINTS = 64
_LATER = "see ROADMAP.md Queue 1 item 7"


def _bucket(n: int, minimum: int = 256) -> int:
    """Next capacity step: powers of two up to 16384, then multiples of
    16384."""
    b = minimum
    while b < n and b < 16384:
        b *= 2
    if n > b:
        b = ((n + 16383) // 16384) * 16384
    return b


@contextmanager
def _exact_gemms():
    """cuBLAS with full-precision reductions (float32 without TF32, bf16
    summed in float32), as the JAX package's conv product, and cuDNN's
    convolutions in float32 without TF32 (TC-GS's autoencoder), on both
    sides of the codec alike."""
    m = torch.backends.cuda.matmul
    cudnn = torch.backends.cudnn
    saved = (m.allow_tf32, m.allow_bf16_reduced_precision_reduction,
             cudnn.allow_tf32)
    m.allow_tf32 = False
    m.allow_bf16_reduced_precision_reduction = False
    cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (m.allow_tf32, m.allow_bf16_reduced_precision_reduction,
         cudnn.allow_tf32) = saved


class _Timer:
    """Per-level phase times for `profile`: CUDA events on the card (no
    synchronisation until `finish`), the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: list[tuple[str, object]] = []
        self.mark("start")

    def mark(self, name: str) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append((name, ev))
        else:
            self.marks.append((name, time.perf_counter()))

    def finish(self) -> dict[str, float]:
        """{phase: ms} between consecutive marks."""
        if self.cuda:
            self.marks[-1][1].synchronize()
        out = {}
        for (_, a), (name, b) in zip(self.marks, self.marks[1:]):
            out[name] = a.elapsed_time(b) if self.cuda else (b - a) * 1e3
        return out


class _SibLevelGeometry:
    """Sibling-packed geometry of one pyramid level, on the codec's device.

    p_coords int [Np, 3] lex-sorted parents; p_occ int [Np] their
    occupancy bytes. `parent_gmapT` is the previous level's child-cell map:
    the groups of this level's parents are the previous level's parents
    (every voxel has a child), so it is this level's parent-cell map."""

    def __init__(self, p_coords, p_occ, n_child: int, parent_gmapT=None):
        dev = p_coords.device
        np_ = p_coords.shape[0]
        pcap = _bucket(np_)
        self.n_parents = np_
        self.n_child = n_child
        self.ccap = min(_bucket(n_child), pcap * 8)
        p_occ = p_occ.to(torch.int64)

        cc, octant, parent_idx, n = hostmap.expand_children(
            p_coords, p_occ, self.ccap)
        if n != n_child:
            raise ValueError(f"child count mismatch: {n} vs {n_child}")
        self.child_coords = cc  # decode output / next level's parents
        cpos = parent_idx.to(torch.int64) * 8 + octant
        cpos[n:] = 0
        self.cpos = cpos  # packed slot of each coded child
        self.inv = torch.zeros(pcap * 8, dtype=torch.int64, device=dev)
        self.inv[cpos[:n]] = torch.arange(n, device=dev)  # lex row per slot

        groups = hostmap.dedupe(p_coords >> 1)
        gpcap = _bucket(groups.shape[0])
        pos = sibconv.sib_pos(p_coords, groups)
        self.pocc = torch.zeros(gpcap * 8, dtype=torch.int64, device=dev)
        self.pocc[pos] = p_occ
        self.pmask = torch.zeros(gpcap * 8, dtype=torch.bool, device=dev)
        self.pmask[pos] = True
        self.ppos = torch.zeros(pcap, dtype=torch.int64, device=dev)
        self.ppos[:np_] = pos
        self.cmask8 = torch.zeros(pcap * 8, dtype=torch.bool, device=dev)
        bits = (p_occ[:, None] >> torch.arange(8, device=dev)[None, :]) & 1
        self.cmask8[: np_ * 8] = bits.bool().reshape(-1)

        if parent_gmapT is not None and parent_gmapT.shape[0] == gpcap:
            self.p_gmapT = parent_gmapT
        else:
            self.p_gmapT = _gmap(groups, gpcap)
        self.c_gmapT = _gmap(p_coords, pcap)


def _gmap(coords, cap):
    return hostmap.build_map(coords, coords.shape[0], 3, ncap=cap).T.contiguous()


def _context_sib(params, config, g: _SibLevelGeometry):
    return net.sib_context(params, config, g.pocc, g.pmask, g.p_gmapT, g.ppos,
                           g.c_gmapT, g.cmask8)


def _stage_cdf_sib(params, stage, cf, g: _SibLevelGeometry, prev_lex):
    """One stage's CDF tables in lex (coded) order [ccap, Lp], from the
    packed features and the earlier symbols in coded order."""
    probs = net.sib_stage_probs(params, stage, cf, g.c_gmapT, g.cmask8,
                                prev_lex[g.inv])
    return cdf_lib.probs_to_cdf_int16(probs[g.cpos])


def _encode_tables(params, g: _SibLevelGeometry, cf, gt_occ):
    """The four stage tables and symbols of one level from its context
    features, teacher-forced on the children's occupancy bytes gt_occ
    [n_child]: -> (tables, syms), lists over stages 0..3; symbols int32
    [ccap], 0 past n_child."""
    gt = torch.zeros(g.ccap, dtype=torch.int32, device=cf.device)
    gt[: g.n_child] = gt_occ.to(torch.int32)
    s_gt = net.split_occupancy(gt)
    prevs = [torch.zeros_like(gt), s_gt[0], s_gt[0] * 2 + s_gt[1],
             (s_gt[0] * 2 + s_gt[1]) * 4 + s_gt[2]]
    tables = [_stage_cdf_sib(params, stage, cf, g, prevs[stage])
              for stage in range(4)]
    return tables, [s.contiguous() for s in s_gt]


def _rans_encode_level(tables, syms, n_valid: int):
    """rANS over one level's stages 3..0 -> (words int32 [L, W], n_words)."""
    carry = rans.enc_init(tables[0].shape[0], device=tables[0].device)
    for stage in (3, 2, 1, 0):
        carry = rans.encode_stage(carry, tables[stage], syms[stage], n_valid)
    return rans.enc_flush(carry)


def _encode_levels_sib(levels, params, config: net.NetConfig, device,
                       profile: list | None = None):
    """Encoder core -> one packed stream per coded level."""
    pending = []
    carry_gmap = None
    for depth in range(len(levels) - 1):
        timer = _Timer(device) if profile is not None else None
        p_coords = torch.as_tensor(levels[depth][0], device=device)
        p_occ = torch.as_tensor(levels[depth][1].astype(np.int64), device=device)
        c_coords, c_occ = levels[depth + 1]
        g = _SibLevelGeometry(p_coords, p_occ, c_coords.shape[0],
                              parent_gmapT=carry_gmap)
        carry_gmap = g.c_gmapT
        # the coded symbols are indexed by the lex-sorted children: they
        # must be the next level's coords
        if not torch.equal(g.child_coords[: g.n_child],
                           torch.as_tensor(c_coords, device=device)):
            raise RuntimeError(f"children misaligned at depth {depth}")
        if timer:
            timer.mark("geometry")
        cf = _context_sib(params, config, g)
        if timer:
            timer.mark("context")
        tables, syms = _encode_tables(
            params, g, cf, torch.as_tensor(c_occ.astype(np.int32), device=device))
        if timer:
            timer.mark("cdf")
        pending.append(_rans_encode_level(tables, syms, g.n_child))
        if timer:
            timer.mark("rans")
            profile.append({"n_child": g.n_child, "ccap": g.ccap,
                            "timer": timer})
    if profile is not None:
        for lvl in profile:
            lvl.update(lvl.pop("timer").finish())
    return [rans.pack_stream(words.cpu().numpy(), n_words.cpu().numpy())
            for words, n_words in pending]


def _decode_levels_sib(base_coords, base_occ, payload: bytes, params,
                       config: net.NetConfig, device,
                       profile: list | None = None):
    """Decoder core -> (coords int64 [N, 3] on the host, N)."""
    streams = bitstream.unpack_byte_streams(payload)
    p_coords = torch.as_tensor(base_coords.astype(np.int64), device=device)
    p_occ = torch.as_tensor(base_occ.astype(np.int64), device=device)
    carry_gmap = None
    for stream in streams:
        timer = _Timer(device) if profile is not None else None
        n_child = int(_popcount(p_occ).sum())
        g = _SibLevelGeometry(p_coords, p_occ, n_child, parent_gmapT=carry_gmap)
        carry_gmap = g.c_gmapT
        w_np, _ = rans.unpack_stream(stream, rans.word_capacity(g.ccap))
        if w_np.shape[0] != rans.lane_count(g.ccap):
            raise ValueError(f"corrupt stream: {w_np.shape[0]} lanes at a "
                             f"level of capacity {g.ccap}")
        words = torch.as_tensor(w_np, device=device)
        if timer:
            timer.mark("geometry")
        cf = _context_sib(params, config, g)
        if timer:
            timer.mark("context")
        carry = rans.dec_init(words)
        prev = torch.zeros(g.ccap, dtype=torch.int32, device=device)
        for stage in range(4):
            table = _stage_cdf_sib(params, stage, cf, g, prev)
            carry, _, prev = rans.decode_stage(carry, table, words, n_child,
                                               prev, stage)
        if timer:
            timer.mark("cdf_and_rans")
            profile.append({"n_child": n_child, "ccap": g.ccap, "timer": timer})
        p_coords = g.child_coords[:n_child]
        p_occ = prev[:n_child].to(torch.int64)
    if profile is not None:
        for lvl in profile:
            lvl.update(lvl.pop("timer").finish())
    n_final = int(_popcount(p_occ).sum())
    cc, _, _, _ = hostmap.expand_children(p_coords, p_occ, n_final)
    return cc[:n_final].to(torch.int64).cpu().numpy(), n_final


def _popcount(occ: torch.Tensor) -> torch.Tensor:
    return ((occ.to(torch.int64)[:, None]
             >> torch.arange(8, device=occ.device)) & 1).sum(1)


def compress_point_cloud(xyz_quantized, params, output_path: str,
                         posQ: float = 1.0,
                         config: net.NetConfig = net.NetConfig(),
                         geom: str | None = None, device="cuda",
                         profile: list | None = None) -> dict:
    """Compress integer coords [N, 3] to `output_path`.

    params: a `GausPcgcNet` (the JAX package's weights carry over with
    `convert.codec_params_from_numpy`); it is moved to `device`, "cuda" by
    default. geom: "sib" (the default, the only engine ported). `profile`,
    when a list, gets one dict per level: n_child, ccap and the ms of its
    geometry, context, cdf and rans phases.
    Returns {bpp, enc_time, file_size_bits, num_points, output_path}."""
    if geom not in (None, "sib"):
        raise NotImplementedError(
            f"geom={geom!r}: only the sib engine is ported ({_LATER})")
    dev = resolve(device)
    params = params.to(dev)
    xyz = np.asarray(xyz_quantized)
    if posQ != 1.0:
        xyz = np.round(xyz / posQ)
    xyz = xyz.astype(np.int64)
    n_points = xyz.shape[0]

    t0 = time.time()
    shift = xyz.min(axis=0)
    xyz0 = sparse.dedupe_lex(xyz - shift)
    if xyz0.max() >= hostmap.MAX_COORD:
        raise ValueError(f"the cloud spans {int(xyz0.max()) + 1} voxels on an "
                         f"axis; the geometry's keys hold fewer than "
                         f"{hostmap.MAX_COORD}")
    levels = sparse.build_occupancy_pyramid(xyz0, min_points=MIN_BASE_POINTS,
                                            sorted_unique=True)
    with torch.no_grad(), _exact_gemms():
        streams = _encode_levels_sib(levels, params, config, dev, profile)
    base_coords, base_occ = levels[0]
    payload = bitstream.pack_byte_streams(streams)
    with open(output_path, "wb") as f:
        f.write(np.uint32(MAGIC).tobytes())
        f.write(np.uint8(VERSION_TORCH).tobytes())
        f.write(np.float16(posQ).tobytes())
        f.write(shift.astype(np.int32).tobytes())
        f.write(np.int32(base_coords.shape[0]).tobytes())
        f.write(base_coords.astype(np.int32).tobytes())
        f.write(base_occ.astype(np.uint8).tobytes())
        f.write(payload)
    enc_time = time.time() - t0

    fsb = bitstream.file_size_bits(output_path)
    return {"bpp": fsb / n_points, "enc_time": enc_time, "file_size_bits": fsb,
            "num_points": n_points, "output_path": output_path}


def decompress_point_cloud(bin_file_path: str, params,
                           config: net.NetConfig = net.NetConfig(),
                           profile: list | None = None,
                           device="cuda") -> dict:
    """Decode a .bin written by the port's `compress_point_cloud`.

    Returns {dec_time, num_points, point_cloud (float32 [N, 3])}. A stream
    of another version (the JAX package's 2, 3 or 4) raises: its tables
    came from another engine, and decoding it would give garbage."""
    dev = resolve(device)
    params = params.to(dev)
    with open(bin_file_path, "rb") as f:
        magic = np.frombuffer(f.read(4), np.uint32)[0]
        if magic != MAGIC:
            raise ValueError(f"{bin_file_path} is not a GPCT bitstream")
        version = int(np.frombuffer(f.read(1), np.uint8)[0])
        if version != VERSION_TORCH:
            raise ValueError(
                f"{bin_file_path} is a version {version} GPCT stream; this "
                f"decoder reads only version {VERSION_TORCH}, which the "
                f"PyTorch port writes (versions 2, 3 and 4 are the JAX "
                f"package's engines: decode them with gauspcc_tpu)")
        posQ = float(np.frombuffer(f.read(2), np.float16)[0])
        shift = np.frombuffer(f.read(12), np.int32).astype(np.int64)
        base_len = int(np.frombuffer(f.read(4), np.int32)[0])
        base_coords = np.frombuffer(f.read(base_len * 12), np.int32).reshape(-1, 3)
        base_occ = np.frombuffer(f.read(base_len), np.uint8)
        payload = f.read()

    t0 = time.time()
    with torch.no_grad(), _exact_gemms():
        cc, n_final = _decode_levels_sib(base_coords, base_occ, payload, params,
                                         config, dev, profile)
    pts = (cc + shift).astype(np.float32) * posQ
    return {"dec_time": time.time() - t0, "num_points": n_final,
            "point_cloud": pts}


def compress_point_cloud_batch(*args, **kwargs):
    """The JAX package's merged-pyramid batch encoder (codec.py:875)."""
    raise NotImplementedError(f"batch coding is not ported yet ({_LATER})")


def decompress_point_cloud_batch(*args, **kwargs):
    """The JAX package's batch decoder (codec.py:931)."""
    raise NotImplementedError(f"batch coding is not ported yet ({_LATER})")
