"""GausPcgc point-cloud geometry codec: the port's counterpart of
gauspcc_tpu/codecs/gauspcgc/codec.py (`_bucket` :120, `_pad_parents` :132,
`_stage_cdf` :154, `_LevelGeometry` :190, `_stage_cdf_sib` :262,
`_SibLevelGeometry` :275, `_encode_levels_sib` :358, `_decode_levels_sib`
:393, `_level_geometries` :450, `_encode_levels` :466, `_device_children`
:526 (`sparse.sorted_children`), `_device_levels` :537, `_encode_levels_device` :581,
`_decode_levels_device` :620, `compress_point_cloud` :658,
`decompress_point_cloud` :723, `_decode_levels` :765, `_merge_clouds` :853,
`compress_point_cloud_batch` :875, `decompress_point_cloud_batch` :931).

Quantized coords in, a self-contained .bin out, losslessly decodable with
the same network weights. The bitstream is the JAX package's framing:
  u32 magic 'GPCT' | u8 version | f16 posQ | i32[3] coord shift |
  i32 base_len | i32[base_len, 3] base coords | u8[base_len] base occ |
  [engine 7: u8 n_levels | i32[n_levels + 1] child counts] |
  framed per-level rANS streams (coarse to fine),
with the port's own version bytes, one an engine:
  5  the sib engine: sibling-packed convs over k=3 cell maps built in
     torch on the codec's device (ops/sibconv.py, ops/hostmap.py);
  6  the general submanifold conv (ops/sparse.py) over host-built
     geometry: the children and packed window maps built on the host (the
     native map code, csrc/neighbor.cpp) and shipped packed; a decoder reads
     each level's occupancy bytes back to build the next level's geometry;
  7  the general conv over device-built geometry (`fcg_expand`, `lex_sort`,
     `build_neighbor_map` on static shapes); the child counts ride in the
     header, so a decoder enqueues the whole pyramid and waits once, on the
     final coordinates.
A decoder reproduces the encoder's tables bit for bit only when it runs
the same operations on the same device type and dtype, so a stream
decodes only on the engine, device type and dtype that wrote it, and the
decoder refuses every other version. The batch entry points merge M clouds
into one pyramid under the magic 'GPCB' with the same version bytes.

Per level, coarse to fine: the geometry; the context conv stacks; four
stage tables; four rANS stages (ops/rans.py, the CUDA kernels on the
card). Encode teacher-forces the earlier bits from the ground truth and
runs stages 3..0; decode runs 0..3, each decoded stage feeding the next
stage's table. Both sides run the same torch operations on the same
shapes, with no atomics on the context path and cuBLAS's reduced-precision
reductions off, so their tables agree.
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
# the port's engines (the JAX package writes 2, 3 and 4): a version pins
# the engine, so a decoder runs the encoder's operations
VERSION_TORCH = 5  # the sib engine
VERSION_HOST = 6  # the general conv over host-built geometry (v2 framing)
VERSION_DEVICE = 7  # over device-built geometry (v3 framing: the counts)
MIN_BASE_POINTS = 64


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
    occupancy bytes. `parent` is the previous level's geometry: the groups
    of this level's parents are the previous level's parents (every voxel
    has a child), so its child-cell map is this level's parent-cell map.
    Each map is kept as gmapT [G, 27] and as the `sibconv.GroupMap` the
    network reads (`p_map`, `c_map`), converted once per level."""

    def __init__(self, p_coords, p_occ, n_child: int, parent=None):
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

        if parent is not None and parent.c_gmapT.shape[0] == gpcap:
            self.p_gmapT, self.p_map = parent.c_gmapT, parent.c_map
        else:
            self.p_gmapT = _gmap(groups, gpcap)
            self.p_map = sibconv.GroupMap(self.p_gmapT)
        self.c_gmapT = _gmap(p_coords, pcap)
        self.c_map = sibconv.GroupMap(self.c_gmapT)


def _gmap(coords, cap):
    return hostmap.build_map(coords, coords.shape[0], 3, ncap=cap).T.contiguous()


def _context_sib(params, config, g: _SibLevelGeometry):
    return net.sib_context(params, config, g.pocc, g.pmask, g.p_map, g.ppos,
                           g.c_map, g.cmask8)


def _stage_cdf_sib(params, stage, cf, g: _SibLevelGeometry, prev_lex):
    """One stage's CDF tables in lex (coded) order [ccap, Lp], from the
    packed features and the earlier symbols in coded order."""
    probs = net.sib_stage_probs(params, stage, cf, g.c_map, g.cmask8,
                                prev_lex[g.inv])
    return cdf_lib.probs_to_cdf_int16(probs[g.cpos])


def _encode_tables(params, g: _SibLevelGeometry, cf, gt_occ):
    """The four stage tables and symbols of one level from its context
    features, teacher-forced on the children's occupancy bytes gt_occ
    [n_child]: -> (tables, syms), lists over stages 0..3; symbols int32
    [ccap], 0 past n_child."""
    gt = torch.zeros(g.ccap, dtype=torch.int32, device=cf.device)
    gt[: g.n_child] = gt_occ.to(torch.int32)
    syms, prevs = _teacher_forced(gt)
    tables = [_stage_cdf_sib(params, stage, cf, g, prevs[stage])
              for stage in range(4)]
    return tables, syms


def _teacher_forced(gt: torch.Tensor):
    """The four stages' symbols of occupancy bytes gt int32 [ccap] and the
    earlier bits each stage is conditioned on: (syms, prevs)."""
    s = [t.contiguous() for t in net.split_occupancy(gt)]
    return s, [torch.zeros_like(gt), s[0], s[0] * 2 + s[1],
               (s[0] * 2 + s[1]) * 4 + s[2]]


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
    g = None
    for depth in range(len(levels) - 1):
        timer = _Timer(device) if profile is not None else None
        p_coords = torch.as_tensor(levels[depth][0], device=device)
        p_occ = torch.as_tensor(levels[depth][1].astype(np.int64), device=device)
        c_coords, c_occ = levels[depth + 1]
        g = _SibLevelGeometry(p_coords, p_occ, c_coords.shape[0], parent=g)
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
    _finish(profile)
    return [rans.pack_stream(words.cpu().numpy(), n_words.cpu().numpy())
            for words, n_words in pending]


def _decode_levels_sib(base_coords, base_occ, payload: bytes, params,
                       config: net.NetConfig, device,
                       profile: list | None = None):
    """Decoder core -> (coords int64 [N, 3] on the host, N)."""
    streams = bitstream.unpack_byte_streams(payload)
    p_coords = torch.as_tensor(base_coords.astype(np.int64), device=device)
    p_occ = torch.as_tensor(base_occ.astype(np.int64), device=device)
    g = None
    for stream in streams:
        timer = _Timer(device) if profile is not None else None
        n_child = int(_popcount(p_occ).sum())
        g = _SibLevelGeometry(p_coords, p_occ, n_child, parent=g)
        words = _level_words(stream, g.ccap, device)
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
    _finish(profile)
    n_final = int(_popcount(p_occ).sum())
    cc, _, _, _ = hostmap.expand_children(p_coords, p_occ, n_final)
    return cc[:n_final].to(torch.int64).cpu().numpy(), n_final


def _popcount(occ: torch.Tensor) -> torch.Tensor:
    return ((occ.to(torch.int64)[:, None]
             >> torch.arange(8, device=occ.device)) & 1).sum(1)



# ---------------------------------------------------------------------------
# the general conv's engines: version 6 (host-built geometry) and version 7
# (device-built geometry)
# ---------------------------------------------------------------------------

def _pad_parents(coords: np.ndarray, occ: np.ndarray, device):
    """Parents padded to their capacity, on `device`: (coords int32 [cap,
    3], occupancy int32 [cap], mask [cap])."""
    n = coords.shape[0]
    cap = _bucket(n)
    pc = np.zeros((cap, 3), np.int32)
    po = np.zeros(cap, np.int32)
    pc[:n] = coords
    po[:n] = occ
    return (_upload(pc, device), _upload(po, device),
            torch.arange(cap, device=device) < n)


def _upload(a: np.ndarray, device) -> torch.Tensor:
    """A host array on `device`. On the card, through pinned memory and a
    copy that does not make the host wait, so a decode that uploads every
    level's words synchronises only where it reads a result back."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class _LevelGeometry:
    """Host-built geometry of one level (version 6), shipped to the device.

    p_coords int [Np, 3] lex-sorted parents and p_occ [Np] on the host. The
    children come from `hostmap.expand_children` on the host; each voxel
    set's packed window map from the native map code (`hostmap
    .build_map_packed`), shipped as `sparse.pack_lo_np`'s u8-delta lo and
    u16 codes and expanded on the device (`sparse.expand_lo`). `parent_map`
    is the previous level's child map, reused when its capacity is this
    level's parent capacity. `prof`, a dict, gathers host_ms (the native
    map code and the packing) and map_bytes (what crosses to the device)."""

    def __init__(self, p_coords, p_occ, n_child: int, kernel_size: int,
                 device, parent_map=None, prof=None):
        np_ = p_coords.shape[0]
        pcap = _bucket(np_)
        self.n_parents = np_
        self.n_child = n_child
        self.ccap = min(_bucket(n_child), pcap * 8)
        self.prof = prof
        po = np.zeros(pcap, np.int32)
        po[:np_] = p_occ
        self.po = _upload(po, device)
        self.pm = torch.arange(pcap, device=device) < np_

        cc, octant, parent_idx, n = hostmap.expand_children(
            torch.from_numpy(np.asarray(p_coords, np.int32)),
            torch.from_numpy(np.asarray(p_occ, np.int64)), self.ccap)
        if n != n_child:
            raise ValueError(f"child count mismatch: {n} vs {n_child}")
        self.child_coords = cc.numpy()  # host: decode output, next parents
        self.octant = _upload(octant.numpy(), device)
        self.parent_idx = _upload(parent_idx.numpy(), device)
        self.child_mask = torch.arange(self.ccap, device=device) < n_child
        if parent_map is not None:
            self.p_map = parent_map
        else:
            self.p_map = self._upload_map(p_coords, np_, kernel_size, pcap, device)
        self.c_map = self._upload_map(self.child_coords, n_child, kernel_size,
                                      self.ccap, device)

    def _upload_map(self, coords, n_valid, kernel_size, cap, device):
        t0 = time.perf_counter()
        lo, codes = hostmap.build_map_packed(coords, n_valid, kernel_size, cap)
        packed = sparse.pack_lo_np(lo)
        if self.prof is not None:
            self.prof["host_ms"] = (self.prof.get("host_ms", 0.0)
                                    + (time.perf_counter() - t0) * 1e3)
            self.prof["map_bytes"] = (self.prof.get("map_bytes", 0)
                                      + sum(a.nbytes for a in packed) + codes.nbytes)
        lo_dev = sparse.expand_lo(
            sparse.PackedLo(*(_upload(a, device) for a in packed)), cap)
        codes_dev = _upload(codes.view(np.int16), device).to(torch.int32) & 0xFFFF
        return sparse.WindowMap(lo_dev, codes_dev)


def _level_geometries(levels, kernel_size: int, device, profile=None):
    """The version-6 geometry of every coded level, coarse to fine, built
    as it is taken: level d's child map is level d+1's parent map when the
    capacities agree. `profile`, a list, gets each level's `prof` dict."""
    g = None
    for depth in range(len(levels) - 1):
        p_coords, p_occ = levels[depth]
        reuse = g.c_map if g is not None and g.ccap == _bucket(p_coords.shape[0]) else None
        prof = {} if profile is not None else None
        g = _LevelGeometry(p_coords, p_occ, levels[depth + 1][0].shape[0],
                           kernel_size, device, parent_map=reuse, prof=prof)
        if profile is not None:
            profile.append(prof)
        yield g


def _context_general(params, config, geom: dict):
    """The context program both sides of engines 6 and 7 run -> (features
    [ccap, C], the children's dense map, expanded once for the level)."""
    k = config.kernel_size
    c_map = net._as_dense_map(geom["c_map"], k)
    feats = net.level_context_packed(
        params, config, geom["po"], geom["pm"],
        net._as_dense_map(geom["p_map"], k), geom["octant"],
        geom["parent_idx"], geom["child_mask"], c_map)
    return feats, c_map


def _stage_cdf(params, stage, feats, c_map, prev):
    """One stage's CDF tables [ccap, Lp] in lex (coded) order."""
    return cdf_lib.probs_to_cdf_int16(
        net.stage_probs(params, stage, feats, c_map, prev))


def _encode_general_level(params, config, geom: dict, gt: torch.Tensor,
                          timer) -> tuple:
    """Context, the four teacher-forced stage tables and rANS of one level
    of the general conv; gt int32 [ccap] (0 past n_child). -> (words,
    n_words) on the device."""
    feats, c_map = _context_general(params, config, geom)
    if timer:
        timer.mark("context")
    syms, prevs = _teacher_forced(gt)
    tables = [_stage_cdf(params, stage, feats, c_map, prevs[stage])
              for stage in range(4)]
    if timer:
        timer.mark("cdf")
    out = _rans_encode_level(tables, syms, geom["n_child"])
    if timer:
        timer.mark("rans")
    return out


def _decode_general_level(params, config, geom: dict, words: torch.Tensor,
                          timer) -> torch.Tensor:
    """The decoder's side of `_encode_general_level`: the same context and
    tables, rANS stages 0..3 -> the children's occupancy bytes int32 [ccap]
    on the device."""
    feats, c_map = _context_general(params, config, geom)
    if timer:
        timer.mark("context")
    carry = rans.dec_init(words)
    prev = torch.zeros(geom["ccap"], dtype=torch.int32, device=words.device)
    for stage in range(4):
        table = _stage_cdf(params, stage, feats, c_map, prev)
        carry, _, prev = rans.decode_stage(carry, table, words,
                                           geom["n_child"], prev, stage)
    if timer:
        timer.mark("cdf_and_rans")
    return prev


def _host_geom(g: _LevelGeometry) -> dict:
    return {"po": g.po, "pm": g.pm, "p_map": g.p_map, "octant": g.octant,
            "parent_idx": g.parent_idx, "child_mask": g.child_mask,
            "c_map": g.c_map, "n_child": g.n_child, "ccap": g.ccap}


def _finish(profile) -> None:
    """Each level's phase times into its profile entry, in place of its
    timer (one wait, at the end)."""
    for lvl in profile or ():
        lvl.update(lvl.pop("timer").finish())


def _encode_levels(levels, params, config: net.NetConfig, device,
                   profile: list | None = None):
    """Engine 6's encoder core -> one packed stream per coded level. Every
    level is enqueued (teacher-forced: nothing waits on a coded bit), then
    the word buffers are read back."""
    pending = []
    geo_prof = [] if profile is not None else None
    geos = _level_geometries(levels, config.kernel_size, device, geo_prof)
    for depth in range(len(levels) - 1):
        timer = _Timer(device) if profile is not None else None
        g = next(geos)
        c_coords, c_occ = levels[depth + 1]
        # the coded symbols are indexed by the host's lex-sorted children
        if not np.array_equal(g.child_coords[: g.n_child], c_coords):
            raise RuntimeError(f"children misaligned at depth {depth}")
        if timer:
            timer.mark("geometry")
        gt = np.zeros(g.ccap, np.int32)
        gt[: g.n_child] = c_occ
        pending.append(_encode_general_level(params, config, _host_geom(g),
                                             _upload(gt, device), timer))
        if profile is not None:
            profile.append({"n_child": g.n_child, "ccap": g.ccap,
                            **geo_prof[depth], "timer": timer})
    _finish(profile)
    return [rans.pack_stream(words.cpu().numpy(), n_words.cpu().numpy())
            for words, n_words in pending]


def _decode_levels(base_coords, base_occ, payload: bytes, params,
                   config: net.NetConfig, device, profile: list | None = None):
    """Engine 6's decoder core -> (coords int64 [N, 3] on the host, N). Each
    level's geometry is built on the host from the decoded parents, so each
    level reads its occupancy bytes back once."""
    streams = bitstream.unpack_byte_streams(payload)
    p_coords = base_coords.astype(np.int32)
    p_occ = base_occ.astype(np.int32)
    g = None
    for stream in streams:
        timer = _Timer(device) if profile is not None else None
        n_child = int(np.unpackbits(p_occ.astype(np.uint8)[:, None], axis=1).sum())
        reuse = g.c_map if g is not None and g.ccap == _bucket(p_coords.shape[0]) else None
        prof = {} if profile is not None else None
        g = _LevelGeometry(p_coords, p_occ, n_child, config.kernel_size,
                           device, parent_map=reuse, prof=prof)
        words = _level_words(stream, g.ccap, device)
        if timer:
            timer.mark("geometry")
        prev = _decode_general_level(params, config, _host_geom(g), words, timer)
        p_coords = g.child_coords[:n_child]
        p_occ = prev[:n_child].cpu().numpy()
        if profile is not None:
            profile.append({"n_child": n_child, "ccap": g.ccap, **prof,
                            "timer": timer})
    _finish(profile)
    n_final = int(np.unpackbits(p_occ.astype(np.uint8)[:, None], axis=1).sum())
    cc, _, _, _ = hostmap.expand_children(
        torch.from_numpy(p_coords), torch.from_numpy(p_occ.astype(np.int64)),
        n_final)
    return cc[:n_final].to(torch.int64).numpy(), n_final


def _level_words(stream: bytes, ccap: int, device) -> torch.Tensor:
    w_np, _ = rans.unpack_stream(stream, rans.word_capacity(ccap))
    if w_np.shape[0] != rans.lane_count(ccap):
        raise ValueError(f"corrupt stream: {w_np.shape[0]} lanes at a level "
                         f"of capacity {ccap}")
    return _upload(w_np, device)


def _device_levels(counts, base_coords, base_occ, config, device):
    """Generator of engine 7's coarse-to-fine sweep: yields (depth, geom)
    per coded level; the caller sends back the level's child occupancy
    int32 [ccap] (the ground truth when encoding, the decoded bytes when
    decoding), which becomes the next level's parent occupancy. counts[d]
    = level d's valid children, from the header on the decoder's side, so
    every capacity is known on the host. Finally yields (-1, the last
    parents)."""
    k = config.kernel_size
    p_coords, p_occ, p_mask = _pad_parents(base_coords, base_occ, device)
    pcap = p_coords.shape[0]
    p_map = sparse.build_neighbor_map(p_coords, p_mask, p_coords, p_mask, k)
    for depth, n_child in enumerate(counts):
        ccap = min(_bucket(int(n_child)), pcap * 8)
        child, cm, octant, pidx = sparse.sorted_children(p_coords, p_occ,
                                                         p_mask, ccap)
        c_map = sparse.build_neighbor_map(child, cm, child, cm, k)
        geom = {"po": p_occ, "pm": p_mask, "p_map": p_map, "octant": octant,
                "parent_idx": pidx, "child_mask": cm, "c_map": c_map,
                "n_child": int(n_child), "ccap": ccap}
        child_occ = yield depth, geom
        p_coords, p_occ, p_mask = child, child_occ, cm
        p_map, pcap = c_map, ccap
    yield -1, {"p_coords": p_coords, "p_occ": p_occ, "p_mask": p_mask,
               "pcap": pcap}


def _encode_levels_device(levels, params, config: net.NetConfig, device,
                          profile: list | None = None):
    """Engine 7's encoder core -> (streams, counts): counts[d] = level d's
    children, counts[-1] = the final point count."""
    counts = [lv[0].shape[0] for lv in levels[1:]]
    n_final = int(np.unpackbits(levels[-1][1].astype(np.uint8)[:, None],
                                axis=1).sum())
    gen = _device_levels(counts, *levels[0], config, device)
    pending = []
    send = None
    while True:
        timer = _Timer(device) if profile is not None else None
        depth, geom = gen.send(send)
        if depth < 0:
            break
        if timer:
            timer.mark("geometry")
        gt = np.zeros(geom["ccap"], np.int32)
        gt[: geom["n_child"]] = levels[depth + 1][1]
        send = _upload(gt, device)
        pending.append(_encode_general_level(params, config, geom, send, timer))
        if profile is not None:
            profile.append({"n_child": geom["n_child"], "ccap": geom["ccap"],
                            "timer": timer})
    _finish(profile)
    streams = [rans.pack_stream(words.cpu().numpy(), n_words.cpu().numpy())
               for words, n_words in pending]
    return streams, counts + [n_final]


def _decode_levels_device(base_coords, base_occ, payload: bytes, counts,
                          params, config: net.NetConfig, device,
                          profile: list | None = None):
    """Engine 7's decoder core -> (coords int64 [N, 3] on the host, N). The
    counts come from the header, so the whole pyramid is enqueued without
    reading anything back; the host waits once, on the final coordinates."""
    streams = bitstream.unpack_byte_streams(payload)
    if len(counts) != len(streams) + 1:
        raise ValueError(f"corrupt stream: {len(counts)} counts for "
                         f"{len(streams)} levels")
    gen = _device_levels(counts[:-1], base_coords.astype(np.int32),
                         base_occ.astype(np.int32), config, device)
    send = None
    while True:
        timer = _Timer(device) if profile is not None else None
        depth, geom = gen.send(send)
        if depth < 0:
            break
        words = _level_words(streams[depth], geom["ccap"], device)
        if timer:
            timer.mark("geometry")
        send = _decode_general_level(params, config, geom, words, timer)
        if profile is not None:
            profile.append({"n_child": geom["n_child"], "ccap": geom["ccap"],
                            "timer": timer})
    n_final = int(counts[-1])
    fcap = min(_bucket(n_final), geom["pcap"] * 8)
    child, _, _, _ = sparse.sorted_children(geom["p_coords"], geom["p_occ"],
                                            geom["p_mask"], fcap)
    cc = child[:n_final].to(torch.int64).cpu().numpy()
    _finish(profile)
    return cc, n_final


ENGINES = {"sib": VERSION_TORCH, "host": VERSION_HOST, "device": VERSION_DEVICE}


def _engine(geom: str | None) -> str:
    geom = geom or "sib"
    if geom not in ENGINES:
        raise ValueError(f"geom={geom!r}: the engines are {sorted(ENGINES)}")
    return geom


def _check_span(coords: np.ndarray, what: str) -> None:
    if coords.max() >= hostmap.MAX_COORD:
        raise ValueError(f"{what} spans {int(coords.max()) + 1} voxels on an "
                         f"axis; the geometry's keys hold fewer than "
                         f"{hostmap.MAX_COORD}")


def _encode_pyramid(levels, params, config, geom: str, dev, profile):
    """The engine's encoder core -> (streams, the header's per-level counts
    (engine 7) or None)."""
    if geom == "device":
        return _encode_levels_device(levels, params, config, dev, profile)
    enc = _encode_levels if geom == "host" else _encode_levels_sib
    return enc(levels, params, config, dev, profile), None


def _write_pyramid(f, levels, counts, streams) -> None:
    base_coords, base_occ = levels[0]
    f.write(np.int32(base_coords.shape[0]).tobytes())
    f.write(base_coords.astype(np.int32).tobytes())
    f.write(base_occ.astype(np.uint8).tobytes())
    if counts is not None:
        f.write(np.uint8(len(counts) - 1).tobytes())
        f.write(np.asarray(counts, np.int32).tobytes())
    f.write(bitstream.pack_byte_streams(streams))


def _read_version(f, path: str, magic_want: int, kind: str) -> int:
    magic = np.frombuffer(f.read(4), np.uint32)[0]
    if magic != magic_want:
        raise ValueError(f"{path} is not a {kind} bitstream")
    version = int(np.frombuffer(f.read(1), np.uint8)[0])
    if version not in ENGINES.values():
        raise ValueError(
            f"{path} is a version {version} {kind} stream; this decoder reads "
            f"only version 5 (the sib engine), 6 (the general conv over "
            f"host-built geometry) and 7 (over device-built geometry), which "
            f"the PyTorch port writes (versions 2, 3 and 4 are the JAX "
            f"package's engines: decode them with gauspcc_tpu)")
    return version


def _read_pyramid(f, version: int):
    base_len = int(np.frombuffer(f.read(4), np.int32)[0])
    base_coords = np.frombuffer(f.read(base_len * 12), np.int32).reshape(-1, 3)
    base_occ = np.frombuffer(f.read(base_len), np.uint8)
    counts = None
    if version == VERSION_DEVICE:
        n_levels = int(np.frombuffer(f.read(1), np.uint8)[0])
        counts = np.frombuffer(f.read(4 * (n_levels + 1)), np.int32)
    return base_coords, base_occ, counts, f.read()


def _decode_pyramid(version, base_coords, base_occ, counts, payload, params,
                    config, dev, profile):
    """The version's decoder core -> (coords int64 [N, 3] on the host, N)."""
    if version == VERSION_DEVICE:
        return _decode_levels_device(base_coords, base_occ, payload, counts,
                                     params, config, dev, profile)
    dec = _decode_levels if version == VERSION_HOST else _decode_levels_sib
    return dec(base_coords, base_occ, payload, params, config, dev, profile)


def compress_point_cloud(xyz_quantized, params, output_path: str,
                         posQ: float = 1.0,
                         config: net.NetConfig = net.NetConfig(),
                         geom: str | None = None, device="cuda",
                         profile: list | None = None) -> dict:
    """Compress integer coords [N, 3] to `output_path`.

    params: a `GausPcgcNet` (the JAX package's weights carry over with
    `convert.codec_params_from_numpy`); it is moved to `device`, "cuda" by
    default. geom: the engine, "sib" (None; version 5), "host" (the
    general conv over host-built geometry, version 6) or "device" (over
    device-built geometry, version 7). `profile`, when a list, gets one
    dict per level: n_child, ccap and the ms of its phases (engine 6 also
    its host_ms and map_bytes).
    Returns {bpp, enc_time, file_size_bits, num_points, output_path}."""
    geom = _engine(geom)
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
    _check_span(xyz0, "the cloud")
    levels = sparse.build_occupancy_pyramid(xyz0, min_points=MIN_BASE_POINTS,
                                            sorted_unique=True)
    with torch.no_grad(), _exact_gemms():
        streams, counts = _encode_pyramid(levels, params, config, geom, dev,
                                          profile)
    with open(output_path, "wb") as f:
        f.write(np.uint32(MAGIC).tobytes())
        f.write(np.uint8(ENGINES[geom]).tobytes())
        f.write(np.float16(posQ).tobytes())
        f.write(shift.astype(np.int32).tobytes())
        _write_pyramid(f, levels, counts, streams)
    enc_time = time.time() - t0

    fsb = bitstream.file_size_bits(output_path)
    return {"bpp": fsb / n_points, "enc_time": enc_time, "file_size_bits": fsb,
            "num_points": n_points, "output_path": output_path}


def decompress_point_cloud(bin_file_path: str, params,
                           config: net.NetConfig = net.NetConfig(),
                           profile: list | None = None,
                           device="cuda") -> dict:
    """Decode a .bin written by the port's `compress_point_cloud`, with the
    engine its version byte names (5, 6 or 7).

    Returns {dec_time, num_points, point_cloud (float32 [N, 3])}. Any other
    version raises (the JAX package's 2, 3 and 4 too): its tables came
    from another engine, and decoding it would give garbage."""
    dev = resolve(device)
    params = params.to(dev)
    with open(bin_file_path, "rb") as f:
        version = _read_version(f, bin_file_path, MAGIC, "GPCT")
        posQ = float(np.frombuffer(f.read(2), np.float16)[0])
        shift = np.frombuffer(f.read(12), np.int32).astype(np.int64)
        pyramid = _read_pyramid(f, version)

    t0 = time.time()
    with torch.no_grad(), _exact_gemms():
        cc, n_final = _decode_pyramid(version, *pyramid, params, config, dev,
                                      profile)
    pts = (cc + shift).astype(np.float32) * posQ
    return {"dec_time": time.time() - t0, "num_points": n_final,
            "point_cloud": pts}


# ---------------------------------------------------------------------------
# merged-pyramid batch coding
# ---------------------------------------------------------------------------
#
# M clouds become one pyramid: cloud i is shifted by i << L along z (L the
# dyadic extent of the largest cloud), so the clouds occupy disjoint
# dyadic blocks at every level, no conv window crosses two clouds, and one
# pass of per-level programs codes them all.

BATCH_MAGIC = 0x47504342  # 'GPCB'


def _merge_clouds(clouds, posQ: float):
    """-> (merged int32 [N, 3], shifts [M, 3], unique counts [M], L)."""
    shifted, shifts, counts = [], [], []
    for xyz in clouds:
        xyz = np.asarray(xyz)
        if posQ != 1.0:
            xyz = np.round(xyz / posQ)
        xyz = xyz.astype(np.int64)
        s = xyz.min(axis=0)
        shifts.append(s)
        uniq = sparse.dedupe_lex(xyz - s)
        counts.append(uniq.shape[0])  # decoded (lossless) = unique voxels
        shifted.append(uniq)
    span = max(int(c.max()) + 1 for c in shifted)
    lbits = max(1, int(np.ceil(np.log2(span))))
    merged = np.concatenate([c + np.array([0, 0, i << lbits], np.int64)
                             for i, c in enumerate(shifted)])
    _check_span(merged, f"the merged batch of {len(clouds)} clouds")
    return (merged.astype(np.int32), np.stack(shifts),
            np.asarray(counts, np.int64), lbits)


def compress_point_cloud_batch(clouds, params, output_path: str,
                               posQ: float = 1.0,
                               config: net.NetConfig = net.NetConfig(),
                               geom: str | None = None, device="cuda",
                               profile: list | None = None) -> dict:
    """Compress M quantized clouds into one merged batch stream (magic
    'GPCB', the engine's version byte); `geom` as in `compress_point_cloud`.
    Returns {bpp, enc_time, file_size_bits, num_points, num_clouds,
    output_path}; decode with `decompress_point_cloud_batch`."""
    geom = _engine(geom)
    dev = resolve(device)
    params = params.to(dev)
    t0 = time.time()
    merged, shifts, counts, lbits = _merge_clouds(clouds, posQ)
    levels = sparse.build_occupancy_pyramid(merged, min_points=MIN_BASE_POINTS)
    with torch.no_grad(), _exact_gemms():
        streams, lvl_counts = _encode_pyramid(levels, params, config, geom, dev,
                                              profile)
    m = len(clouds)
    with open(output_path, "wb") as f:
        f.write(np.uint32(BATCH_MAGIC).tobytes())
        f.write(np.uint8(ENGINES[geom]).tobytes())
        f.write(np.float16(posQ).tobytes())
        f.write(np.int32([m, lbits]).tobytes())
        f.write(shifts.astype(np.int32).tobytes())
        f.write(counts.astype(np.int64).tobytes())
        _write_pyramid(f, levels, lvl_counts, streams)
    enc_time = time.time() - t0
    n_points = int(counts.sum())
    fsb = bitstream.file_size_bits(output_path)
    return {"bpp": fsb / n_points, "enc_time": enc_time, "file_size_bits": fsb,
            "num_points": n_points, "num_clouds": m, "output_path": output_path}


def decompress_point_cloud_batch(bin_file_path: str, params,
                                 config: net.NetConfig = net.NetConfig(),
                                 profile: list | None = None,
                                 device="cuda") -> dict:
    """Decode a batch stream -> {dec_time, num_points, point_clouds: float32
    [Ni, 3] each}. The clouds are split by z >> L; a cloud whose count
    disagrees with the header's raises."""
    dev = resolve(device)
    params = params.to(dev)
    with open(bin_file_path, "rb") as f:
        version = _read_version(f, bin_file_path, BATCH_MAGIC, "GPCB")
        posQ = float(np.frombuffer(f.read(2), np.float16)[0])
        m, lbits = (int(v) for v in np.frombuffer(f.read(8), np.int32))
        shifts = np.frombuffer(f.read(12 * m), np.int32).reshape(m, 3)
        counts = np.frombuffer(f.read(8 * m), np.int64)
        pyramid = _read_pyramid(f, version)

    t0 = time.time()
    with torch.no_grad(), _exact_gemms():
        cc, n_final = _decode_pyramid(version, *pyramid, params, config, dev,
                                      profile)
    cloud_id = cc[:, 2] >> lbits
    local = cc.copy()
    local[:, 2] -= cloud_id << lbits
    clouds = []
    for i in range(m):
        sel = local[cloud_id == i] + shifts[i].astype(np.int64)
        if sel.shape[0] != counts[i]:
            raise ValueError(f"{bin_file_path}: cloud {i} decoded "
                             f"{sel.shape[0]} points, its header says {counts[i]}")
        clouds.append(sel.astype(np.float32) * posQ)
    return {"dec_time": time.time() - t0, "num_points": n_final,
            "point_clouds": clouds}
