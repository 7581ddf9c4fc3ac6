"""Lane-interleaved rANS: the port's counterpart of gauspcc_tpu/ops/rans.py
(`lane_count` :37 .. `unpack_stream` :199), with hand-written CUDA
kernels for the two scans (`csrc/rans.cu`).

L independent streams advance in lockstep; position pos = t*L + lane, so
step t of every lane reads one contiguous block of table rows. 16-bit
probabilities (the normalized CDF rows of core/cdf.py), a state in [2^16,
2^32), at most one 16-bit word renormalized per symbol. Encode walks the
steps in reverse and pushes words per lane; `pack_stream` reverses each
lane's words so decode reads forward, the first two words being the
flushed state. Positions >= n_valid are skipped by both sides. The
bitstream depends on L, which `lane_count` fixes from the capacity.

Carries: encode (state int64 [L], n_words int32 [L], words int32 [L, W]);
decode (state int64 [L], ptr int32 [L]). The state is u32 arithmetic held
in int64 and masked (torch has no usable uint32 on the CPU); words hold
uint16 values in int32. Tables are int32 [cap, Lp] (core/cdf.py).

`encode_stage` and `decode_stage` launch the kernels for CUDA tensors and
raise if they cannot; they take the plain versions (`*_reference`, a loop
over steps vectorised over lanes) only for CPU tensors. The plain versions
are also what the kernels are held against on the card. The kernels stage
each step's rows and symbols in a shared-memory ring ahead of the lanes'
chains (`csrc/rans.cu`); `search_by_compares`, `divide_by_reciprocal`,
`ring_plan` and `ring_walk` replay their search, their division and their
ring's indexing on the host for the CPU tests, and run on no coding path.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from gauspcc_tpu_torch import native

U16 = 0xFFFF
U32 = 0xFFFFFFFF

# Launches of the encode and decode kernels (one per `encode_stage` /
# `decode_stage` call on CUDA tensors). Callers reset them to 0 to count
# the launches of one run.
encode_launches = 0
decode_launches = 0


def lane_count(cap: int) -> int:
    """Lanes for a position capacity; divides cap."""
    if cap >= 16384:
        return 128
    return max(8, cap // 128)


def word_capacity(cap: int, n_stages: int = 4) -> int:
    """Most words one lane can emit: one per symbol, plus 2 flush words."""
    return n_stages * (cap // lane_count(cap)) + 2


def enc_init(cap: int, n_stages: int = 4, device="cpu"):
    lanes = lane_count(cap)
    return (torch.full((lanes,), 1 << 16, dtype=torch.int64, device=device),
            torch.zeros(lanes, dtype=torch.int32, device=device),
            torch.zeros((lanes, word_capacity(cap, n_stages)),
                        dtype=torch.int32, device=device))


def _row_freq(rows: torch.Tensor, s: torch.Tensor):
    """(cdf_lo, freq) of symbol s in each row; mod-2^16 subtraction makes
    freq right at the wrapped last column."""
    lo = rows.gather(1, s[:, None])[:, 0]
    hi = rows.gather(1, s[:, None] + 1)[:, 0]
    return lo, (hi - lo) & U16


def _check(table, vec, name, n_valid):
    if table.dim() != 2 or table.dtype != torch.int32:
        raise ValueError(f"table: expected int32 [cap, Lp], got {table.dtype} "
                         f"{tuple(table.shape)}")
    if table.shape[1] < 3:
        raise ValueError(f"table has {table.shape[1]} columns; a row codes at "
                         "least 2 symbols")
    if vec is not None and (vec.dtype != torch.int32
                            or tuple(vec.shape) != (table.shape[0],)):
        raise ValueError(f"{name}: expected int32 [{table.shape[0]}], got "
                         f"{vec.dtype} {tuple(vec.shape)}")
    if not 0 <= n_valid <= table.shape[0]:
        raise ValueError(f"n_valid {n_valid} outside [0, {table.shape[0]}]")


def encode_stage_reference(carry, table: torch.Tensor, syms: torch.Tensor,
                           n_valid: int):
    """Plain version of `encode_stage`, on any device."""
    state, n_words, words = carry
    state, n_words, words = state.clone(), n_words.clone(), words.clone()
    lanes = state.shape[0]
    steps = table.shape[0] // lanes
    lp = table.shape[1]
    table = table.to(torch.int64)
    lane = torch.arange(lanes, device=state.device)
    for t in range(steps - 1, -1, -1):
        rows = table[t * lanes:(t + 1) * lanes]
        s = syms[t * lanes:(t + 1) * lanes].to(torch.int64).clamp(0, lp - 2)
        lo, freq = _row_freq(rows, s)
        valid = t * lanes + lane < n_valid
        need = (state >= (freq << 16)) & valid
        # emit at each lane's cursor; a lane with nothing to emit writes its
        # cursor's word back unchanged
        col = n_words.to(torch.int64)[:, None]
        old = words.gather(1, col)[:, 0]
        words.scatter_(1, col, torch.where(need, state & U16, old)[:, None]
                       .to(torch.int32))
        n_words += need.to(torch.int32)
        state = torch.where(need, state >> 16, state)
        f = torch.where(valid, freq, 1)
        new_state = (((state // f) << 16) + state % f + lo) & U32
        state = torch.where(valid, new_state, state)
    return state, n_words, words


def decode_stage_reference(carry, table: torch.Tensor, words: torch.Tensor,
                           n_valid: int):
    """Plain version of the symbol scan of `decode_stage`, on any device:
    -> ((state, ptr), syms int32 [cap]), syms 0 past n_valid."""
    state, ptr = carry
    lanes = state.shape[0]
    cap, lp = table.shape
    steps = cap // lanes
    table = table.to(torch.int64)
    w_cap = words.shape[1]
    lane = torch.arange(lanes, device=state.device)
    out = torch.zeros(cap, dtype=torch.int32, device=state.device)
    for t in range(steps):
        rows = table[t * lanes:(t + 1) * lanes]
        valid = t * lanes + lane < n_valid
        slot = state & U16
        # s = #{j in [1, Lp-2] : cdf[j] <= slot} (the last column wraps to
        # 0 and is excluded; column 0 is always 0)
        s = (rows[:, 1:lp - 1] <= slot[:, None]).sum(1)
        lo, freq = _row_freq(rows, s)
        new_state = (freq * (state >> 16) + slot - lo) & U32
        need = (new_state < (1 << 16)) & valid
        w = words.gather(1, ptr.to(torch.int64).clamp(0, w_cap - 1)[:, None])[:, 0]
        new_state = torch.where(need, ((new_state << 16) | w) & U32, new_state)
        state = torch.where(valid, new_state, state)
        ptr = ptr + need.to(torch.int32)
        out[t * lanes:(t + 1) * lanes] = torch.where(valid, s, 0).to(torch.int32)
    return (state, ptr), out


def search_by_compares(rows: torch.Tensor, slot: torch.Tensor):
    """The decode kernel's search (`csrc/rans.cu` `decode_symbol`) replayed:
    rows int [N, Lp], slot [N] -> (s, lo, hi) from compares, selects, a
    max, a min and a count, no indexed read; at Lp 17 three compares first
    pick the group of 4 columns that holds the slot. On rows nondecreasing
    over columns 0..Lp-2 it gives the counting search's s, lo = row[s] and
    (hi - lo) & 0xFFFF = the symbol's freq; hi is the wrapped last column
    plus 2^16 where no entry lies above the slot."""
    rows = rows.to(torch.int64)
    slot = slot.to(torch.int64)[:, None]
    lp = rows.shape[1]
    e = torch.cat([rows[:, :lp - 1], rows[:, lp - 1:] + (1 << 16)], 1)
    s = torch.zeros_like(slot[:, 0])
    if lp == 17:  # the group of 4 columns that holds the slot, by selects
        p1, p2, p3 = (rows[:, j:j + 1] <= slot for j in (4, 8, 12))
        a = torch.where(p1, e[:, 4:9], e[:, 0:5])
        b = torch.where(p3, e[:, 12:17], e[:, 8:13])
        e = torch.where(p2, b, a)
        s = 4 * (p1.long() + p2.long() + p3.long())[:, 0]
    c = e[:, 1:-1]
    le = c <= slot
    s = s + le.sum(1)
    lo = torch.maximum(e[:, 0], torch.where(le, c, 0).amax(1))
    hi = torch.minimum(e[:, -1], torch.where(le, U32, c).amin(1))
    return s, lo, hi


def divide_by_reciprocal(x: np.ndarray, freq: np.ndarray):
    """The encode kernel's division (`csrc/rans.cu` `encode_symbol`)
    replayed on uint64 arrays: with m = (2^32 - 1) // freq taken ahead of
    the chain, q = (x * m) >> 32 is x // freq or one less for any x below
    2^32 and freq >= 1, so one correction gives -> (x // freq, x % freq)."""
    x = x.astype(np.uint64)
    freq = freq.astype(np.uint64)
    m = np.uint64(U32) // freq
    q = (x * m) >> np.uint64(32)
    r = x - q * freq
    over = r >= freq
    return q + over, np.where(over, r - freq, r)


# The kernels' ring, mirrored from csrc/rans.cu for `ring_plan`.
ENCODE_CHUNK = 32  # kEncodeChunk: steps an encode slot holds, at most
DECODE_CHUNK = 32  # kDecodeChunk
RING_MAX_SLOTS = 8  # kMaxSlots
SMEM_LIMIT = 232448  # kSmemLimit: a block's dynamic shared memory on sm_90
RING_FIXED_BYTES = 2 * RING_MAX_SLOTS * 8  # the slots' mbarriers
WORD_RING_BYTES = 128 * 129 * 4  # decode: a ring of 128 words a lane, stride 129


def ring_plan(lanes: int, lp: int, encode: bool):
    """(chunk, slots, shared bytes) of one kernel launch, as csrc/rans.cu's
    `plan`: a step holds L rows of Lp entries and L symbols (encode) or L
    prev values (decode); slots halve until 3 (encode) or 2 (decode) fit."""
    step_bytes = 4 * lanes * (lp + 1)
    fixed = RING_FIXED_BYTES + (0 if encode else WORD_RING_BYTES)
    room = SMEM_LIMIT - fixed
    chunk = ENCODE_CHUNK if encode else DECODE_CHUNK
    min_slots = 3 if encode else 2
    while chunk > 1 and room // (chunk * step_bytes) < min_slots:
        chunk //= 2
    slots = min(RING_MAX_SLOTS, room // (chunk * step_bytes))
    if slots < 2:
        raise ValueError(f"{lanes} lanes of {lp} columns do not fit a ring")
    return chunk, slots, fixed + slots * chunk * step_bytes


def ring_walk(cap: int, lanes: int, n_valid: int, lp: int, encode: bool):
    """The kernels' ring replayed: -> (chunks, positions). chunks lists, in
    the order the producer fills them and the consumers take them, (slot,
    parity the consumers wait for, parity the producer waits for before
    refilling or None, first step, steps, byte offset of its rows in the
    table, bytes of rows); positions lists each lane's positions in the
    order its thread codes them: steps backwards on encode, forwards on
    decode, skipping positions >= n_valid."""
    chunk, slots, _ = ring_plan(lanes, lp, encode)
    vsteps = -(-n_valid // lanes)
    n_chunks = -(-vsteps // chunk)
    order = range(n_chunks - 1, -1, -1) if encode else range(n_chunks)
    chunks, positions = [], [[] for _ in range(lanes)]
    for i, k in enumerate(order):
        t0 = k * chunk
        tn = min(chunk, vsteps - t0)
        chunks.append((i % slots, (i // slots) & 1,
                       (i // slots - 1) & 1 if i >= slots else None,
                       t0, tn, 4 * t0 * lanes * lp, 4 * tn * lanes * lp))
        steps = range(tn - 1, -1, -1) if encode else range(tn)
        for lane in range(lanes):
            for j in steps:
                pos = (t0 + j) * lanes + lane
                if pos < n_valid:
                    positions[lane].append(pos)
    return chunks, positions


def advance_prev(prev: torch.Tensor, s: torch.Tensor, stage: int) -> torch.Tensor:
    """The combined earlier bits a stage's table is conditioned on, after
    stage `stage` decoded s (codec.py:173-183): s, then 2p+s, 4p+s, and
    after stage 3 16p+s, the occupancy byte."""
    if stage == 0:
        return s.clone()
    return prev * (2, 2, 4, 16)[stage] + s


def _library():
    lib = native.load("rans").lib
    if lib.rans_encode_stage.argtypes is None:
        c_int, ptr = ctypes.c_int, ctypes.c_void_p
        lib.rans_encode_stage.argtypes = [ptr, ptr, ptr, c_int, ptr, c_int,
                                          ptr, c_int, c_int, c_int, ptr]
        lib.rans_encode_stage.restype = c_int
        lib.rans_decode_stage.argtypes = [ptr, ptr, ptr, c_int, ptr, c_int,
                                          c_int, c_int, c_int, c_int, ptr,
                                          ptr, ptr, ptr]
        lib.rans_decode_stage.restype = c_int
        lib.rans_encode_floor.argtypes = [ptr, ptr, ptr, c_int, ptr, c_int,
                                          c_int, c_int, ptr]
        lib.rans_encode_floor.restype = c_int
        lib.rans_decode_floor.argtypes = [ptr, ptr, ptr, ptr, c_int, c_int,
                                          c_int, c_int, ptr]
        lib.rans_decode_floor.restype = c_int
    return lib


def _on_card(tensors, names, lanes: int) -> torch.device:
    """The device of the kernel's tensors; raises on what the kernel does
    not take: mixed devices, strides, a lane count not a multiple of 4,
    and a table, syms or prev not on 16 bytes (its copies' granule)."""
    dev = tensors[0].device
    for t, name in zip(tensors, names):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, the table on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
        if name in ("table", "syms", "prev") and t.data_ptr() % 16:
            raise ValueError(f"{name} does not start on 16 bytes")
    if lanes % 4 or not 4 <= lanes <= 128:
        raise ValueError(f"the kernels take 4..128 lanes in steps of 4, not {lanes}")
    return dev


def encode_stage(carry, table: torch.Tensor, syms: torch.Tensor, n_valid: int):
    """Push one stage's symbols onto the lane streams, in reverse order.

    table int32 [cap, Lp]; syms int32 [cap]; n_valid a host int. Call for
    the stages in reverse order (3..0); decode runs them 0..3. The kernel
    on CUDA tensors (counted in `encode_launches`; the carry is updated in
    place and returned); the plain version on CPU tensors."""
    global encode_launches
    _check(table, syms, "syms", n_valid)
    if table.device.type == "cpu":
        return encode_stage_reference(carry, table, syms, n_valid)
    if table.device.type != "cuda":
        raise ValueError(f"rans runs on CUDA or CPU, not {table.device}")
    state, n_words, words = carry
    lanes = state.shape[0]
    if (state.dtype != torch.int64 or n_words.dtype != torch.int32
            or words.dtype != torch.int32 or words.shape[0] != lanes
            or table.shape[0] % lanes):
        raise ValueError("encode carry: expected int64 state [L], int32 "
                         "n_words [L] and int32 words [L, W], L dividing cap")
    dev = _on_card([table, syms, state, n_words, words],
                   ["table", "syms", "state", "n_words", "words"], lanes)
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.rans_encode_stage(
            state.data_ptr(), n_words.data_ptr(), words.data_ptr(),
            words.shape[1], table.data_ptr(), table.shape[1], syms.data_ptr(),
            table.shape[0] // lanes, lanes, n_valid,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rans_encode_stage launch failed: CUDA error {rc}")
    encode_launches += 1
    return state, n_words, words


def enc_flush(carry):
    """Append each lane's final state as two words, low half first (so the
    reversal in `pack_stream` puts the high half first). Returns (words,
    n_words + 2)."""
    state, n_words, words = carry
    words = words.clone()
    col = n_words.to(torch.int64)[:, None]
    words.scatter_(1, col, (state & U16).to(torch.int32)[:, None])
    words.scatter_(1, col + 1, (state >> 16).to(torch.int32)[:, None])
    return words, n_words + 2


def dec_init(words: torch.Tensor):
    """(state, ptr) from the reversed lane words [L, W]."""
    state = (words[:, 0].to(torch.int64) << 16) | words[:, 1].to(torch.int64)
    ptr = torch.full((words.shape[0],), 2, dtype=torch.int32,
                     device=words.device)
    return state, ptr


def decode_stage(carry, table: torch.Tensor, words: torch.Tensor, n_valid: int,
                 prev: torch.Tensor, stage: int):
    """Decode one stage's symbols (forward order) and advance the earlier
    bits: -> ((state, ptr), syms int32 [cap], advance_prev(prev, syms,
    stage)). The kernel on CUDA tensors (counted in `decode_launches`;
    the carry is updated in place), the plain version on CPU tensors."""
    global decode_launches
    _check(table, prev, "prev", n_valid)
    if not 0 <= stage <= 3:
        raise ValueError(f"stage {stage} outside 0..3")
    if table.device.type == "cpu":
        carry, s = decode_stage_reference(carry, table, words, n_valid)
        return carry, s, advance_prev(prev, s, stage)
    if table.device.type != "cuda":
        raise ValueError(f"rans runs on CUDA or CPU, not {table.device}")
    state, ptr = carry
    lanes = state.shape[0]
    if (state.dtype != torch.int64 or ptr.dtype != torch.int32
            or words.dtype != torch.int32 or words.shape[0] != lanes
            or table.shape[0] % lanes):
        raise ValueError("decode carry: expected int64 state [L], int32 ptr "
                         "[L] and int32 words [L, W], L dividing cap")
    if table.shape[1] not in (3, 5, 17):
        raise ValueError(f"the decode kernel takes tables of 3, 5 or 17 "
                         f"columns (the format's stages), not {table.shape[1]}")
    dev = _on_card([table, prev, state, ptr, words],
                   ["table", "prev", "state", "ptr", "words"], lanes)
    syms = torch.empty_like(prev)
    prev_out = torch.empty_like(prev)
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.rans_decode_stage(
            state.data_ptr(), ptr.data_ptr(), words.data_ptr(), words.shape[1],
            table.data_ptr(), table.shape[1], table.shape[0] // lanes, lanes,
            n_valid, stage, prev.data_ptr(), prev_out.data_ptr(),
            syms.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rans_decode_stage launch failed: CUDA error {rc}")
    decode_launches += 1
    return (state, ptr), syms, prev_out


def encode_floor(carry, lo_freq: torch.Tensor, steps: int, divide: bool = False):
    """Diagnostic, the encode chain's floor: `steps` steps of each lane with
    its operands in registers, (lo, freq + t % 64) from lo_freq int32 [L,
    2] on the card (freq >= 1, freq + 63 <= 65535), dividing as the kernel
    does (by the reciprocal) or, with `divide`, by u32 `/` and `%`. The
    carry is updated in place. No coding path calls it."""
    state, n_words, words = carry
    lib = _library()
    rc = lib.rans_encode_floor(
        state.data_ptr(), n_words.data_ptr(), words.data_ptr(), words.shape[1],
        lo_freq.contiguous().data_ptr(), steps, state.shape[0], int(divide),
        torch.cuda.current_stream(state.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rans_encode_floor launch failed: CUDA error {rc}")
    return carry


def decode_floor(carry, rows: torch.Tensor, word: int, steps: int):
    """Diagnostic, the decode chain's floor: `steps` steps of each lane on
    its row of rows int32 [L, Lp] (Lp 3, 5 or 17) held in registers,
    refilling with `word`. -> (carry updated in place, each lane's symbols
    summed). No coding path calls it."""
    state, ptr = carry
    total = torch.empty_like(ptr)
    lib = _library()
    rc = lib.rans_decode_floor(
        state.data_ptr(), ptr.data_ptr(), total.data_ptr(),
        rows.contiguous().data_ptr(), rows.shape[1], word, steps, state.shape[0],
        torch.cuda.current_stream(state.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rans_decode_floor launch failed: CUDA error {rc}")
    return carry, total


# ---------------------------------------------------------------------------
# host-side stream (de)framing
# ---------------------------------------------------------------------------

def pack_stream(words_np: np.ndarray, n_words_np: np.ndarray) -> bytes:
    """Trim lanes to their word counts, reverse each, frame as u16 lane
    count | u16[lanes] counts | u16 words (lane-major)."""
    lanes = words_np.shape[0]
    parts = [np.uint16(lanes).tobytes(),
             np.asarray(n_words_np).astype(np.uint16).tobytes()]
    for j in range(lanes):
        parts.append(words_np[j, : n_words_np[j]][::-1].astype(np.uint16)
                     .tobytes())
    return b"".join(parts)


def unpack_stream(stream: bytes, word_cap: int):
    """-> (words int32 [lanes, word_cap] zero-padded, counts int64 [lanes])."""
    lanes = int(np.frombuffer(stream[:2], np.uint16)[0])
    counts = np.frombuffer(stream[2 : 2 + 2 * lanes], np.uint16).astype(np.int64)
    flat = np.frombuffer(stream[2 + 2 * lanes :], np.uint16)
    words = np.zeros((lanes, word_cap), np.int32)
    off = 0
    for j in range(lanes):
        words[j, : counts[j]] = flat[off : off + counts[j]]
        off += counts[j]
    return words, counts
