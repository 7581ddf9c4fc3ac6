// Lane-interleaved rANS scans for Hopper (sm_90a), plain C interface.
//
// Replaces the XLA scans of gauspcc_tpu/ops/rans.py: `encode_stage` (:80)
// and `decode_stage` (:142), with the `prev` update of
// gauspcc_tpu/codecs/gauspcgc/codec.py `_rans_decode_stage` (:173-183)
// fused into the decode. The format fixes L <= 128 lanes (`lane_count`);
// lane j codes positions t*L + j, so a stage is one block in which one
// thread a lane walks the lane's steps in order.
//
// What bounds it: not the bytes, the chain. A lane's steps form one chain
// of dependent u32 updates (a division on encode; a table search and a
// refill on decode): 1,280 steps a stage at the finest level of the bench
// cloud, on 128 threads of one SM, one warp on each of its four
// schedulers, so no other warp hides a stall. A step costs the latency of
// its chain plus whatever else its thread issues, and a round trip to
// device memory on the chain costs many steps' arithmetic.
//
// What the design does about it: no table row, symbol or prev value
// depends on the state, so they are staged ahead of the chain.
// - A producer warp streams them into a ring of shared-memory slots. A
//   slot holds `chunk` consecutive steps, which are one contiguous span of
//   the table, by one bulk async copy, and one of syms (encode) or prev
//   (decode), by the warp's 16-byte cp.async (a second bulk copy a slot
//   was slower), both counted on the slot's `full` mbarrier. The consumer
//   warps release the slot on its `empty` mbarrier. Encode takes the slots
//   from the last step backwards.
// - One consumer thread a lane keeps the state, the word count or pointer
//   and its counts in registers for all steps, reads a step's operands
//   from shared memory ahead of the chain, and updates the chain with
//   selects, not branches.
// - Encode loads a step's (lo, hi) two steps ahead and computes m =
//   (2^32 - 1) / freq one step ahead, so that the chain's division is a
//   high multiply and one correction (`encode_symbol`).
// - Decode takes the row into registers a step ahead and finds (s, lo, hi)
//   with compares and selects once the state is known, no indexed read
//   (`decode_symbol`).
// - Decode's one state-dependent load, the refill word, comes from a
//   per-lane ring of kWords words in shared memory, which a lane tops up
//   with cp.async to kWords words past its pointer as each slot of steps
//   arrives; a slot takes at most kWords / 4 words, so what it reads
//   landed two slots earlier. The pointer is clamped to [0, word_cap - 1]
//   as the plain version clamps it.
// PERF.md gives the time of each stage against the chain floor, the same
// arithmetic with every operand in registers (`*_floor_kernel`).
//
// Layouts (gauspcc_tpu_torch/ops/rans.py): tables int32 [cap, lp] holding
// uint16 values (the last column wrapped to 0), each row nondecreasing
// over columns 0..lp-2 (core/cdf.py writes them strictly increasing from
// 0); symbols and prev int32 [cap]; state int64 [L] holding a u32;
// n_words / ptr int32 [L]; words int32 [L, word_cap] holding uint16
// values. L is a multiple of 4 and the table, syms and prev start on 16
// bytes (the copies' granule), so every copy's offset and size is a
// multiple of 16 bytes. Decode takes lp 3, 5 or 17, the format's stages.
// Each entry point launches one kernel on `stream` and returns
// cudaGetLastError() (cudaErrorInvalidValue for arguments it refuses).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr uint32_t kLow16 = 0xFFFFu;
constexpr uint32_t kRenorm = 1u << 16;
constexpr int kMaxLanes = 128;
constexpr int kEncodeChunk = 32;  // steps a ring slot holds, at most
constexpr int kDecodeChunk = 32;  // at most kWords / 4: see the word ring
constexpr int kMaxSlots = 8;
constexpr int kWords = 128;    // decode: a lane's words from its pointer on
constexpr int kWordStride = kWords + 1;  // odd, so lanes' rings share no bank
constexpr int kSmemLimit = 232448;       // dynamic shared memory of a block, sm_90
constexpr int kBarrierBytes = 2 * kMaxSlots * 8;
constexpr int kWordRingBytes = kMaxLanes * kWordStride * 4;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)), "r"(bytes) : "memory");
}

// Until the phase of parity `parity` of `bar` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  }
}

// `bytes` (a multiple of 16) from global `src` to shared `dst`, both on 16
// bytes, counted on `bar`'s transaction count.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)), "l"(src), "r"(bytes),
      "r"(smem_u32(bar)) : "memory");
}

// A warp's copy of `bytes` (a multiple of 16) from global `src` to shared
// `dst`, both on 16 bytes, 16 bytes a thread a copy; each thread then
// arrives on `bar` once its copies have landed.
__device__ __forceinline__ void warp_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  const uint32_t to = smem_u32(dst);
  const char* from = static_cast<const char*>(src);
  for (uint32_t at = 16 * (threadIdx.x % 32); at < bytes; at += 16 * 32)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(to + at),
                 "l"(from + at) : "memory");
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void fetch4(void* dst, const int32_t* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(dst)),
               "l"(src) : "memory");
}

// The words from .. from+n-1 of a lane's row (each index clamped to
// [0, word_cap - 1]) into its ring, by cp.async.
__device__ __forceinline__ void fetch_words(uint32_t* ring, const int32_t* my_words,
                                            int word_cap, int from, int n) {
  for (int i = 0; i < n; ++i) {
    const int at = from + i;
    fetch4(ring + (at & (kWords - 1)), my_words + min(max(at, 0), word_cap - 1));
  }
}

__device__ __forceinline__ void commit_fetches() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Until every group of this thread's fetches but the newest N has landed.
template <int N>
__device__ __forceinline__ void words_landed() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// m = (2^32 - 1) / freq: x / freq for any u32 x is then __umulhi(x, m) or
// one more (ops/rans.py `divide_by_reciprocal` checks it exhaustively).
__device__ __forceinline__ uint32_t reciprocal(uint32_t freq) {
  return 0xFFFFFFFFu / freq;
}

// An encode step's renormalization: the state, or its high half once the
// low half is emitted as a word when pushing a symbol of `freq` would
// overflow it.
__device__ __forceinline__ uint32_t renormalize(uint32_t state, int32_t& nw,
                                                int32_t* my_words, int word_cap,
                                                uint32_t freq) {
  const bool need = state >= (freq << 16);
  // a predicated store: a branch here would split the warp at every step
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.u32 p, %2, 0;\n\t"
      "@p st.global.u32 [%0], %1;\n\t}" ::"l"(my_words + nw),
      "r"(state & kLow16), "r"(static_cast<uint32_t>(need && nw < word_cap)));
  nw += need;
  return need ? state >> 16 : state;
}

// One encode step: push the symbol (lo, freq) onto a lane's state;
// m = reciprocal(freq).
__device__ __forceinline__ void encode_symbol(uint32_t& state, int32_t& nw,
                                              int32_t* my_words, int word_cap,
                                              uint32_t lo, uint32_t freq, uint32_t m) {
  const uint32_t x = renormalize(state, nw, my_words, word_cap, freq);
  uint32_t q = __umulhi(x, m);
  uint32_t r = x - q * freq;
  const bool over = r >= freq;
  q += over;
  r -= over ? freq : 0u;
  state = (q << 16) + r + lo;
}

// One decode step on a row c held in registers: returns the symbol s and
// advances the state, `need` when it takes `word`. For a row
// nondecreasing over columns 0..LP-2, s = #{j in [1, LP-2] : c[j] <= slot}
// as the plain version counts, lo = c[s] is the largest of those entries
// (column 0 when none) and hi = c[s+1] the smallest entry above the slot
// (the wrapped last column when none); the last column enters as itself
// plus 2^16, above every other entry, which (hi - lo) mod 2^16 does not
// see. At 17 columns, three compares first pick the group of 4 columns
// that holds the slot (e = c[4g .. 4g+4]); the search then runs on e.
template <int LP>
__device__ __forceinline__ int32_t decode_symbol(uint32_t& state, const uint32_t (&c)[LP],
                                                 uint32_t word, bool& need) {
  constexpr int kE = LP == 17 ? 5 : LP;
  const uint32_t slot = state & kLow16;
  uint32_t e[kE];
  int32_t s = 0;
  if constexpr (LP == 17) {
    // p3 implies p2 implies p1 on a nondecreasing row, so g = p1 + p2 + p3
    const bool p1 = c[4] <= slot, p2 = c[8] <= slot, p3 = c[12] <= slot;
#pragma unroll
    for (int i = 0; i < kE; ++i) {
      const uint32_t a = p1 ? c[4 + i] : c[i];
      const uint32_t b = p3 ? (i == 4 ? c[16] + kRenorm : c[12 + i]) : c[8 + i];
      e[i] = p2 ? b : a;
    }
    s = 4 * (static_cast<int32_t>(p1) + p2 + p3);
  } else {
#pragma unroll
    for (int i = 0; i < kE; ++i) e[i] = i == kE - 1 ? c[i] + kRenorm : c[i];
  }
  uint32_t lo = e[0], hi = e[kE - 1];
#pragma unroll
  for (int i = 1; i < kE - 1; ++i) {
    const bool le = e[i] <= slot;
    s += le;
    lo = max(lo, le ? e[i] : 0u);
    hi = min(hi, le ? 0xFFFFFFFFu : e[i]);
  }
  const uint32_t freq = (hi - lo) & kLow16;
  const uint32_t next = freq * (state >> 16) + slot - lo;
  need = next < kRenorm;
  state = need ? (next << 16) | word : next;
  return s;
}

__device__ __forceinline__ void init_barriers(uint64_t* full, uint64_t* empty,
                                              int slots, int fillers, int consumer_warps) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < slots; ++i) {
      mbar_init(&full[i], fillers);
      mbar_init(&empty[i], consumer_warps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

// Block: ceil(L/32) consumer warps, then one producer warp. Slot i of the
// walk is ring slot i % slots, filled for the (i / slots)-th time.
__global__ void __launch_bounds__(kMaxLanes + 32)
encode_stage_kernel(int64_t* __restrict__ state_io, int32_t* __restrict__ n_words_io,
                    int32_t* __restrict__ words, int word_cap,
                    const int32_t* __restrict__ table, int lp,
                    const int32_t* __restrict__ syms, int lanes, int n_valid,
                    int chunk, int slots) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxSlots;
  int32_t* ring = reinterpret_cast<int32_t*>(smem + kBarrierBytes);
  const int consumer_warps = (lanes + 31) / 32;
  const int vsteps = (n_valid + lanes - 1) / lanes;  // steps with a valid lane
  const int chunks = (vsteps + chunk - 1) / chunk;
  const int step_rows = lanes * lp;
  const int slot_ints = chunk * (step_rows + lanes);
  // full: lane 0's expected bytes, and each producer thread's copies of syms
  init_barriers(full, empty, slots, 1 + 32, consumer_warps);

  if (threadIdx.x / 32 == consumer_warps) {  // the producer
    const int tid = threadIdx.x % 32;
    for (int i = 0; i < chunks; ++i) {
      const int k = chunks - 1 - i;  // the walk runs the steps backwards
      const int slot = i % slots;
      if (i >= slots) mbar_wait(&empty[slot], (i / slots - 1) & 1);
      const int t0 = k * chunk, tn = min(chunk, vsteps - t0);
      int32_t* dst = ring + slot * slot_ints;
      if (tid == 0) {
        const uint32_t row_bytes = tn * step_rows * 4;
        mbar_arrive_expect_tx(&full[slot], row_bytes);
        bulk_load(dst, table + static_cast<int64_t>(t0) * step_rows, row_bytes,
                  &full[slot]);
      }
      warp_copy(dst + chunk * step_rows, syms + static_cast<int64_t>(t0) * lanes,
                tn * lanes * 4, &full[slot]);
    }
    return;
  }

  const int lane = threadIdx.x;
  const bool active = lane < lanes;
  uint32_t state = 0;
  int32_t nw = 0;
  if (active) {
    state = static_cast<uint32_t>(state_io[lane]);
    nw = n_words_io[lane];
  }
  int32_t* my_words = words + static_cast<int64_t>(lane) * word_cap;
  for (int i = 0; i < chunks; ++i) {
    const int k = chunks - 1 - i;
    const int slot = i % slots;
    mbar_wait(&full[slot], (i / slots) & 1);
    const int t0 = k * chunk, tn = min(chunk, vsteps - t0);
    const int32_t* rows = ring + slot * slot_ints;
    const int32_t* sy = rows + chunk * step_rows;
    // the row entries (lo, hi) of step j's symbol
    auto load = [&](int j, uint32_t& lo, uint32_t& hi) {
      const int s = min(max(sy[j * lanes + lane], 0), lp - 2);
      const int32_t* row = rows + (j * lanes + lane) * lp;
      lo = static_cast<uint32_t>(row[s]);
      hi = static_cast<uint32_t>(row[s + 1]);
    };
    if (active) {
      int j = tn - 1;
      uint32_t lo, hi;
      load(j, lo, hi);
      uint32_t freq = (hi - lo) & kLow16, m = reciprocal(freq);
      if (i == 0 && n_valid % lanes != 0) {  // the last valid step, in part
        if ((t0 + j) * lanes + lane < n_valid)
          encode_symbol(state, nw, my_words, word_cap, lo, freq, m);
        if (--j >= 0) {
          load(j, lo, hi);
          freq = (hi - lo) & kLow16;
          m = reciprocal(freq);
        }
      }
      // off the chain: the loads two steps ahead, the reciprocal one ahead
      uint32_t lo1, hi1;
      load(max(j - 1, 0), lo1, hi1);
#pragma unroll 2
      for (; j >= 0; --j) {
        uint32_t lo2, hi2;
        load(max(j - 2, 0), lo2, hi2);
        const uint32_t freq1 = (hi1 - lo1) & kLow16;
        const uint32_t m1 = reciprocal(freq1);
        encode_symbol(state, nw, my_words, word_cap, lo, freq, m);
        lo = lo1;
        freq = freq1;
        m = m1;
        lo1 = lo2;
        hi1 = hi2;
      }
    }
    __syncwarp();
    if (lane % 32 == 0) mbar_arrive(&empty[slot]);
  }
  if (active) {
    state_io[lane] = state;
    n_words_io[lane] = nw;
  }
}

template <int LP>
__global__ void __launch_bounds__(kMaxLanes + 32)
decode_stage_kernel(int64_t* __restrict__ state_io, int32_t* __restrict__ ptr_io,
                    const int32_t* __restrict__ words, int word_cap,
                    const int32_t* __restrict__ table, int cap, int lanes,
                    int n_valid, int stage, const int32_t* __restrict__ prev_in,
                    int32_t* __restrict__ prev_out, int32_t* __restrict__ syms,
                    int chunk, int slots) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxSlots;
  uint32_t* word_ring = reinterpret_cast<uint32_t*>(smem + kBarrierBytes);
  int32_t* ring = reinterpret_cast<int32_t*>(smem + kBarrierBytes + kWordRingBytes);
  const int32_t scale = stage == 0 ? 0 : stage == 1 ? 2 : stage == 2 ? 4 : 16;
  const int consumer_warps = (lanes + 31) / 32;
  const int vsteps = (n_valid + lanes - 1) / lanes;
  const int chunks = (vsteps + chunk - 1) / chunk;
  const int step_rows = lanes * LP;
  const int slot_ints = chunk * (step_rows + lanes);
  // full: lane 0's expected bytes, and each producer thread's copies of prev
  init_barriers(full, empty, slots, 1 + 32, consumer_warps);

  if (threadIdx.x / 32 == consumer_warps) {  // the producer
    const int tid = threadIdx.x % 32;
    for (int k = 0; k < chunks; ++k) {
      const int slot = k % slots;
      if (k >= slots) mbar_wait(&empty[slot], (k / slots - 1) & 1);
      const int t0 = k * chunk, tn = min(chunk, vsteps - t0);
      int32_t* dst = ring + slot * slot_ints;
      if (tid == 0) {
        const uint32_t row_bytes = tn * step_rows * 4;
        mbar_arrive_expect_tx(&full[slot], row_bytes);
        bulk_load(dst, table + static_cast<int64_t>(t0) * step_rows, row_bytes,
                  &full[slot]);
      }
      warp_copy(dst + chunk * step_rows, prev_in + static_cast<int64_t>(t0) * lanes,
                tn * lanes * 4, &full[slot]);
    }
    // the steps past the last valid position decode symbol 0
    for (int pos = vsteps * lanes + threadIdx.x % 32; pos < cap; pos += 32) {
      syms[pos] = 0;
      prev_out[pos] = prev_in[pos] * scale;
    }
    return;
  }

  const int lane = threadIdx.x;
  const bool active = lane < lanes;
  uint32_t state = 0;
  int32_t ptr = 0;
  const int32_t* my_words = words + static_cast<int64_t>(lane) * word_cap;
  uint32_t* my_ring = word_ring + lane * kWordStride;
  const uint32_t ring_at = smem_u32(my_ring);
  uint32_t cur = 0;     // the word at ptr
  int32_t fetched = 0;  // the ring holds or awaits words ptr .. fetched-1
  if (active) {
    state = static_cast<uint32_t>(state_io[lane]);
    ptr = ptr_io[lane];
    fetch_words(my_ring, my_words, word_cap, ptr, kWords);
    commit_fetches();
    words_landed<0>();
    cur = my_ring[ptr & (kWords - 1)];
    fetched = ptr + kWords;
  }

  for (int k = 0; k < chunks; ++k) {
    const int slot = k % slots;
    mbar_wait(&full[slot], (k / slots) & 1);
    const int t0 = k * chunk, tn = min(chunk, vsteps - t0);
    const int32_t* rows = ring + slot * slot_ints + lane * LP;  // step 0's row
    const int32_t* prev = ring + slot * slot_ints + chunk * step_rows + lane;
    int32_t* sym_out = syms + t0 * lanes + lane;
    int32_t* prev_to = prev_out + t0 * lanes + lane;
    auto load_row = [&](int j, uint32_t (&c)[LP]) {
#pragma unroll
      for (int i = 0; i < LP; ++i) c[i] = static_cast<uint32_t>(rows[j * step_rows + i]);
    };
    // step j on the row c; `valid` false leaves the state and pointer
    auto step = [&](int j, const uint32_t (&c)[LP], bool valid) {
      uint32_t nxt;  // the word after ptr, read before the state is known
      asm volatile("ld.shared.u32 %0, [%1];"
                   : "=r"(nxt) : "r"(ring_at + 4 * ((ptr + 1) & (kWords - 1))));
      const int32_t pv = prev[j * lanes];
      uint32_t next = state;
      bool need;
      int32_t s = decode_symbol<LP>(next, c, cur, need);
      need = need && valid;
      state = valid ? next : state;
      s = valid ? s : 0;
      cur = need ? nxt : cur;
      ptr += need;
      sym_out[j * lanes] = s;
      prev_to[j * lanes] = pv * scale + s;
    };
    if (active) {
      // top the word ring up to kWords words past the pointer (a slot takes
      // at most kWords / 4), so that what this slot reads was fetched two
      // slots ago and has landed
      fetch_words(my_ring, my_words, word_cap, fetched, ptr + kWords - fetched);
      fetched = ptr + kWords;
      commit_fetches();
      words_landed<2>();
      const bool ragged = k == chunks - 1 && n_valid % lanes != 0;
      const int whole = ragged ? tn - 1 : tn;
      uint32_t c[LP];
      load_row(0, c);
#pragma unroll 2
      for (int j = 0; j < whole; ++j) {
        uint32_t c_next[LP];  // the next step's row, off the chain
        load_row(min(j + 1, tn - 1), c_next);
        step(j, c, true);
#pragma unroll
        for (int i = 0; i < LP; ++i) c[i] = c_next[i];
      }
      if (ragged) step(whole, c, (t0 + whole) * lanes + lane < n_valid);
    }
    __syncwarp();
    if (lane % 32 == 0) mbar_arrive(&empty[slot]);
  }
  if (active) {
    state_io[lane] = state;
    ptr_io[lane] = ptr;
  }
}

// Diagnostics, the chain's floor: the kernels' per-step arithmetic with
// every operand in registers, `steps` steps a lane. Encode cycles each
// lane's (lo, freq) through 64 divisors (freq + t % 64, so that the
// division's divisor part is not hoisted out of the loop), by the
// reciprocal as the kernel divides or, with kDivide, by the compiler's
// u32 `/` and `%`; decode runs each step on the lane's row and refills
// from a register.
template <bool kDivide>
__global__ void __launch_bounds__(kMaxLanes)
encode_floor_kernel(int64_t* __restrict__ state_io, int32_t* __restrict__ n_words_io,
                    int32_t* __restrict__ words, int word_cap,
                    const int32_t* __restrict__ lo_freq, int steps) {
  const int lane = threadIdx.x;
  uint32_t state = static_cast<uint32_t>(state_io[lane]);
  int32_t nw = n_words_io[lane];
  int32_t* my_words = words + static_cast<int64_t>(lane) * word_cap;
  const uint32_t lo = static_cast<uint32_t>(lo_freq[2 * lane]);
  const uint32_t freq = static_cast<uint32_t>(lo_freq[2 * lane + 1]);
#pragma unroll 4
  for (int t = 0; t < steps; ++t) {
    const uint32_t f = freq + (t & 63);
    if constexpr (kDivide) {
      const uint32_t x = renormalize(state, nw, my_words, word_cap, f);
      state = ((x / f) << 16) + x % f + lo;
    } else {
      encode_symbol(state, nw, my_words, word_cap, lo, f, reciprocal(f));
    }
  }
  state_io[lane] = state;
  n_words_io[lane] = nw;
}

template <int LP>
__global__ void __launch_bounds__(kMaxLanes)
decode_floor_kernel(int64_t* __restrict__ state_io, int32_t* __restrict__ ptr_io,
                    int32_t* __restrict__ sym_sum, const int32_t* __restrict__ rows,
                    int word, int steps) {
  const int lane = threadIdx.x;
  uint32_t state = static_cast<uint32_t>(state_io[lane]);
  int32_t ptr = ptr_io[lane];
  uint32_t c[LP];
#pragma unroll
  for (int i = 0; i < LP; ++i) c[i] = static_cast<uint32_t>(rows[lane * LP + i]);
  int32_t sum = 0;
#pragma unroll 2
  for (int t = 0; t < steps; ++t) {
    bool need;
    sum += decode_symbol<LP>(state, c, static_cast<uint32_t>(word), need);
    ptr += need;
  }
  state_io[lane] = state;
  ptr_io[lane] = ptr;
  sym_sum[lane] = sum;
}

// The ring of one launch: `chunk` steps a slot (max_chunk, halved while
// fewer than min_slots fit) and as many slots as fit, at most kMaxSlots.
// Returns the block's dynamic shared memory, or -1 when 2 slots of 1 step
// do not fit. ops/rans.py `ring_plan` mirrors it.
int plan(int step_ints, int fixed_bytes, int max_chunk, int min_slots, int* chunk,
         int* slots) {
  const int room = kSmemLimit - fixed_bytes;
  const int step_bytes = step_ints * 4;
  int c = max_chunk;
  while (c > 1 && room / (c * step_bytes) < min_slots) c /= 2;
  const int fit = room / (c * step_bytes);
  const int s = fit < kMaxSlots ? fit : kMaxSlots;
  if (s < 2) return -1;
  *chunk = c;
  *slots = s;
  return fixed_bytes + s * c * step_bytes;
}

bool misaligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; }

template <int LP>
int launch_decode(void* state, void* ptr, const void* words, int word_cap,
                  const void* table, int steps, int lanes, int n_valid, int stage,
                  const void* prev_in, void* prev_out, void* syms,
                  cudaStream_t stream) {
  int chunk, slots;
  const int smem = plan(lanes * (LP + 1), kBarrierBytes + kWordRingBytes,
                        kDecodeChunk, 2, &chunk, &slots);
  if (smem < 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      decode_stage_kernel<LP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int threads = (lanes + 31) / 32 * 32 + 32;
  decode_stage_kernel<LP><<<1, threads, smem, stream>>>(
      static_cast<int64_t*>(state), static_cast<int32_t*>(ptr),
      static_cast<const int32_t*>(words), word_cap,
      static_cast<const int32_t*>(table), steps * lanes, lanes, n_valid, stage,
      static_cast<const int32_t*>(prev_in), static_cast<int32_t*>(prev_out),
      static_cast<int32_t*>(syms), chunk, slots);
  return static_cast<int>(cudaGetLastError());
}

template <int LP>
int launch_decode_floor(void* state, void* ptr, void* sym_sum, const void* rows,
                        int word, int steps, int lanes, cudaStream_t stream) {
  decode_floor_kernel<LP><<<1, lanes, 0, stream>>>(
      static_cast<int64_t*>(state), static_cast<int32_t*>(ptr),
      static_cast<int32_t*>(sym_sum), static_cast<const int32_t*>(rows), word, steps);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int lanes, int steps, int n_valid) {
  return lanes < 4 || lanes > kMaxLanes || lanes % 4 != 0 || steps < 0 ||
         n_valid < 0 || n_valid > steps * lanes;
}

}  // namespace

extern "C" {

// One encode stage: steps t = steps-1 .. 0, positions t*lanes + lane below
// n_valid. The state, word count and words are updated in place.
int rans_encode_stage(void* state, void* n_words, void* words, int word_cap,
                      const void* table, int lp, const void* syms, int steps,
                      int lanes, int n_valid, void* stream) {
  if (bad_shape(lanes, steps, n_valid) || lp < 3 || misaligned(table) ||
      misaligned(syms))
    return cudaErrorInvalidValue;
  int chunk, slots;
  const int smem = plan(lanes * (lp + 1), kBarrierBytes, kEncodeChunk, 3, &chunk, &slots);
  if (smem < 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      encode_stage_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int threads = (lanes + 31) / 32 * 32 + 32;
  encode_stage_kernel<<<1, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int64_t*>(state), static_cast<int32_t*>(n_words),
      static_cast<int32_t*>(words), word_cap,
      static_cast<const int32_t*>(table), lp,
      static_cast<const int32_t*>(syms), lanes, n_valid, chunk, slots);
  return static_cast<int>(cudaGetLastError());
}

// One decode stage: steps t = 0 .. steps-1. Writes the symbols (0 past
// n_valid) and prev_out = s, 2*prev+s, 4*prev+s or 16*prev+s for stage 0,
// 1, 2 or 3; the state and word pointer are updated in place.
int rans_decode_stage(void* state, void* ptr, const void* words, int word_cap,
                      const void* table, int lp, int steps, int lanes,
                      int n_valid, int stage, const void* prev_in,
                      void* prev_out, void* syms, void* stream) {
  if (bad_shape(lanes, steps, n_valid) || word_cap < 1 || stage < 0 ||
      stage > 3 || misaligned(table) || misaligned(prev_in))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (lp) {
    case 3:
      return launch_decode<3>(state, ptr, words, word_cap, table, steps, lanes,
                              n_valid, stage, prev_in, prev_out, syms, s);
    case 5:
      return launch_decode<5>(state, ptr, words, word_cap, table, steps, lanes,
                              n_valid, stage, prev_in, prev_out, syms, s);
    case 17:
      return launch_decode<17>(state, ptr, words, word_cap, table, steps, lanes,
                               n_valid, stage, prev_in, prev_out, syms, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The chain floor of encode: `steps` steps of each lane on lo_freq [lanes,
// 2] (lo, freq >= 1, freq + 63 <= 65535), dividing by the reciprocal, or
// by `/` and `%` when `divide` is not 0; the state, word count and words
// updated in place.
int rans_encode_floor(void* state, void* n_words, void* words, int word_cap,
                      const void* lo_freq, int steps, int lanes, int divide,
                      void* stream) {
  if (lanes < 1 || lanes > kMaxLanes || steps < 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto args = [&](auto kernel) {
    kernel<<<1, lanes, 0, s>>>(
        static_cast<int64_t*>(state), static_cast<int32_t*>(n_words),
        static_cast<int32_t*>(words), word_cap,
        static_cast<const int32_t*>(lo_freq), steps);
  };
  if (divide)
    args(encode_floor_kernel<true>);
  else
    args(encode_floor_kernel<false>);
  return static_cast<int>(cudaGetLastError());
}

// The chain floor of decode: `steps` steps of each lane on its row of
// rows [lanes, lp] (lp 3, 5 or 17), refilling with `word`; the state and
// pointer updated in place, each lane's symbols summed into sym_sum.
int rans_decode_floor(void* state, void* ptr, void* sym_sum, const void* rows,
                      int lp, int word, int steps, int lanes, void* stream) {
  if (lanes < 1 || lanes > kMaxLanes || steps < 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (lp) {
    case 3: return launch_decode_floor<3>(state, ptr, sym_sum, rows, word, steps, lanes, s);
    case 5: return launch_decode_floor<5>(state, ptr, sym_sum, rows, word, steps, lanes, s);
    case 17: return launch_decode_floor<17>(state, ptr, sym_sum, rows, word, steps, lanes, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
