// Lane-interleaved rANS scans for Hopper (sm_90a), plain C interface.
//
// Replaces the XLA scans of gauspcc_tpu/ops/rans.py: `encode_stage` (:80)
// and `decode_stage` (:142), with the `prev` update of
// gauspcc_tpu/codecs/gauspcgc/codec.py `_rans_decode_stage` (:173-183)
// fused into the decode. The format fixes L <= 128 lanes (`lane_count`);
// lane j codes positions t*L + j, so a lane is one thread walking its
// steps in order, and a stage is one block of L threads.
//
// What bounds it: a lane's steps form one chain of dependent u32 updates
// (a division on encode, a table search and a refill on decode). At the
// finest level of the bench cloud that is 1,280 steps on 128 threads of
// one SM, so the kernel sits far below the card's memory and issue
// roofline, by the format's doing: it cannot widen without a new
// bitstream. What the design does about it: the table rows and symbols
// a step reads do not depend on the state, so a step's loads are issued
// by the unrolled loop ahead of the chain, and the state, cursor and
// counts live in registers across all steps.
//
// Layouts (gauspcc_tpu_torch/ops/rans.py): tables int32 [cap, lp] holding
// uint16 values (the last column wrapped to 0); symbols and prev int32
// [cap]; state int64 [L] holding a u32; n_words / ptr int32 [L]; words
// int32 [L, word_cap] holding uint16 values. Each entry point launches
// one kernel on `stream` and returns cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr uint32_t kLow16 = 0xFFFFu;
constexpr uint32_t kRenorm = 1u << 16;

__global__ void __launch_bounds__(128)
encode_stage_kernel(int64_t* __restrict__ state_io,
                    int32_t* __restrict__ n_words_io,
                    int32_t* __restrict__ words, int word_cap,
                    const int32_t* __restrict__ table, int lp,
                    const int32_t* __restrict__ syms, int steps, int lanes,
                    int n_valid) {
  const int lane = threadIdx.x;
  if (lane >= lanes) return;
  uint32_t state = static_cast<uint32_t>(state_io[lane]);
  int32_t nw = n_words_io[lane];
  int32_t* my_words = words + static_cast<int64_t>(lane) * word_cap;
#pragma unroll 4
  for (int t = steps - 1; t >= 0; --t) {
    const int pos = t * lanes + lane;
    if (pos >= n_valid) continue;
    const int s = min(max(__ldg(syms + pos), 0), lp - 2);
    const int32_t* row = table + static_cast<int64_t>(pos) * lp;
    const uint32_t lo = static_cast<uint32_t>(__ldg(row + s));
    const uint32_t freq = (static_cast<uint32_t>(__ldg(row + s + 1)) - lo) & kLow16;
    if (state >= (freq << 16)) {
      if (nw < word_cap) my_words[nw] = static_cast<int32_t>(state & kLow16);
      ++nw;
      state >>= 16;
    }
    state = ((state / freq) << 16) + state % freq + lo;
  }
  state_io[lane] = state;
  n_words_io[lane] = nw;
}

__global__ void __launch_bounds__(128)
decode_stage_kernel(int64_t* __restrict__ state_io, int32_t* __restrict__ ptr_io,
                    const int32_t* __restrict__ words, int word_cap,
                    const int32_t* __restrict__ table, int lp, int steps,
                    int lanes, int n_valid, int stage,
                    const int32_t* __restrict__ prev_in,
                    int32_t* __restrict__ prev_out,
                    int32_t* __restrict__ syms) {
  const int lane = threadIdx.x;
  if (lane >= lanes) return;
  uint32_t state = static_cast<uint32_t>(state_io[lane]);
  int32_t ptr = ptr_io[lane];
  const int32_t* my_words = words + static_cast<int64_t>(lane) * word_cap;
  const int32_t scale = stage == 1 ? 2 : stage == 2 ? 4 : 16;
#pragma unroll 2
  for (int t = 0; t < steps; ++t) {
    const int pos = t * lanes + lane;
    int32_t s = 0;
    if (pos < n_valid) {
      const int32_t* row = table + static_cast<int64_t>(pos) * lp;
      const uint32_t slot = state & kLow16;
      // s = #{j in [1, lp-2] : cdf[j] <= slot}; column 0 is 0, the last
      // column wraps to 0 and is not read
      for (int j = 1; j < lp - 1; ++j)
        s += static_cast<uint32_t>(__ldg(row + j)) <= slot;
      const uint32_t lo = static_cast<uint32_t>(__ldg(row + s));
      const uint32_t freq = (static_cast<uint32_t>(__ldg(row + s + 1)) - lo) & kLow16;
      uint32_t next = freq * (state >> 16) + slot - lo;
      if (next < kRenorm) {
        const int at = min(max(ptr, 0), word_cap - 1);
        next = (next << 16) | static_cast<uint32_t>(my_words[at]);
        ++ptr;
      }
      state = next;
    }
    syms[pos] = s;
    prev_out[pos] = stage == 0 ? s : prev_in[pos] * scale + s;
  }
  state_io[lane] = state;
  ptr_io[lane] = ptr;
}

}  // namespace

extern "C" {

// One encode stage: steps t = steps-1 .. 0, positions t*lanes + lane below
// n_valid. The state, word count and words are updated in place.
int rans_encode_stage(void* state, void* n_words, void* words, int word_cap,
                      const void* table, int lp, const void* syms, int steps,
                      int lanes, int n_valid, void* stream) {
  if (lanes < 1 || lanes > 128 || lp < 3 || steps < 0) return cudaErrorInvalidValue;
  encode_stage_kernel<<<1, lanes, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int64_t*>(state), static_cast<int32_t*>(n_words),
      static_cast<int32_t*>(words), word_cap,
      static_cast<const int32_t*>(table), lp,
      static_cast<const int32_t*>(syms), steps, lanes, n_valid);
  return static_cast<int>(cudaGetLastError());
}

// One decode stage: steps t = 0 .. steps-1. Writes the symbols (0 past
// n_valid) and prev_out = s, 2*prev+s, 4*prev+s or 16*prev+s for stage 0,
// 1, 2 or 3; the state and word pointer are updated in place.
int rans_decode_stage(void* state, void* ptr, const void* words, int word_cap,
                      const void* table, int lp, int steps, int lanes,
                      int n_valid, int stage, const void* prev_in,
                      void* prev_out, void* syms, void* stream) {
  if (lanes < 1 || lanes > 128 || lp < 3 || steps < 0 || word_cap < 1)
    return cudaErrorInvalidValue;
  decode_stage_kernel<<<1, lanes, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int64_t*>(state), static_cast<int32_t*>(ptr),
      static_cast<const int32_t*>(words), word_cap,
      static_cast<const int32_t*>(table), lp, steps, lanes, n_valid, stage,
      static_cast<const int32_t*>(prev_in), static_cast<int32_t*>(prev_out),
      static_cast<int32_t*>(syms));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
