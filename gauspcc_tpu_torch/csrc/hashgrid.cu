// K3's backward: the gradient of a hash-grid table, for NVIDIA Hopper
// (sm_90a), plain C interface.
//
// Replaces no TPU kernel. The JAX package leaves this gradient to XLA's
// transpose of the table gather, a scatter-add (gauspcc_tpu/fields/
// hashgrid.py:18-19). PyTorch's autograd takes it as an accumulating
// index_put_, which sorts the int64 indices and then walks each run of
// equal rows in one warp (indexing_backward_kernel_small_stride); with a
// row of 2 floats most lanes idle, and the runs are long (a coarse level's
// 2.1 M lookups land in 5,832 rows; a 262,144-row bucket's ~102k padding
// rows all sit in one cell a level), so it took 562 ms of a 679-ms HAC step
// on one H100.
//
// Function, for one table of `rows` rows of F floats, over its M lookups
// (every point, level and corner, flat id j = (n * L + l) * C + c):
//   grad[r, f] = sum over the lookups j into row r of w[j] * g[j / C, f]
// where w [M] are the interpolation weights and g [N * L, F] the gradient
// of the grid's output ([N, L * F]). A row no lookup hits is 0.
//
// What bounds it: bytes. The gradient needs each lookup's int32 row and
// weight read once, the output gradient read once and the table gradient
// written once: at the HAC cell's shape (37.7 M lookups over four tables,
// [262,144, 48] output gradient, 5.04 M rows of 2) that is 0.39 GB, 0.12 ms
// at 3.35 TB/s. This design reads 16 B a lookup in place of 8 (the sorted
// int32 key, torch.sort's int64 order and the weight, gathered) and
// gathers the output gradient's rows; and the 32-bit radix sort that
// orders the lookups (torch.sort, outside this file) moves ~2.4 GB more,
// so the whole backward is bound near 1 ms.
//
// What the design does about it:
// - The lookups come sorted by row (a stable sort of the int32 row keys;
//   the flat lookup id is the value), so each row's terms are one
//   contiguous run and no sum needs a scatter or an atomic.
// - Load balance: the sorted array is cut into fixed chunks of kChunk
//   lookups, one warp a chunk, whatever the runs' lengths. A warp takes
//   its chunk 32 consecutive lookups at a time; a segmented scan by key
//   (a fixed shuffle tree) sums each run inside the 32, and the run that
//   reaches the tile's end is carried into the next tile. A run that ends
//   inside the chunk is written to its row. So a long run (a coarse level's
//   cell, the padding rows' cell) spreads over many warps, and a chunk of
//   short runs (the hashed levels) keeps every lane busy.
// - A run that crosses a chunk's edge leaves its piece in the chunk's
//   scratch (a head slot for the run that began before the chunk, a tail
//   slot for the one that goes on past it); rows_kernel then adds a row's
//   pieces in chunk order and writes the rows no lookup hits as 0.
// - Determinism: every sum runs in an order fixed by M alone (the chunk
//   cut, the tiles, the shuffle tree, the chunk order), with no atomics,
//   so the gradient is bit-identical from run to run. Products are rounded
//   (__fmul_rn, never contracted into an FMA) as PyTorch rounds w * g.
//
// The C entry launches three kernels on `stream` without synchronising
// and returns the first cudaGetLastError() (cudaErrorInvalidValue for
// arguments it refuses).

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 2048;  // sorted lookups a warp sums; hashgrid.CHUNK
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kAll = 0xffffffffu;

// starts[r] = the first sorted position whose key is at least r, for r in
// [0, rows]: row r's run is [starts[r], starts[r + 1]).
__global__ void starts_kernel(const int32_t* __restrict__ keys, int64_t m,
                              int rows, int32_t* __restrict__ starts) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       p <= m; p += stride) {
    const int prev = p > 0 ? keys[p - 1] : -1;
    const int cur = p < m ? keys[p] : rows;
    for (int r = max(prev + 1, 0); r <= min(cur, rows); ++r)
      starts[r] = static_cast<int32_t>(p);
  }
}

// One warp a chunk [lo, hi) of the sorted lookups: each run's sum goes to
// its row, or, for a run that crosses the chunk's edge, to the chunk's head
// or tail slot of `partial` [n_chunks, 2, F].
template <int F>
__global__ void __launch_bounds__(kThreads) chunk_kernel(
    const int32_t* __restrict__ keys, const int64_t* __restrict__ order,
    const float* __restrict__ w, const float* __restrict__ g, int64_t m,
    int corners, int64_t n_chunks, float* __restrict__ grad,
    float* __restrict__ partial) {
  const int lane = threadIdx.x & 31;
  const int64_t chunk =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (chunk >= n_chunks) return;  // the whole warp
  const int64_t lo = chunk * kChunk;
  const int64_t hi = lo + kChunk < m ? lo + kChunk : m;
  const int first = keys[lo];
  const bool head_open = lo > 0 && keys[lo - 1] == first;  // began before lo
  const int tail_key = hi < m ? keys[hi] : -1;             // goes on past hi
  float* head = partial + chunk * 2 * F;
  float* tail = head + F;
  auto emit = [&](int key, const float* v) {
    float* dst = (head_open && key == first) ? head
                 : key == tail_key           ? tail
                                             : grad + static_cast<int64_t>(key) * F;
#pragma unroll
    for (int f = 0; f < F; ++f) dst[f] = v[f];
  };

  int carry_key = -1;  // the run carried from the previous tile, if any
  float carry[F];
#pragma unroll
  for (int f = 0; f < F; ++f) carry[f] = 0.0f;
  // keys and order one tile ahead, so the gathers below wait on no load
  int64_t p = lo + lane;
  int key_next = p < hi ? keys[p] : INT_MAX;  // past hi: a key no row has
  int64_t j_next = p < hi ? order[p] : 0;
  for (int64_t base = lo; base < hi; base += 32) {
    const int key = key_next;
    const int64_t j = j_next;
    const bool valid = base + lane < hi;
    p = base + 32 + lane;
    key_next = p < hi ? keys[p] : INT_MAX;
    j_next = p < hi ? order[p] : 0;
    float v[F];
#pragma unroll
    for (int f = 0; f < F; ++f) v[f] = 0.0f;
    if (valid) {
      const float wj = w[j];
      const float* gj = g + (j / corners) * F;
#pragma unroll
      for (int f = 0; f < F; ++f) v[f] = __fmul_rn(wj, gj[f]);
    }
    // the carried run ended at the last tile's edge if this tile starts
    // another row
    const int tile_first = __shfl_sync(kAll, key, 0);
    if (carry_key >= 0 && tile_first != carry_key) {
      if (lane == 0) emit(carry_key, carry);
      carry_key = -1;
    }
    // inclusive scan of each run of equal keys (keys are sorted, so equal
    // keys d lanes apart mean one run between them); invalid lanes are the
    // tile's last and never feed a valid one
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int up_key = __shfl_up_sync(kAll, key, d);
      float up[F];
#pragma unroll
      for (int f = 0; f < F; ++f) up[f] = __shfl_up_sync(kAll, v[f], d);
      if (lane >= d && up_key == key) {
#pragma unroll
        for (int f = 0; f < F; ++f) v[f] += up[f];
      }
    }
    if (key == carry_key) {
#pragma unroll
      for (int f = 0; f < F; ++f) v[f] += carry[f];
    }
    const int last = hi - base > 32 ? 31 : static_cast<int>(hi - 1 - base);
    const int after = __shfl_down_sync(kAll, key, 1);
    if (lane < last && after != key) emit(key, v);  // a run ended in the tile
    // the tile's last run may go on into the next tile
    carry_key = __shfl_sync(kAll, key, last);
#pragma unroll
    for (int f = 0; f < F; ++f) carry[f] = __shfl_sync(kAll, v[f], last);
  }
  if (lane == 0) emit(carry_key, carry);
}

// One thread a row: 0 for a row no lookup hits; for a run that crossed
// chunks, its pieces added in chunk order (the first chunk's tail slot,
// then each later chunk's head slot). Rows inside one chunk are left as
// chunk_kernel wrote them.
template <int F>
__global__ void __launch_bounds__(kThreads) rows_kernel(
    const int32_t* __restrict__ starts, const float* __restrict__ partial,
    int rows, float* __restrict__ grad) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= rows) return;
  const int64_t s = starts[r];
  const int64_t e = starts[r + 1];
  float acc[F];
  if (s == e) {
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = 0.0f;
  } else {
    const int64_t cs = s / kChunk;
    const int64_t ce = (e - 1) / kChunk;
    if (cs == ce) return;
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = partial[(cs * 2 + 1) * F + f];
    for (int64_t c = cs + 1; c <= ce; ++c) {
#pragma unroll
      for (int f = 0; f < F; ++f) acc[f] += partial[c * 2 * F + f];
    }
  }
#pragma unroll
  for (int f = 0; f < F; ++f) grad[static_cast<int64_t>(r) * F + f] = acc[f];
}

template <int F>
int launch(const int32_t* keys, const int64_t* order, const float* w,
           const float* g, int64_t m, int corners, int rows, int32_t* starts,
           float* partial, float* grad, cudaStream_t s) {
  const int64_t start_blocks = (m + 1 + kThreads - 1) / kThreads;
  starts_kernel<<<static_cast<unsigned>(start_blocks), kThreads, 0, s>>>(
      keys, m, rows, starts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t n_chunks = (m + kChunk - 1) / kChunk;
  if (n_chunks > 0) {
    chunk_kernel<F><<<static_cast<unsigned>((n_chunks + kWarps - 1) / kWarps),
                      kThreads, 0, s>>>(keys, order, w, g, m, corners,
                                        n_chunks, grad, partial);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (rows > 0) {
    rows_kernel<F><<<(rows + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        starts, partial, rows, grad);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The gradient of one table [rows, F] (F 1, 2, 4 or 8) from its m lookups
// sorted by row: keys int32 [m] (sorted, each in [0, rows)), order int64
// [m] (the flat lookup id at each sorted position), w float32 [m] by flat
// id, g float32 [m / corners, F]. starts int32 [rows + 1] and partial
// float32 [ceil(m / 2048), 2, F] are scratch; grad is written whole.
int hashgrid_table_grad(const void* keys, const void* order, const void* w,
                        const void* g, int64_t m, int corners, int n_features,
                        int rows, void* starts, void* partial, void* grad,
                        void* stream) {
  if (m < 0 || m > INT_MAX || corners < 1 || m % corners != 0 || rows < 0 ||
      rows == INT_MAX)
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto k = static_cast<const int32_t*>(keys);
  const auto o = static_cast<const int64_t*>(order);
  const auto wf = static_cast<const float*>(w);
  const auto gf = static_cast<const float*>(g);
  const auto st = static_cast<int32_t*>(starts);
  const auto pa = static_cast<float*>(partial);
  const auto gr = static_cast<float*>(grad);
  switch (n_features) {
    case 1: return launch<1>(k, o, wf, gf, m, corners, rows, st, pa, gr, s);
    case 2: return launch<2>(k, o, wf, gf, m, corners, rows, st, pa, gr, s);
    case 4: return launch<4>(k, o, wf, gf, m, corners, rows, st, pa, gr, s);
    case 8: return launch<8>(k, o, wf, gf, m, corners, rows, st, pa, gr, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
