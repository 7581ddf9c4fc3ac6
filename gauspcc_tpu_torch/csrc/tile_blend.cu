// Per-tile front-to-back alpha blend of depth-sorted Gaussian splats
// (forward only), for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel gauspcc_tpu/render/pallas_blend.py:46
// (_blend_kernel, driven by blend_tiles at :92) together with the XLA
// record gather that fed it (gauspcc_tpu/render/raster.py:317-342). The
// TPU kernel needed the [T, K, 8] records gathered beforehand because
// gathers do not vectorise inside Mosaic; here each block gathers its
// tile's records itself, so the [T, K, 8] buffer never exists.
//
// Function, per 16x16 tile and per pixel, over the first min(count, K)
// entries of the tile's depth-sorted list:
//   alpha = min(0.99, opacity * exp(min(power, 0))), dropped below 1/255
//   w     = alpha * T_before, for T_before >= 1e-4 (T_before = prod(1 - alpha)
//           over the entries before it)
//   rgb   = sum(w * color) + T_final * bg
// JAX semantics, not the reference CUDA rasterizer's: the entry that takes
// T below 1e-4 is still blended (it uses T_before), and the background
// term uses T after every blended entry. A pixel stops once T < 1e-4:
// every later weight is 0, and T_final can only shrink further, so
// stopping changes the pixel by less than 1e-4 * max(bg).
//
// What bounds it on this card. The work is data-dependent: every pixel of
// a tile evaluates each entry of the tile's list until its T falls under
// 1e-4, and only about a tenth of the evaluated entries reach alpha >=
// 1/255 and are blended. Per evaluated pixel-entry that is an exp on the
// SFU (16 a clock per SM) and a few dozen issued instructions (the
// quadratic form, the exponential, the cut, the recurrence, the colour
// FMAs); the bytes (the lists, each Gaussian's 36 B record, the image)
// are far below either. So the kernel is bound by instruction issue and
// by the tiles' lists, which run from 0 to K entries: a list of K
// entries is one block's serial work, and the SMs that hold such lists
// set the time unless every SM gets an even share of them and of the
// rest.
//
// Design, and what each part does about that. One call of the C entry
// launches two kernels on the caller's stream: order_kernel (the
// schedule), then blend_kernel.
// - Two pixels per thread (128 threads per tile). A thread owns 2 pixels
//   of one column of its tile, 8 rows apart, reads each record from shared
//   memory once for both, computes the record's x terms once, and runs 2
//   independent T chains, which gives the scheduler independent work
//   between the SFU's and the FMAs' latencies. A thread stops when both
//   its pixels have T < 1e-4; the block leaves at a batch boundary once
//   every thread has (__syncthreads_count). Timed on the H100 at the eval
//   slice's lists against 1, 4 and 8 pixels per thread, 2 was fastest
//   (PERF.md).
// - Records staged as three 16-byte vectors, (mx, my, A, B), (C, opacity,
//   r, g), (b, -, -, -), so the loop makes two 128-bit and one 32-bit
//   shared loads per record for both pixels, all threads on one address, a
//   broadcast, where it made nine 32-bit loads per pixel before. A, B and
//   C fold the -0.5 and the cross term's sign into the conic once per
//   record (exactly: powers of two), so power = dy * (C * dy + B * dx) +
//   A * dx * dx is FMAs.
// - The gather overlaps the blend: two staging buffers of 64 records,
//   filled with cp.async (LDGSTS) and cp.async.wait_group, so batch b+1's
//   records are in flight while batch b is blended, and the list indices
//   of batch b+2 are loaded into registers a batch ahead. Hopper's TMA
//   cannot gather through an index list (its tiled and im2col modes copy
//   a regular box; gather4 is Blackwell's), so cp.async is the tool. Each
//   record is gathered straight from the per-Gaussian arrays with nine
//   4-byte copies and folded in shared memory by the thread that staged
//   it. (A pass that first packs every Gaussian's record as 48 aligned
//   bytes was slower: it writes the off-screen Gaussians' records too.)
// - Two phases per chunk of 8 records (blend_records). A long list's
//   time is one warp's serial path through it, so what matters is how
//   much independent work a warp has between T's updates. Phase A
//   computes all 8 x 2 alphas, which do not depend on T; phase B runs the
//   recurrence, a multiply and a select per record on T's chain. Both are
//   branch-free: some lane of a warp blends nearly every record, so a
//   branch would run both paths; an entry that is not blended gets alpha
//   0, which leaves colour and T bit for bit as they were.
// - A balanced tile schedule: a persistent grid (the occupancy API's
//   blocks per SM times the SMs, at most one block per tile) walks the
//   tiles longest list first. order_kernel sorts the tiles by length
//   bucket on the device (a counting sort in one block, no host sync) and
//   resets the scheduler's state, so no per-call fill is needed. A block's
//   first tile is dealt by its SM (%smid) and its rank among the SM's
//   blocks, in snake order over the sorted tiles (rank 0 takes SM j's
//   share of the longest, rank 1 the next ones in reverse, ...); later
//   tiles are pulled from a counter that walks the sorted tiles as blocks
//   free. A claim per tile (atomicExch) makes each tile blended exactly
//   once whatever the hardware's placement of blocks. (One block per tile
//   in tile order was 1.7x slower; dealing first tiles by block index put
//   up to 3 of the longest tiles on one SM, and half as much again as the
//   mean load on the busiest.)
// - No tensor cores. The TPU kernel needed the MXU for the exclusive
//   prefix sum of log(1 - alpha) over depth; one thread multiplying T
//   front to back needs no prefix sum. What is left as a contraction is
//   sum(w * color), N = 3, on the tenth of the entries that blend; wgmma
//   takes N >= 8 and 64-row tiles. The time is in evaluating alpha.
// - The exponential: ex2.approx of power * log2(e) (2 instructions, where
//   expf is 8: range reduction, ex2 and a scale), with the chunk redone
//   when any alpha of the warp lies within 1e-4 (relative) of 1/255. The
//   1/255 cut is a step: an alpha within rounding of it can be kept by one
//   side and dropped by the other, which moves a pixel by up to T / 255 *
//   |colour - what lies behind it|, beyond the tolerance. Two roundings
//   did that: ex2.approx against expf (3 values of one set of random
//   tiles), and the fused power against the plain version's, one product
//   at a time (1 value of another: one ulp of power put the alpha on
//   1/255 to the last bit). The redo takes the power as the plain version
//   rounds it and expf, so it keeps and drops what the plain version does
//   wherever the fast alpha lies within 1e-4 of the plain one: the
//   power's rounding for terms up to a few hundred, against the 5.6 at
//   which the cut lies. About 0.5% of a warp's chunks redo on random
//   tiles; the fast exponential was faster than expf alone.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;
constexpr int kPixPerThread = 2;
constexpr int kThreads = kPix / kPixPerThread;
constexpr int kRowStep = kThreads / kTile;  // rows between a thread's pixels
constexpr int kBatch = 64;    // records per staging buffer
constexpr int kPerThread = (kBatch + kThreads - 1) / kThreads;  // staged
constexpr int kBuckets = 64;  // list-length buckets of the schedule
constexpr int kOrderThreads = 1024;
constexpr int kMaxSmIds = 1024;  // per-SM rank counters of the schedule
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kTMin = 1e-4f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kChunk = 8;  // records whose alphas are computed together

// (mx, my, A, B), (C, opacity, r, g), (b, -, -, -); A, B, C folded conic
struct Record {
  float4 a, b, c;
};

// alpha within this relative distance of 1/255 is recomputed as the plain
// version computes it. The fast alpha is within about 1e-6 (relative) of
// expf's on the same power (the rounding of power * log2(e) over |power|
// <= 5.6, below which alpha < 1/255 for any opacity <= 1, and ex2.approx's
// own), plus the difference of the fused power from the plain one.
constexpr float kNearCut = 1e-4f;

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The folded record of one Gaussian: (A, B, C) = (-a/2, -b, -c/2), so that
// power = -0.5 (a dx^2 + c dy^2) - b dx dy = A dx^2 + B dx dy + C dy^2
// (exact: the factors are powers of two).
__device__ __forceinline__ void fold(Record& r) {
  r.a.z *= -0.5f;
  r.a.w = -r.a.w;
  r.b.x *= -0.5f;
}

// The power as the plain version rounds it, each product and sum in turn
// (no FMA contraction): -0.5 (a dx dx + c dy dy) - b dx dy, with the
// conic unfolded from the record (exact).
__device__ __forceinline__ float plain_power(const float4& ra,
                                             const float4& rb, float dx,
                                             float dy) {
  const float a = -2.0f * ra.z, b = -ra.w, c = -2.0f * rb.x;
  const float q = __fadd_rn(__fmul_rn(__fmul_rn(a, dx), dx),
                            __fmul_rn(__fmul_rn(c, dy), dy));
  return __fsub_rn(__fmul_rn(-0.5f, q), __fmul_rn(__fmul_rn(b, dx), dy));
}

// Blends C records into a thread's P pixels, in two phases. Phase A
// computes every alpha (dropped below 1/255): C * P independent chains,
// none of which waits on T. Its power is fused (FMAs on the folded conic)
// and its exp is ex2.approx(power * log2(e)); if any alpha of the warp
// lies within kNearCut of 1/255 the chunk's alphas are all redone with
// plain_power and expf (one warp-uniform test per chunk, rarely taken),
// so the kernel keeps and drops the entries the plain version does. Phase B
// runs the front-to-back recurrence: per record and pixel, T <- T (1 - a)
// while T >= 1e-4, a multiply and a select on the chain of T.
template <int C, int P>
__device__ __forceinline__ void blend_records(
    const Record* __restrict__ rec, float px, const float (&py)[P],
    float (&t)[P], float (&cr)[P], float (&cg)[P], float (&cb)[P]) {
  float a[C][P], col[C][3];
  bool near = false;
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const float4 ra = rec[k].a;
    const float4 rb = rec[k].b;
    col[k][0] = rb.z;
    col[k][1] = rb.w;
    col[k][2] = rec[k].c.x;
    const float dx = px - ra.x;
    const float adx2 = ra.z * dx * dx;
    const float bdx = ra.w * dx;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const float dy = py[i] - ra.y;
      const float power = fminf(fmaf(dy, fmaf(rb.x, dy, bdx), adx2), 0.0f);
      const float alpha = fminf(0.99f, rb.y * ex2_approx(power * kLog2e));
      near |= fabsf(fmaf(alpha, 255.0f, -1.0f)) < kNearCut;
      a[k][i] = alpha >= kAlphaMin ? alpha : 0.0f;
    }
  }
  if (__any_sync(__activemask(), near)) {
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const float4 ra = rec[k].a;
      const float4 rb = rec[k].b;
      const float dx = px - ra.x;
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const float dy = py[i] - ra.y;
        const float power = fminf(plain_power(ra, rb, dx, dy), 0.0f);
        const float alpha = fminf(0.99f, __fmul_rn(rb.y, expf(power)));
        a[k][i] = alpha >= kAlphaMin ? alpha : 0.0f;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < C; ++k) {
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const bool live = t[i] >= kTMin;
      const float w = live ? a[k][i] * t[i] : 0.0f;
      t[i] = live ? t[i] * (1.0f - a[k][i]) : t[i];
      cr[i] = fmaf(w, col[k][0], cr[i]);
      cg[i] = fmaf(w, col[k][1], cg[i]);
      cb[i] = fmaf(w, col[k][2], cb[i]);
    }
  }
}

__device__ __forceinline__ unsigned sm_id() {
  unsigned id;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(id));
  return id;
}

__device__ __forceinline__ unsigned sm_id_bound() {
  unsigned n;
  asm volatile("mov.u32 %0, %%nsmid;" : "=r"(n));
  return n;
}

// The schedule's scratch, int32: [0] the counter of the sorted walk,
// [1, 1 + T) the sorted tiles, [1 + T, 1 + 2T) the slots' claims, then
// kMaxSmIds rank counters.
struct Schedule {
  int32_t* counter;
  int32_t* order;
  int32_t* claimed;
  int32_t* rank;
  __device__ Schedule(int32_t* base, int n_tiles)
      : counter(base), order(base + 1), claimed(base + 1 + n_tiles),
        rank(base + 1 + 2 * n_tiles) {}

  // the next unclaimed slot of the sorted walk, or n_tiles
  __device__ int pull(int n_tiles) {
    for (;;) {
      const int s = atomicAdd(counter, 1);
      if (s >= n_tiles || atomicExch(&claimed[s], 1) == 0) return s;
    }
  }

  // a block's first slot: dealt by its SM and rank, in snake order
  __device__ int first(int n_tiles) {
    const unsigned j = sm_id();
    const unsigned ns = min(sm_id_bound(), static_cast<unsigned>(kMaxSmIds));
    if (j < ns) {
      const int r = atomicAdd(&rank[j], 1);
      const long long s = static_cast<long long>(r) * ns +
                          ((r & 1) ? ns - 1 - j : j);
      if (s < n_tiles && atomicExch(&claimed[s], 1) == 0)
        return static_cast<int>(s);
    }
    return pull(n_tiles);
  }
};

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ int length_bucket(int len, int max_k) {
  return len == 0 ? 0
                  : 1 + static_cast<int>(static_cast<int64_t>(len - 1) *
                                         (kBuckets - 1) / max_k);
}

// The schedule's order: the tiles by descending length bucket of
// min(count, max_k), a counting sort; and its state reset (counter,
// claims, rank counters).
__global__ void __launch_bounds__(kOrderThreads)
    order_kernel(const int32_t* __restrict__ tile_start, int n_tiles,
                 int max_k, int32_t* __restrict__ sched) {
  __shared__ int slot[kBuckets];
  const int tid = threadIdx.x;
  const Schedule sc(sched, n_tiles);
  if (tid < kBuckets) slot[tid] = 0;
  for (int i = tid; i < n_tiles; i += kOrderThreads) sc.claimed[i] = 0;
  for (int i = tid; i < kMaxSmIds; i += kOrderThreads) sc.rank[i] = 0;
  __syncthreads();
  for (int i = tid; i < n_tiles; i += kOrderThreads) {
    const int len = min(tile_start[i + 1] - tile_start[i], max_k);
    atomicAdd(&slot[length_bucket(len, max_k)], 1);
  }
  __syncthreads();
  if (tid == 0) {
    int run = 0;
    for (int b = kBuckets - 1; b >= 0; --b) {
      const int c = slot[b];
      slot[b] = run;
      run += c;
    }
    sched[0] = 0;
  }
  __syncthreads();
  for (int i = tid; i < n_tiles; i += kOrderThreads) {
    const int len = min(tile_start[i + 1] - tile_start[i], max_k);
    sched[1 + atomicAdd(&slot[length_bucket(len, max_k)], 1)] = i;
  }
}

__global__ void __launch_bounds__(kThreads) blend_kernel(
    const int32_t* __restrict__ tile_start,  // [T + 1]
    const int32_t* __restrict__ pair_gauss,  // [pairs]
    const float* __restrict__ mean2d,        // [N, 2]
    const float* __restrict__ conic,         // [N, 3]
    const float* __restrict__ opacity,       // [N]
    const float* __restrict__ colors,        // [N, 3]
    const float* __restrict__ bg,            // [3]
    int n_tiles, int tiles_x, int height, int width, int max_k,
    int32_t* __restrict__ sched,             // Schedule, ordered
    float* __restrict__ out) {               // [3, H, W]
  constexpr int P = kPixPerThread;
  __shared__ Record s_rec[2][kBatch];
  __shared__ int s_slot;

  const int tid = threadIdx.x;
  const float bg_r = bg[0], bg_g = bg[1], bg_b = bg[2];
  const int hw = height * width;

  Schedule sc(sched, n_tiles);
  if (tid == 0) s_slot = sc.first(n_tiles);
  __syncthreads();
  int slot = s_slot;
  __syncthreads();  // every thread has read s_slot before it is rewritten
  while (slot < n_tiles) {
    const int tile = sc.order[slot];
    const int start = tile_start[tile];
    const int count = min(tile_start[tile + 1] - start, max_k);
    const int n_batches = (count + kBatch - 1) / kBatch;
    const int x = (tile % tiles_x) * kTile + (tid & (kTile - 1));
    const int y0 = (tile / tiles_x) * kTile + tid / kTile;
    const float px = static_cast<float>(x);
    float py[P], t[P], cr[P], cg[P], cb[P];
#pragma unroll
    for (int i = 0; i < P; ++i) {
      py[i] = static_cast<float>(y0 + kRowStep * i);
      t[i] = 1.0f;
      cr[i] = cg[i] = cb[i] = 0.0f;
    }

    // list indices of one batch, loaded a batch before they are staged
    int gi[kPerThread];
    auto load_indices = [&](int batch) {
#pragma unroll
      for (int u = 0; u < kPerThread; ++u) {
        const int j = tid + u * kThreads;
        const int e = batch * kBatch + j;
        gi[u] = (j < kBatch && e < count) ? pair_gauss[start + e] : -1;
      }
    };
    auto stage = [&](Record* buf) {
#pragma unroll
      for (int u = 0; u < kPerThread; ++u) {
        const int j = tid + u * kThreads;
        if (j >= kBatch || gi[u] < 0) continue;
        const int g = gi[u];
        Record* r = buf + j;
        cp_async4(&r->a.x, mean2d + 2 * g);
        cp_async4(&r->a.y, mean2d + 2 * g + 1);
        cp_async4(&r->a.z, conic + 3 * g);
        cp_async4(&r->a.w, conic + 3 * g + 1);
        cp_async4(&r->b.x, conic + 3 * g + 2);
        cp_async4(&r->b.y, opacity + g);
        cp_async4(&r->b.z, colors + 3 * g);
        cp_async4(&r->b.w, colors + 3 * g + 1);
        cp_async4(&r->c.x, colors + 3 * g + 2);
      }
    };

    if (n_batches > 0) {
      load_indices(0);
      stage(s_rec[0]);
    }
    cp_async_commit();
    if (n_batches > 1) load_indices(1);
    int done = 0;
    for (int b = 0; b < n_batches; ++b) {
      Record* cur = s_rec[b & 1];
      if (b + 1 < n_batches) stage(s_rec[(b + 1) & 1]);
      cp_async_commit();
      if (b + 2 < n_batches) load_indices(b + 2);
      cp_async_wait<1>();  // this thread's copies of batch b have landed
      const int n = min(kBatch, count - b * kBatch);
#pragma unroll
      for (int u = 0; u < kPerThread; ++u) {  // fold what this thread staged
        const int j = tid + u * kThreads;
        if (j < n) fold(cur[j]);
      }
      __syncthreads();  // batch b visible to every thread
      if (!done) {
        int k = 0;
        for (; k + kChunk <= n; k += kChunk)
          blend_records<kChunk, P>(cur + k, px, py, t, cr, cg, cb);
        for (; k < n; ++k) blend_records<1, P>(cur + k, px, py, t, cr, cg, cb);
        done = 1;
#pragma unroll
        for (int i = 0; i < P; ++i) done &= t[i] < kTMin;
      }
      // also the barrier that frees batch b's buffer for batch b+2
      if (__syncthreads_count(done) == kThreads) break;
    }
    cp_async_wait_all();  // a batch still in flight when the tile stopped

#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int y = y0 + kRowStep * i;
      if (x < width && y < height) {
        const int p = y * width + x;
        out[p] = cr[i] + t[i] * bg_r;
        out[hw + p] = cg[i] + t[i] * bg_g;
        out[2 * hw + p] = cb[i] + t[i] * bg_b;
      }
    }
    if (tid == 0) s_slot = sc.pull(n_tiles);
    __syncthreads();  // s_slot written; the staging buffers are free
    slot = s_slot;
    __syncthreads();  // every thread has read s_slot before it is rewritten
  }
}

// resident blocks of blend_kernel a device holds, asked once per device
// (the occupancy query costs host time on every call otherwise)
constexpr int kMaxDevices = 64;
int g_resident[kMaxDevices];

// The persistent grid: the resident blocks, at most one per tile.
int grid_blocks(int n_tiles, int* per_sm, int* rc) {
  int dev = 0, sms = 0;
  *per_sm = 0;
  *rc = static_cast<int>(cudaGetDevice(&dev));
  if (*rc != 0) return 0;
  if (dev >= kMaxDevices) {
    *rc = static_cast<int>(cudaErrorInvalidDevice);
    return 0;
  }
  *rc = static_cast<int>(
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  if (*rc != 0) return 0;
  int& resident = g_resident[dev];
  if (resident == 0) {
    *rc = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, reinterpret_cast<const void*>(blend_kernel), kThreads, 0));
    if (*rc != 0) return 0;
    resident = *per_sm * sms;
  }
  *per_sm = sms ? resident / sms : 0;
  return resident < n_tiles ? resident : n_tiles;
}

}  // namespace

// shape[0..5] = blocks, threads, pixels per thread, static shared bytes,
// resident blocks per SM and registers per thread of the blend launch.
extern "C" int tile_blend_launch_shape(int n_tiles, int* shape) {
  int per_sm = 0, rc = 0;
  const int blocks = grid_blocks(n_tiles, &per_sm, &rc);
  cudaFuncAttributes attr;
  if (rc == 0)
    rc = static_cast<int>(cudaFuncGetAttributes(
        &attr, reinterpret_cast<const void*>(blend_kernel)));
  if (rc != 0) return rc;
  shape[0] = blocks;
  shape[1] = kThreads;
  shape[2] = kPixPerThread;
  shape[3] = static_cast<int>(attr.sharedSizeBytes);
  shape[4] = per_sm;
  shape[5] = attr.numRegs;
  return 0;
}

// Launches order_kernel, then blend_kernel, on `stream` without
// synchronising. `sched` is the schedule's scratch, 1 + 2 n_tiles + 1024
// int32 (see Schedule); order_kernel fills it. Returns the first CUDA
// error, so the caller sees a refused launch.
extern "C" int tile_blend_forward(
    const int32_t* tile_start, const int32_t* pair_gauss, const float* mean2d,
    const float* conic, const float* opacity, const float* colors,
    const float* bg, int n_tiles, int tiles_x, int height, int width,
    int max_k, int32_t* sched, float* out, void* stream) {
  if (n_tiles <= 0) return 0;
  int per_sm = 0, rc = 0;
  const int blocks = grid_blocks(n_tiles, &per_sm, &rc);
  if (rc != 0) return rc;
  if (blocks <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const auto s = static_cast<cudaStream_t>(stream);
  order_kernel<<<1, kOrderThreads, 0, s>>>(tile_start, n_tiles, max_k, sched);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  blend_kernel<<<blocks, kThreads, 0, s>>>(tile_start, pair_gauss, mean2d,
                                           conic, opacity, colors, bg,
                                           n_tiles, tiles_x, height, width,
                                           max_k, sched, out);
  return static_cast<int>(cudaGetLastError());
}
