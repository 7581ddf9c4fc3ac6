// Per-tile front-to-back alpha blend of depth-sorted Gaussian splats and
// its gradient, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel gauspcc_tpu/render/pallas_blend.py:46
// (_blend_kernel, driven by blend_tiles at :92) together with the XLA
// record gather that fed it (gauspcc_tpu/render/raster.py:317-342). The
// TPU kernel needed the [T, K, 8] records gathered beforehand because
// gathers do not vectorise inside Mosaic; here each block gathers its
// tile's records itself, so the [T, K, 8] buffer never exists. Its
// gradient (backward_kernel, below) replaces the JAX package's autodiff
// of the XLA blend (raster.py:264-315): the Pallas kernel is eval-only.
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
//   r, g), (b, window, -, -), so the loop reads each record with vector
//   shared loads once for both pixels, all threads on one address, a
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
//   when any alpha of the warp lies near 1/255. The 1/255 cut is a step: an
//   alpha within rounding of it can be kept by one side and dropped by the
//   other, which moves a pixel by up to T / 255 * |colour - what lies
//   behind it|, beyond the tolerance. Two roundings did that: ex2.approx
//   against expf (3 values of one set of random tiles), and the fused power
//   against the plain version's, one product at a time (1 value of
//   another: one ulp of power put the alpha on 1/255 to the last bit). The
//   redo takes the power as the plain version rounds it and expf, so it
//   keeps and drops what the plain version does wherever the fast alpha
//   lies within the window of the plain one. The window is per record and
//   tile (near_cut_window): 1e-4 for the exponential's and the opacity's
//   roundings, plus 16 ulps of 1.0 times the largest sum of the quadratic
//   form's term magnitudes over the tile. The power is a sum of terms that
//   cancel for a thin Gaussian (terms of 10^4 at a power of -5.5 near 45
//   degrees), and each side's rounding of it is at most a few ulps of that
//   sum (3 for the fused form, 4 for the plain one). About 0.5% of a
//   warp's chunks redo on random tiles; the fast exponential was faster
//   than expf alone.
//
// The gradient (backward_kernel). The function above is differentiated as
// the kernel computes it: the early stop and T_final = T after the last
// entry blended. With g = dL/d(pixel) and G = out . g (out: the forward's
// image), each pixel's list is walked front to back, in the forward's
// order, records and schedule, keeping S_j = sum_{i<=j} w_i (c_i . g):
//   dL/dc_j     = w_j g
//   dL/dalpha_j = T_j (c_j . g) - (G - S_j) / (1 - alpha_j)
// and, for an entry blended below the 0.99 clamp, with e = exp(power):
//   dL/do_j = dL/dalpha_j e,  dL/dpower_j = dL/dalpha_j alpha_j
//   dpower/dmx = a dx + b dy, dpower/dmy = c dy + b dx,
//   dpower/d(a, b, c) = (-dx^2 / 2, -dx dy, -dy^2 / 2)
// (none through the power where it was clamped to 0). So the forward keeps
// no state for it. The alphas are computed by the forward's own code
// (record_alphas, the same chunks, redo and cut), so both keep and drop
// the same entries. A lane's 2 pixels' partials of a record (9 floats) are
// summed across the warp with __shfl_xor_sync, then 9 lanes add them into
// the record's Gaussian with one atomicAdd each; a warp whose lanes left no
// partial for a record skips both. Lanes whose pixels stopped stay in the
// loop and add zeros, as the full-mask shuffles need every lane. Bound: the
// forward's alpha work per evaluated pixel-entry, plus about 40 operations
// of gradient per blended one, plus the reduction per record and warp; the
// atomics write 36 B per Gaussian and warp that touched it. A reduction per
// tile through shared memory before the atomics is later work.
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
constexpr float kAlphaMax = 0.99f;
constexpr float kTMin = 1e-4f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kChunk = 8;  // records whose alphas are computed together
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kPartials = 9;  // gradient floats per record: rgb, o, mx, my, a, b, c

// (mx, my, A, B), (C, opacity, r, g), (b, window, -, -); A, B, C folded
// conic, window the record's near-cut window on its tile
struct Record {
  float4 a, b, c;
};

// The fast alpha is redone as the plain version computes it when it lies
// within `window` (relative) of 1/255 (near_cut_window): kNearCut for the
// exponential's and the opacity's roundings (the rounding of power *
// log2(e) over |power| <= 5.6, below which alpha < 1/255 for any opacity <=
// 1, and ex2.approx's own, about 1e-6 together), plus kNearCutPerTerm times
// the largest sum of the power's term magnitudes over the tile, which
// bounds the fused power's and the plain power's roundings (at most 3 and 4
// ulps of 1.0 times that sum; 16 leaves a factor of two).
constexpr float kNearCut = 1e-4f;
constexpr float kNearCutPerTerm = 16.0f * 5.9604645e-8f;

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The near-cut window of a record (conic (a, b, c) unfolded) on the tile
// whose pixels span [x0, x0 + 15] x [y0, y0 + 15]: the terms of power =
// -0.5 (a dx^2 + c dy^2) - b dx dy are largest at the tile's farthest
// corner from the mean.
__device__ __forceinline__ float near_cut_window(const Record& r, float x0,
                                                 float y0) {
  const float dx = fmaxf(fabsf(x0 - r.a.x), fabsf(x0 + (kTile - 1) - r.a.x));
  const float dy = fmaxf(fabsf(y0 - r.a.y), fabsf(y0 + (kTile - 1) - r.a.y));
  const float terms = 0.5f * fabsf(r.a.z) * dx * dx + fabsf(r.a.w) * dx * dy +
                      0.5f * fabsf(r.b.x) * dy * dy;
  return fmaf(kNearCutPerTerm, terms, kNearCut);
}

// The folded record of one Gaussian on the tile at (x0, y0): (A, B, C) =
// (-a/2, -b, -c/2), so that power = -0.5 (a dx^2 + c dy^2) - b dx dy =
// A dx^2 + B dx dy + C dy^2 (exact: the factors are powers of two), and
// the record's near-cut window.
__device__ __forceinline__ void fold(Record& r, float x0, float y0) {
  r.c.y = near_cut_window(r, x0, y0);
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

// Phase A, shared by the forward and the gradient: the alphas of C records
// at a thread's P pixels (0 below 1/255), C * P independent chains, none of
// which waits on T. The power is fused (FMAs on the folded conic) and the
// exp is ex2.approx(power * log2(e)); if any alpha of the warp lies within
// its record's window of 1/255, the chunk's alphas are all redone with
// plain_power and expf (one warp-uniform test per chunk, rarely taken), so
// the kernel keeps and drops the entries the plain version does. The
// forward votes among the lanes still blending (__activemask()); the
// gradient, whose lanes all stay in the loop, votes with `voting` the same
// lanes, so both redo the same chunks. kExp also returns exp(power) in
// `ex` (0 where alpha is dropped).
template <int C, int P, bool kExp>
__device__ __forceinline__ void record_alphas(
    const Record* __restrict__ rec, float px, const float (&py)[P],
    bool voting, float (&a)[C][P], float (&ex)[C][P]) {
  bool near = false;
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const float4 ra = rec[k].a;
    const float4 rb = rec[k].b;
    const float window = rec[k].c.y;
    const float dx = px - ra.x;
    const float adx2 = ra.z * dx * dx;
    const float bdx = ra.w * dx;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const float dy = py[i] - ra.y;
      const float power = fminf(fmaf(dy, fmaf(rb.x, dy, bdx), adx2), 0.0f);
      const float e = ex2_approx(power * kLog2e);
      const float alpha = fminf(kAlphaMax, rb.y * e);
      near |= fabsf(fmaf(alpha, 255.0f, -1.0f)) < window;
      a[k][i] = alpha >= kAlphaMin ? alpha : 0.0f;
      if constexpr (kExp) ex[k][i] = alpha >= kAlphaMin ? e : 0.0f;
    }
  }
  bool redo;
  if constexpr (kExp)
    redo = __any_sync(kFullMask, near && voting);
  else
    redo = __any_sync(__activemask(), near);
  if (redo) {
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const float4 ra = rec[k].a;
      const float4 rb = rec[k].b;
      const float dx = px - ra.x;
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const float dy = py[i] - ra.y;
        const float power = fminf(plain_power(ra, rb, dx, dy), 0.0f);
        const float e = expf(power);
        const float alpha = fminf(kAlphaMax, __fmul_rn(rb.y, e));
        a[k][i] = alpha >= kAlphaMin ? alpha : 0.0f;
        if constexpr (kExp) ex[k][i] = alpha >= kAlphaMin ? e : 0.0f;
      }
    }
  }
}

// Blends C records into a thread's P pixels: phase A (record_alphas), then
// phase B, the front-to-back recurrence: per record and pixel, T <- T (1 -
// a) while T >= 1e-4, a multiply and a select on the chain of T.
template <int C, int P>
__device__ __forceinline__ void blend_records(
    const Record* __restrict__ rec, float px, const float (&py)[P],
    float (&t)[P], float (&cr)[P], float (&cg)[P], float (&cb)[P]) {
  float a[C][P], unused[C][P], col[C][3];
  record_alphas<C, P, false>(rec, px, py, true, a, unused);
#pragma unroll
  for (int k = 0; k < C; ++k) {
    col[k][0] = rec[k].b.z;
    col[k][1] = rec[k].b.w;
    col[k][2] = rec[k].c.x;
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

// The gradient of C records at a thread's P pixels, in the forward's
// order: phase A as the forward, then per record the walk that updates T
// and S and forms the record's 9 partials over the thread's pixels, their
// sum over the warp, and the atomics of 9 lanes into the record's Gaussian
// (ids[k]). gr, gg, gb: dL/d(pixel); gsum: G = out . g per pixel.
template <int C, int P>
__device__ __forceinline__ void backward_records(
    const Record* __restrict__ rec, const int* __restrict__ ids, float px,
    const float (&py)[P], bool voting, float (&t)[P], float (&s)[P],
    const float (&gr)[P], const float (&gg)[P], const float (&gb)[P],
    const float (&gsum)[P], unsigned lane, float* __restrict__ g_mean2d,
    float* __restrict__ g_conic, float* __restrict__ g_opacity,
    float* __restrict__ g_colors) {
  float a[C][P], ex[C][P];
  record_alphas<C, P, true>(rec, px, py, voting, a, ex);
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const float4 ra = rec[k].a;
    const float4 rb = rec[k].b;
    const float col_b = rec[k].c.x;
    const float dx = px - ra.x;
    float p[kPartials];
#pragma unroll
    for (int j = 0; j < kPartials; ++j) p[j] = 0.0f;
    bool touched = false;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const float dy = py[i] - ra.y;
      const float al = a[k][i];
      const bool live = t[i] >= kTMin;
      const bool blended = live && al > 0.0f;
      const float cdotg = rb.z * gr[i] + rb.w * gg[i] + col_b * gb[i];
      const float w = blended ? al * t[i] : 0.0f;
      s[i] = fmaf(w, cdotg, s[i]);
      const float dal =
          (blended && al < kAlphaMax)
              ? t[i] * cdotg - __fdividef(gsum[i] - s[i], 1.0f - al)
              : 0.0f;
      t[i] = live ? t[i] * (1.0f - al) : t[i];
      touched |= blended;
      // none through the power where it was clamped to 0 (e == 1)
      const float dpow = ex[k][i] < 1.0f ? dal * al : 0.0f;
      p[0] = fmaf(w, gr[i], p[0]);
      p[1] = fmaf(w, gg[i], p[1]);
      p[2] = fmaf(w, gb[i], p[2]);
      p[3] = fmaf(dal, ex[k][i], p[3]);
      // dpower/dmx = a dx + b dy = -(2 A dx + B dy), dpower/dmy = c dy +
      // b dx = -(2 C dy + B dx); dpower/d(a, b, c) = (-dx^2/2, -dx dy,
      // -dy^2/2), from the folded (A, B, C) = (-a/2, -b, -c/2)
      p[4] -= dpow * fmaf(2.0f * ra.z, dx, ra.w * dy);
      p[5] -= dpow * fmaf(2.0f * rb.x, dy, ra.w * dx);
      p[6] -= 0.5f * dpow * dx * dx;
      p[7] -= dpow * dx * dy;
      p[8] -= 0.5f * dpow * dy * dy;
    }
    if (!__any_sync(kFullMask, touched)) continue;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int j = 0; j < kPartials; ++j)
        p[j] += __shfl_xor_sync(kFullMask, p[j], off);
    }
    if (lane < kPartials) {
      const int g = ids[k];
      float v = p[0];
      float* dst = g_colors + 3 * g;
#pragma unroll
      for (int j = 1; j < kPartials; ++j) {
        if (lane == static_cast<unsigned>(j)) {
          v = p[j];
          dst = j < 3   ? g_colors + 3 * g + j
                : j == 3 ? g_opacity + g
                : j < 6  ? g_mean2d + 2 * g + (j - 4)
                         : g_conic + 3 * g + (j - 6);
        }
      }
      atomicAdd(dst, v);
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

// The list indices of one batch of a tile's list, loaded by the threads
// that will stage them (-1 past the list).
__device__ __forceinline__ void load_indices(
    int (&gi)[kPerThread], const int32_t* __restrict__ pair_gauss, int tid,
    int start, int count, int batch) {
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) {
    const int j = tid + u * kThreads;
    const int e = batch * kBatch + j;
    gi[u] = (j < kBatch && e < count) ? pair_gauss[start + e] : -1;
  }
}

// Gathers the records of one batch into `buf` with cp.async, nine 4-byte
// copies each, straight from the per-Gaussian arrays; `ids`, if given,
// receives the Gaussians' indices.
__device__ __forceinline__ void stage(
    Record* buf, int* ids, const int (&gi)[kPerThread], int tid,
    const float* __restrict__ mean2d, const float* __restrict__ conic,
    const float* __restrict__ opacity, const float* __restrict__ colors) {
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
    if (ids != nullptr) ids[j] = g;
  }
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

// 4 resident blocks per SM, as the kernel had before its alphas were shared
// with the gradient (ptxas gave it 148 registers, 3 blocks, without the cap)
__global__ void __launch_bounds__(kThreads, 4) blend_kernel(
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
    const int x0 = (tile % tiles_x) * kTile, y0t = (tile / tiles_x) * kTile;
    const int x = x0 + (tid & (kTile - 1));
    const int y0 = y0t + tid / kTile;
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
    if (n_batches > 0) {
      load_indices(gi, pair_gauss, tid, start, count, 0);
      stage(s_rec[0], nullptr, gi, tid, mean2d, conic, opacity, colors);
    }
    cp_async_commit();
    if (n_batches > 1) load_indices(gi, pair_gauss, tid, start, count, 1);
    int done = 0;
    for (int b = 0; b < n_batches; ++b) {
      Record* cur = s_rec[b & 1];
      if (b + 1 < n_batches)
        stage(s_rec[(b + 1) & 1], nullptr, gi, tid, mean2d, conic, opacity,
              colors);
      cp_async_commit();
      if (b + 2 < n_batches)
        load_indices(gi, pair_gauss, tid, start, count, b + 2);
      cp_async_wait<1>();  // this thread's copies of batch b have landed
      const int n = min(kBatch, count - b * kBatch);
#pragma unroll
      for (int u = 0; u < kPerThread; ++u) {  // fold what this thread staged
        const int j = tid + u * kThreads;
        if (j < n) fold(cur[j], static_cast<float>(x0), static_cast<float>(y0t));
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

// The gradient of blend_kernel's image: the same schedule, staging, chunks
// and early stop, with the walk of backward_records in place of the
// blend. Adds into g_* (zeroed by the caller).
__global__ void __launch_bounds__(kThreads) backward_kernel(
    const int32_t* __restrict__ tile_start,  // [T + 1]
    const int32_t* __restrict__ pair_gauss,  // [pairs]
    const float* __restrict__ mean2d,        // [N, 2]
    const float* __restrict__ conic,         // [N, 3]
    const float* __restrict__ opacity,       // [N]
    const float* __restrict__ colors,        // [N, 3]
    const float* __restrict__ out,           // [3, H, W] the forward's image
    const float* __restrict__ grad_out,      // [3, H, W] dL/d(image)
    int n_tiles, int tiles_x, int height, int width, int max_k,
    int32_t* __restrict__ sched,             // Schedule, ordered
    float* __restrict__ g_mean2d,            // [N, 2]
    float* __restrict__ g_conic,             // [N, 3]
    float* __restrict__ g_opacity,           // [N]
    float* __restrict__ g_colors) {          // [N, 3]
  constexpr int P = kPixPerThread;
  __shared__ Record s_rec[2][kBatch];
  __shared__ int s_ids[2][kBatch];
  __shared__ int s_slot;

  const int tid = threadIdx.x;
  const unsigned lane = tid & 31;
  const int hw = height * width;

  Schedule sc(sched, n_tiles);
  if (tid == 0) s_slot = sc.first(n_tiles);
  __syncthreads();
  int slot = s_slot;
  __syncthreads();
  while (slot < n_tiles) {
    const int tile = sc.order[slot];
    const int start = tile_start[tile];
    const int count = min(tile_start[tile + 1] - start, max_k);
    const int n_batches = (count + kBatch - 1) / kBatch;
    const int x0 = (tile % tiles_x) * kTile, y0t = (tile / tiles_x) * kTile;
    const int x = x0 + (tid & (kTile - 1));
    const int y0 = y0t + tid / kTile;
    const float px = static_cast<float>(x);
    float py[P], t[P], s[P], gr[P], gg[P], gb[P], gsum[P];
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int y = y0 + kRowStep * i;
      py[i] = static_cast<float>(y);
      t[i] = 1.0f;
      s[i] = 0.0f;
      gr[i] = gg[i] = gb[i] = gsum[i] = 0.0f;
      if (x < width && y < height) {
        const int p = y * width + x;
        gr[i] = grad_out[p];
        gg[i] = grad_out[hw + p];
        gb[i] = grad_out[2 * hw + p];
        gsum[i] = out[p] * gr[i] + out[hw + p] * gg[i] + out[2 * hw + p] * gb[i];
      }
    }

    int gi[kPerThread];
    if (n_batches > 0) {
      load_indices(gi, pair_gauss, tid, start, count, 0);
      stage(s_rec[0], s_ids[0], gi, tid, mean2d, conic, opacity, colors);
    }
    cp_async_commit();
    if (n_batches > 1) load_indices(gi, pair_gauss, tid, start, count, 1);
    int done = 0;
    for (int b = 0; b < n_batches; ++b) {
      Record* cur = s_rec[b & 1];
      const int* ids = s_ids[b & 1];
      if (b + 1 < n_batches)
        stage(s_rec[(b + 1) & 1], s_ids[(b + 1) & 1], gi, tid, mean2d, conic,
              opacity, colors);
      cp_async_commit();
      if (b + 2 < n_batches)
        load_indices(gi, pair_gauss, tid, start, count, b + 2);
      cp_async_wait<1>();
      const int n = min(kBatch, count - b * kBatch);
#pragma unroll
      for (int u = 0; u < kPerThread; ++u) {
        const int j = tid + u * kThreads;
        if (j < n) fold(cur[j], static_cast<float>(x0), static_cast<float>(y0t));
      }
      __syncthreads();
      if (__any_sync(kFullMask, !done)) {  // warp-uniform
        const bool voting = !done;
        int k = 0;
        for (; k + kChunk <= n; k += kChunk)
          backward_records<kChunk, P>(cur + k, ids + k, px, py, voting, t, s,
                                      gr, gg, gb, gsum, lane, g_mean2d,
                                      g_conic, g_opacity, g_colors);
        for (; k < n; ++k)
          backward_records<1, P>(cur + k, ids + k, px, py, voting, t, s, gr,
                                 gg, gb, gsum, lane, g_mean2d, g_conic,
                                 g_opacity, g_colors);
        done = 1;
#pragma unroll
        for (int i = 0; i < P; ++i) done &= t[i] < kTMin;
      }
      if (__syncthreads_count(done) == kThreads) break;
    }
    cp_async_wait_all();
    if (tid == 0) s_slot = sc.pull(n_tiles);
    __syncthreads();
    slot = s_slot;
    __syncthreads();
  }
}

// resident blocks of each kernel a device holds, asked once per device
// (the occupancy query costs host time on every call otherwise)
constexpr int kMaxDevices = 64;
int g_resident[2][kMaxDevices];

const void* kernel_of(int backward) {
  return backward ? reinterpret_cast<const void*>(backward_kernel)
                  : reinterpret_cast<const void*>(blend_kernel);
}

// The persistent grid of the blend (backward = 0) or of the gradient
// (backward = 1): the resident blocks, at most one per tile.
int grid_blocks(int backward, int n_tiles, int* per_sm, int* rc) {
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
  int& resident = g_resident[backward ? 1 : 0][dev];
  if (resident == 0) {
    *rc = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, kernel_of(backward), kThreads, 0));
    if (*rc != 0) return 0;
    resident = *per_sm * sms;
  }
  *per_sm = sms ? resident / sms : 0;
  return resident < n_tiles ? resident : n_tiles;
}

}  // namespace

// shape[0..5] = blocks, threads, pixels per thread, static shared bytes,
// resident blocks per SM and registers per thread of the blend's launch
// (backward = 0) or the gradient's (backward = 1).
extern "C" int tile_blend_launch_shape(int backward, int n_tiles, int* shape) {
  int per_sm = 0, rc = 0;
  const int blocks = grid_blocks(backward, n_tiles, &per_sm, &rc);
  cudaFuncAttributes attr;
  if (rc == 0)
    rc = static_cast<int>(cudaFuncGetAttributes(&attr, kernel_of(backward)));
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
  const int blocks = grid_blocks(0, n_tiles, &per_sm, &rc);
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

// Launches order_kernel, then backward_kernel, on `stream` without
// synchronising: adds the gradient of the image `out` that
// tile_blend_forward made from the same inputs, given grad_out =
// dL/d(out), into g_mean2d [N, 2], g_conic [N, 3], g_opacity [N] and
// g_colors [N, 3], which the caller zeroes. `sched` as for the forward.
extern "C" int tile_blend_backward(
    const int32_t* tile_start, const int32_t* pair_gauss, const float* mean2d,
    const float* conic, const float* opacity, const float* colors,
    const float* out, const float* grad_out, int n_tiles, int tiles_x,
    int height, int width, int max_k, int32_t* sched, float* g_mean2d,
    float* g_conic, float* g_opacity, float* g_colors, void* stream) {
  if (n_tiles <= 0) return 0;
  int per_sm = 0, rc = 0;
  const int blocks = grid_blocks(1, n_tiles, &per_sm, &rc);
  if (rc != 0) return rc;
  if (blocks <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const auto s = static_cast<cudaStream_t>(stream);
  order_kernel<<<1, kOrderThreads, 0, s>>>(tile_start, n_tiles, max_k, sched);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  backward_kernel<<<blocks, kThreads, 0, s>>>(
      tile_start, pair_gauss, mean2d, conic, opacity, colors, out, grad_out,
      n_tiles, tiles_x, height, width, max_k, sched, g_mean2d, g_conic,
      g_opacity, g_colors);
  return static_cast<int>(cudaGetLastError());
}
