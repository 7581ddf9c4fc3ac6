// Per-tile front-to-back alpha blend of depth-sorted Gaussian splats
// (forward only), for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel gauspcc_tpu/render/pallas_blend.py:46
// (_blend_kernel, driven by blend_tiles at :92) together with the XLA
// record gather that fed it (gauspcc_tpu/render/raster.py:317-342). The
// TPU kernel needed the [T, K, 8] records gathered beforehand because
// gathers do not vectorise inside Mosaic; here each block gathers its own
// tile's records straight from the per-Gaussian arrays, so the [T, K, 8]
// buffer never exists in device memory.
//
// Function, per 16x16 tile and per pixel, over the first min(count, K)
// entries of the tile's depth-sorted list:
//   alpha = min(0.99, opacity * exp(min(power, 0))), dropped below 1/255
//   w     = alpha * T_before, for T_before >= 1e-4 (T_before = prod(1 - alpha)
//           over the entries before it)
//   rgb   = sum(w * color) + T_final * bg
// JAX semantics, not the reference CUDA rasterizer's: the entry that takes
// T below 1e-4 is still blended (it uses T_before). A pixel stops once
// T < 1e-4: every later weight is 0, and T_final can only shrink further,
// so stopping changes the pixel by less than 1e-4 * max(bg).
//
// Bound at the eval slice's shapes (512x512, 1024 tiles, K = 1024): at most
// 262,144 pixels x 1024 entries = 268 M pixel-entries, each 15 fp32
// operations and one exp to evaluate, and 10 more to blend where alpha >=
// 1/255. That is at most 6.7 GFLOP, 0.10 ms at the H100's 67 TFLOP/s fp32
// peak (chip_smoke.py counts what a frame's data needs), against at most
// 1 M records x 40 B (index + 9 floats) plus 3 MB of output, 0.013 ms at
// 3.35 TB/s: the kernel is bound by operations, and by the per-pixel
// sequential dependence of T.
//
// Design: one block per tile, one thread per pixel. The block stages 256
// records at a time into shared memory (one coalesced index load and one
// gather per thread), then every thread walks the batch; all threads read
// the same shared address, which is a broadcast without bank conflicts.
// Each record is read from device memory once per tile it falls in. The
// block leaves its loop as soon as every pixel has saturated
// (__syncthreads_count), which is what keeps the work data-dependent: a
// saturated tile costs only the entries its pixels needed.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;  // threads per block, one per pixel
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kTMin = 1e-4f;

__global__ void __launch_bounds__(kPix) tile_blend_kernel(
    const int32_t* __restrict__ tile_start,  // [T + 1]
    const int32_t* __restrict__ pair_gauss,  // [P]
    const float* __restrict__ mean2d,        // [N, 2]
    const float* __restrict__ conic,         // [N, 3]
    const float* __restrict__ opacity,       // [N]
    const float* __restrict__ colors,        // [N, 3]
    const float* __restrict__ bg,            // [3]
    int tiles_x, int height, int width, int max_k,
    float* __restrict__ out) {               // [3, H, W]
  __shared__ float s_mx[kPix], s_my[kPix];
  __shared__ float s_ca[kPix], s_cb[kPix], s_cc[kPix], s_op[kPix];
  __shared__ float s_r[kPix], s_g[kPix], s_b[kPix];

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int x = (tile % tiles_x) * kTile + tid % kTile;
  const int y = (tile / tiles_x) * kTile + tid / kTile;
  const float px = static_cast<float>(x);
  const float py = static_cast<float>(y);

  const int start = tile_start[tile];
  const int count = min(tile_start[tile + 1] - start, max_k);

  float t = 1.0f, r = 0.0f, g = 0.0f, b = 0.0f;
  int done = 0;
  for (int base = 0; base < count; base += kPix) {
    // also the barrier that frees the previous batch's shared records
    if (__syncthreads_count(done) == kPix) break;
    const int j = base + tid;
    if (j < count) {
      const int gi = pair_gauss[start + j];
      s_mx[tid] = mean2d[2 * gi];
      s_my[tid] = mean2d[2 * gi + 1];
      s_ca[tid] = conic[3 * gi];
      s_cb[tid] = conic[3 * gi + 1];
      s_cc[tid] = conic[3 * gi + 2];
      s_op[tid] = opacity[gi];
      s_r[tid] = colors[3 * gi];
      s_g[tid] = colors[3 * gi + 1];
      s_b[tid] = colors[3 * gi + 2];
    }
    __syncthreads();
    const int n = min(kPix, count - base);
    for (int k = 0; k < n && !done; ++k) {
      const float dx = px - s_mx[k];
      const float dy = py - s_my[k];
      const float power =
          -0.5f * (s_ca[k] * dx * dx + s_cc[k] * dy * dy) - s_cb[k] * dx * dy;
      const float alpha = fminf(0.99f, s_op[k] * expf(fminf(power, 0.0f)));
      if (alpha < kAlphaMin) continue;
      const float w = alpha * t;
      r += w * s_r[k];
      g += w * s_g[k];
      b += w * s_b[k];
      t *= 1.0f - alpha;
      done = t < kTMin;
    }
  }

  if (x < width && y < height) {
    const int hw = height * width;
    const int p = y * width + x;
    out[p] = r + t * bg[0];
    out[hw + p] = g + t * bg[1];
    out[2 * hw + p] = b + t * bg[2];
  }
}

}  // namespace

// Launches on `stream` without synchronising; returns cudaGetLastError()
// so the caller sees a refused launch.
extern "C" int tile_blend_forward(const int32_t* tile_start,
                                  const int32_t* pair_gauss,
                                  const float* mean2d, const float* conic,
                                  const float* opacity, const float* colors,
                                  const float* bg, int n_tiles, int tiles_x,
                                  int height, int width, int max_k, float* out,
                                  void* stream) {
  if (n_tiles > 0) {
    tile_blend_kernel<<<n_tiles, kPix, 0, static_cast<cudaStream_t>(stream)>>>(
        tile_start, pair_gauss, mean2d, conic, opacity, colors, bg, tiles_x,
        height, width, max_k, out);
  }
  return static_cast<int>(cudaGetLastError());
}
