// Host-side packed neighbor maps of the GausPcgc codec's general sparse
// conv: the port's copy of gauspcc_tpu/native/neighbor.cpp (`key3` :33,
// `run_parallel` :41, `nm_build_packed` :184), built by
// gauspcc_tpu_torch/native.py `load_host` and bound in ops/hostmap.py
// `build_map_packed`. It serves the host-built geometry (codec version 6),
// whose maps are built on the host and shipped to the card packed.
//
// Conventions (as gauspcc_tpu_torch/ops/sparse.py):
//   - coords are non-negative int32 [N, 3] (x, y, z), lex-sorted with z
//     most significant, unique, valid prefix of the padded capacity.
//   - kernel tap t = ((dz+r)*k + (dy+r))*k + (dx+r), x fastest.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

// Packed lex key, z most significant. Coords are biased so small negative
// probe values stay ordered; valid for coords < 2^20.
inline int64_t key3(int32_t x, int32_t y, int32_t z) {
  return ((int64_t)(z + 8) << 42) | ((int64_t)(y + 8) << 21) | (int64_t)(x + 8);
}

inline int64_t key_row(const int32_t* c, int64_t i) {
  return key3(c[3 * i], c[3 * i + 1], c[3 * i + 2]);
}

void run_parallel(int64_t n_tasks, int n_threads,
                  const std::function<void(int64_t)>& fn) {
  if (n_threads <= 1 || n_tasks <= 1) {
    for (int64_t t = 0; t < n_tasks; ++t) fn(t);
    return;
  }
  std::atomic<int64_t> next(0);
  std::vector<std::thread> pool;
  int nt = std::min<int64_t>(n_threads, n_tasks);
  pool.reserve(nt);
  for (int i = 0; i < nt; ++i) {
    pool.emplace_back([&] {
      for (int64_t t; (t = next.fetch_add(1)) < n_tasks;) fn(t);
    });
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// Packed neighbor map: per (dz, dy) kernel row, the window START
// `lo[row][q]` (lower_bound of (qz+dz, qy+dy, qx-r) in the sorted
// sources) plus a 3-bit field per x-offset bin giving the window slot
// holding that neighbor (7 = none):
//   slot = (codes[row][q] >> (3 * dxbin)) & 7;  idx = lo + slot.
// 6 bytes/child/row instead of 4*k of the dense table, which is what
// crosses from the host to the device. Requires k <= 5.
int64_t nm_build_packed(const int32_t* coords, int64_t n, int64_t ncap,
                        int32_t k, int32_t n_threads, int32_t* out_lo,
                        uint16_t* out_codes) {
  if (k < 1 || k > 5 || n < 0 || ncap < n) return -1;
  const int32_t r = k / 2;
  const int64_t k2 = (int64_t)k * k;
  std::memset(out_lo, 0, sizeof(int32_t) * k2 * ncap);
  // 7 in every field = no neighbor
  std::memset(out_codes, 0xff, sizeof(uint16_t) * k2 * ncap);
  if (n == 0) return 0;

  std::vector<int64_t> keys((size_t)n);
  for (int64_t i = 0; i < n; ++i) keys[i] = key_row(coords, i);

  const int64_t block = 65536;
  const int64_t n_blocks = (n + block - 1) / block;
  std::function<void(int64_t)> task = [&](int64_t t) {
    const int64_t row = t / n_blocks;
    const int64_t b = t % n_blocks;
    const int32_t dz = (int32_t)(row / k) - r;
    const int32_t dy = (int32_t)(row % k) - r;
    const int64_t q0 = b * block;
    const int64_t q1 = std::min(n, q0 + block);
    int64_t lo_key = key3(coords[3 * q0] - r, coords[3 * q0 + 1] + dy,
                          coords[3 * q0 + 2] + dz);
    int64_t p = std::lower_bound(keys.begin(), keys.end(), lo_key) -
                keys.begin();
    for (int64_t q = q0; q < q1; ++q) {
      const int32_t qx = coords[3 * q];
      const int32_t qy = coords[3 * q + 1] + dy;
      const int32_t qz = coords[3 * q + 2] + dz;
      const int64_t lo = key3(qx - r, qy, qz);
      while (p < n && keys[p] < lo) ++p;
      uint16_t code = 0x7fff;  // all fields = 7
      for (int64_t s = p; s < n && s < p + k; ++s) {
        if (coords[3 * s + 2] != qz || coords[3 * s + 1] != qy) break;
        const int32_t dx = coords[3 * s] - qx;
        if (dx > r) break;
        const int32_t bin = dx + r;
        code = (uint16_t)((code & ~(7u << (3 * bin))) |
                          ((uint32_t)(s - p) << (3 * bin)));
      }
      out_lo[row * ncap + q] = (int32_t)p;
      out_codes[row * ncap + q] = code;
    }
  };
  run_parallel(k2 * n_blocks, n_threads, task);
  return 0;
}

}  // extern "C"
