// Sequential person merge for the pose decoder.
//
// Replaces the JAX package's TPU kernel
// torch_ekpose_tpu/ops/pallas_merge.py::merge_people_pallas_batched
// (_merge_kernel; merge_people_pallas is its B = 1 wrapper). Per image, a
// loop over the n_valid pre-compacted connections: each one extends,
// merges or opens a row of a [cap, 20] person table (cols 0-17 peak ids,
// col 18 the score sum, col 19 the part count), exactly as
// decode/device.py::_merge_loop_xla does:
//   found == 1: row[p2] = cid2, score += peak2 + conn, count += 1,
//               guarded by row[p2] != cid2;
//   found == 2: if the two rows share no part (> 0 test on cols 0-17)
//               merge row 2 into row 1 and deactivate row 2, else treat
//               row 1 as in found == 1 without the guard;
//   found == 0: open a row when pair < 18 and fewer than cap rows exist;
//   found >= 3: nothing.
//
// Bound on this card: latency. Each connection reads the table the
// previous one wrote, so an image is one dependent chain of a few hundred
// short steps; the bytes (a 7.5 KB table) are nothing. Design: one warp
// per image, the table in shared memory, no block-wide barrier. Lane l
// owns rows l, l + 32, l + 64, ...: one __ballot_sync per 32 rows gives
// the matching rows, and the lowest set bits give the first two matches.
// The row update then runs with lane c on column c. The additions keep
// the twin's association, e.g. row[18] + (sc2 + score) and
// (sc1 + sc2) + score, and use selects, so the result equals the twin
// bit for bit. The active flags are bit masks every lane holds
// identically. An image with n_valid = 0 only writes the empty table.
//
// Plain C interface, bound with ctypes by ops/_build.py.

#include <cuda_runtime.h>

namespace {

constexpr int kCols = 20;
constexpr int kParts = 18;
constexpr int kWarp = 32;
constexpr int kMaxCap = 128;
constexpr int kWords = kMaxCap / kWarp;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kWarp)
merge_people_kernel(const int* __restrict__ pair, const int* __restrict__ p1,
                    const int* __restrict__ p2, const int* __restrict__ cid1,
                    const int* __restrict__ cid2,
                    const float* __restrict__ score,
                    const int* __restrict__ n_valid,
                    const float* __restrict__ peak,
                    float* __restrict__ subset,
                    unsigned char* __restrict__ active_out, int n_slots,
                    int n_peaks, int cap) {
  __shared__ float table[kMaxCap * kCols];
  const int img = blockIdx.x;
  const int lane = threadIdx.x;
  const int words = (cap + kWarp - 1) / kWarp;
  float* out = subset + static_cast<size_t>(img) * cap * kCols;
  unsigned char* act_out = active_out + static_cast<size_t>(img) * cap;
  const int nv = min(n_valid[img], n_slots);
  if (nv <= 0) {
    for (int e = lane; e < cap * kCols; e += kWarp) out[e] = -1.0f;
    for (int r = lane; r < cap; r += kWarp) act_out[r] = 0;
    return;
  }
  for (int e = lane; e < cap * kCols; e += kWarp) table[e] = -1.0f;
  unsigned active[kWords] = {0u, 0u, 0u, 0u};
  int n_rows = 0;
  __syncwarp();

  const size_t conn0 = static_cast<size_t>(img) * n_slots;
  const float* peaks = peak + static_cast<size_t>(img) * n_peaks;
  for (int s = 0; s < nv; ++s) {
    const int pr = pair[conn0 + s];
    const int a = p1[conn0 + s];
    const int b = p2[conn0 + s];
    const int c1 = cid1[conn0 + s];
    const int c2 = cid2[conn0 + s];
    const float sc = score[conn0 + s];
    const float c1f = static_cast<float>(c1);
    const float c2f = static_cast<float>(c2);
    const float sc1 = peaks[max(c1, 0)];
    const float sc2 = peaks[max(c2, 0)];

    // rows holding cid1 in column p1 or cid2 in column p2
    int found = 0, m1 = -1, m2 = -1;
    for (int j = 0; j < words; ++j) {
      const int r = j * kWarp + lane;
      bool hit = false;
      if (r < cap && ((active[j] >> lane) & 1u)) {
        hit = table[r * kCols + a] == c1f || table[r * kCols + b] == c2f;
      }
      const unsigned mask = __ballot_sync(kFull, hit);
      found += __popc(mask);
      unsigned rest = mask;
      while (rest != 0u && m2 < 0) {
        const int row = j * kWarp + __ffs(rest) - 1;
        if (m1 < 0) {
          m1 = row;
        } else {
          m2 = row;
        }
        rest &= rest - 1u;
      }
    }

    if (found == 1 || found == 2) {
      const float r1 = lane < kCols ? table[m1 * kCols + lane] : 0.0f;
      const float r2 =
          (found == 2 && lane < kCols) ? table[m2 * kCols + lane] : 0.0f;
      const bool overlap =
          found == 2 &&
          __ballot_sync(kFull, lane < kParts && r1 > 0.0f && r2 > 0.0f) != 0u;
      // set_p2: row[p2] = cid2; score += peak2 + conn; count += 1
      const float p2v = lane == b    ? c2f
                        : lane == 18 ? r1 + (sc2 + sc)
                        : lane == 19 ? r1 + 1.0f
                                     : r1;
      float v;
      if (found == 1) {
        v = table[m1 * kCols + b] != c2f ? p2v : r1;
      } else if (overlap) {
        v = p2v;
      } else {
        v = lane < kParts ? r1 + (r2 + 1.0f)
            : lane == 18  ? r1 + (r2 + sc)
                          : r1 + r2;
      }
      __syncwarp();  // every read of the rows happens before the write
      if (lane < kCols) table[m1 * kCols + lane] = v;
      if (found == 2 && !overlap) active[m2 / kWarp] &= ~(1u << (m2 % kWarp));
    } else if (found == 0 && pr < kParts && n_rows < cap) {
      const float v = lane == b    ? c2f
                      : lane == a  ? c1f
                      : lane == 18 ? (sc1 + sc2) + sc
                      : lane == 19 ? 2.0f
                                   : -1.0f;
      if (lane < kCols) table[n_rows * kCols + lane] = v;
      active[n_rows / kWarp] |= 1u << (n_rows % kWarp);
      ++n_rows;
    }
    __syncwarp();
  }

  for (int e = lane; e < cap * kCols; e += kWarp) out[e] = table[e];
  for (int r = lane; r < cap; r += kWarp) {
    act_out[r] = (active[r / kWarp] >> (r % kWarp)) & 1u;
  }
}

}  // namespace

extern "C" int ekp_merge_people(const int* pair, const int* p1, const int* p2,
                                const int* cid1, const int* cid2,
                                const float* score, const int* n_valid,
                                const float* peak, float* subset,
                                unsigned char* active, int b, int n_slots,
                                int n_peaks, int cap, void* stream) {
  if (b > 0 && cap > 0) {
    merge_people_kernel<<<b, kWarp, 0, static_cast<cudaStream_t>(stream)>>>(
        pair, p1, p2, cid1, cid2, score, n_valid, peak, subset, active,
        n_slots, n_peaks, cap);
  }
  return static_cast<int>(cudaGetLastError());
}
