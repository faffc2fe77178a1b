// Greedy 1:1 limb matching for the pose decoder.
//
// Replaces the JAX package's TPU kernel
// torch_ekpose_tpu/ops/pallas_match.py::greedy_match_pallas (_match_kernel):
// for each [K, K] candidate matrix (-inf = invalid), K rounds of masked
// argmax. Ties go to the lowest row, then the lowest column. A round
// accepts while the max is above -inf and then marks its row and column
// used; once a round finds nothing, every later slot is -1 / 0.0 / false.
//
// Bound on this card: latency, not bytes or FLOPs. A decode has B x 19
// small matrices (K = 32: 4 KB each) and the K rounds of one matrix are a
// dependent chain. Design: one warp per matrix, so the whole chain runs
// in registers and shared memory with warp shuffles and no block-wide
// barrier. The tile sits in shared memory with rows padded to K + 1
// floats, so the 32 lanes reading one column of 32 rows hit 32 banks.
// Lane r owns rows r and r + 32 (K <= 64). Each round a lane finds the
// masked max of its rows (lowest column on ties), then a 5-step shuffle
// reduction picks the largest value, lowest row on ties. The used rows
// and columns are two 64-bit masks that every lane holds identically.
//
// Plain C interface, bound with ctypes by ops/_build.py.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kMaxK = 64;
constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kWarp)
greedy_match_kernel(const float* __restrict__ scores, int* __restrict__ ia,
                    int* __restrict__ ib, float* __restrict__ out_score,
                    unsigned char* __restrict__ out_valid, int k) {
  __shared__ float tile[kMaxK * (kMaxK + 1)];
  const int mat = blockIdx.x;
  const int lane = threadIdx.x;
  const int ld = k + 1;
  const float* src = scores + static_cast<size_t>(mat) * k * k;
  for (int e = lane; e < k * k; e += kWarp) {
    tile[(e / k) * ld + e % k] = src[e];
  }
  __syncwarp();

  const size_t base = static_cast<size_t>(mat) * k;
  const float neg = -CUDART_INF_F;
  unsigned long long used_a = 0ull, used_b = 0ull;
  int t = 0;
  for (; t < k; ++t) {
    float best = neg;
    int best_row = kMaxK;  // sentinel: loses every tie
    int best_col = 0;
    for (int r = lane; r < k; r += kWarp) {
      const bool row_used = (used_a >> r) & 1ull;
      float rmax = neg;
      int rcol = 0;
      for (int c = 0; c < k; ++c) {
        const bool masked = row_used || ((used_b >> c) & 1ull);
        const float v = masked ? neg : tile[r * ld + c];
        if (c == 0 || v > rmax) {
          rmax = v;
          rcol = c;
        }
      }
      // rows ascend, so only a strictly larger max replaces the best
      if (best_row == kMaxK || rmax > best) {
        best = rmax;
        best_row = r;
        best_col = rcol;
      }
    }
    for (int off = kWarp / 2; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(kFull, best, off);
      const int orow = __shfl_xor_sync(kFull, best_row, off);
      const int ocol = __shfl_xor_sync(kFull, best_col, off);
      if (ov > best || (ov == best && orow < best_row)) {
        best = ov;
        best_row = orow;
        best_col = ocol;
      }
    }
    if (!(best > neg)) break;  // nothing left: every later round fails too
    if (lane == 0) {
      ia[base + t] = best_row;
      ib[base + t] = best_col;
      out_score[base + t] = best;
      out_valid[base + t] = 1;
    }
    used_a |= 1ull << best_row;
    used_b |= 1ull << best_col;
  }
  for (int u = t + lane; u < k; u += kWarp) {
    ia[base + u] = -1;
    ib[base + u] = -1;
    out_score[base + u] = 0.0f;
    out_valid[base + u] = 0;
  }
}

}  // namespace

extern "C" int ekp_greedy_match(const float* scores, int* ia, int* ib,
                                float* out_score, unsigned char* out_valid,
                                int n_mats, int k, void* stream) {
  if (n_mats > 0 && k > 0) {
    greedy_match_kernel<<<n_mats, kWarp, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        scores, ia, ib, out_score, out_valid, k);
  }
  return static_cast<int>(cudaGetLastError());
}
