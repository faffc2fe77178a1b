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
// barrier. The tile sits in dynamic shared memory with rows padded to
// ld = K | 1 floats (odd), so the 32 lanes reading one column of 32 rows
// hit 32 banks. Lane l owns rows l, l + 32, l + 64, ... Each round a lane
// finds the masked max of its rows (lowest column on ties), then a 5-step
// shuffle reduction picks the largest value, lowest row on ties. The used
// rows are a bit set per lane (bit j: row l + 32 j); the used columns are
// a bit array of ceil(K / 32) words in shared memory that every lane
// reads whole words of. Neither limits K: the tile does, K (K | 1) floats
// within the 227 KB a block may opt into, so K <= 241
// (ops/match.py::smem_bytes, MAX_K).
//
// Plain C interface, bound with ctypes by ops/_build.py.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;

// the tile [k][k | 1] and the used-column words (ops/match.py::smem_bytes)
size_t smem_bytes(int k) {
  return sizeof(float) * (static_cast<size_t>(k) * (k | 1) + (k + 31) / 32);
}

__global__ void __launch_bounds__(kWarp)
greedy_match_kernel(const float* __restrict__ scores, int* __restrict__ ia,
                    int* __restrict__ ib, float* __restrict__ out_score,
                    unsigned char* __restrict__ out_valid, int k) {
  extern __shared__ float tile[];
  const int ld = k | 1;
  const int words = (k + kWarp - 1) / kWarp;
  unsigned* col_used = reinterpret_cast<unsigned*>(tile + k * ld);
  const int mat = blockIdx.x;
  const int lane = threadIdx.x;
  const float* src = scores + static_cast<size_t>(mat) * k * k;
  for (int e = lane; e < k * k; e += kWarp) {
    tile[(e / k) * ld + e % k] = src[e];
  }
  for (int w = lane; w < words; w += kWarp) col_used[w] = 0u;
  __syncwarp();

  const size_t base = static_cast<size_t>(mat) * k;
  const float neg = -CUDART_INF_F;
  unsigned row_used = 0u;  // bit j: row lane + 32 j
  int t = 0;
  for (; t < k; ++t) {
    float best = neg;
    int best_row = INT_MAX;  // sentinel: loses every tie
    int best_col = 0;
    for (int j = 0, r = lane; r < k; ++j, r += kWarp) {
      // a used row is all -inf: its max is -inf at column 0
      float rmax = neg;
      int rcol = 0;
      if (!((row_used >> j) & 1u)) {
        const float* row = tile + r * ld;
        for (int w = 0; w < words; ++w) {
          const unsigned used = col_used[w];
          const int c0 = w * kWarp, n = min(kWarp, k - c0);
          for (int i = 0; i < n; ++i) {
            const float v = ((used >> i) & 1u) ? neg : row[c0 + i];
            if (c0 + i == 0 || v > rmax) {
              rmax = v;
              rcol = c0 + i;
            }
          }
        }
      }
      // rows ascend, so only a strictly larger max replaces the best
      if (best_row == INT_MAX || rmax > best) {
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
      col_used[best_col / kWarp] |= 1u << (best_col % kWarp);
    }
    if (best_row % kWarp == lane) row_used |= 1u << (best_row / kWarp);
    __syncwarp();  // lane 0's column bit is seen by the next round
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
    const size_t smem = smem_bytes(k);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          greedy_match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    greedy_match_kernel<<<n_mats, kWarp, smem,
                          static_cast<cudaStream_t>(stream)>>>(
        scores, ia, ib, out_score, out_valid, k);
  }
  return static_cast<int>(cudaGetLastError());
}
