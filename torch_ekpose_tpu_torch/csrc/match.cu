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
// small matrices and the K rounds of one matrix are a dependent chain.
//
// Design: one block per matrix. Its 256 threads stage the tile into
// dynamic shared memory with 4-byte cp.async, all in flight at once, rows
// padded to ld = K | 1 floats (odd), so 32 lanes reading one column of 32
// rows hit 32 banks. Then one warp runs the chain alone, in registers and
// warp-wide votes, with no block-wide barrier. Lane l owns the R =
// ceil(K / 32) rows l, l + 32, ... (R is a template parameter, so every
// per-row loop is unrolled and unguarded but the last) and caches each
// row's masked max and its column (the lowest on ties; a row with nothing
// above -inf is dead, column -1). A round: one redux.sync takes the max
// of an order-preserving 32-bit key of each lane's best cached value; R
// ballots of "my row j holds that value", read lowest j first, give the
// lowest row (lane + 32 j), and R shuffles its cached column. Marking the
// row used kills its cache entry. Marking the column c used invalidates
// only the rows whose cached column c was: masking only ever lowers values
// to -inf, so a row whose argmax c' is not c keeps both its max and c'
// (every column below c' holds less). Those rows are rescanned one after
// another by the whole warp, each lane loading its R columns lane + 32 i
// that are still unused. The old max first: the columns left of c hold
// less, so if any column still holds it, R ballots give the lowest such
// column and the max stands; only if none does, one redux.sync takes the
// new max and R ballots its lowest column. The used columns are one
// register a lane (bit i: column lane + 32 i).
//
// Why this shape (clock64 per phase on an H100, the tie-heavy test
// scores): with one warp a matrix the chain is pure latency, ~5 cycles a
// dependent instruction, ~30 an LDS, ~44 a redux.sync, ~24 a shuffle. A
// full reduction for every rescanned row cost ~300-630 cycles a row, in
// series, 76-92% of the kernel at K >= 96; lanes rescanning their own
// rows in parallel, one column at a time, cost ~1,300-8,800 cycles a
// rescanned row, each column a dependent LDS; the old max first brings a
// rescan to ~210-370. A packed 64-bit (value, row) key would need two
// shuffles a step, 10 dependent shuffles. The tile alone limits K:
// K (K | 1) floats within the 227 KB a block may opt into, so K <= 241
// (ops/match.py::smem_bytes, MAX_K).
//
// Plain C interface, bound with ctypes by ops/_build.py.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;  // threads that stage the tile
constexpr unsigned kFull = 0xffffffffu;

// the tile [k][k | 1] (ops/match.py::smem_bytes)
size_t smem_bytes(int k) {
  return sizeof(float) * static_cast<size_t>(k) * (k | 1);
}

// monotone float -> unsigned map; -0 maps as +0, so equal floats (the
// ties the rules break by index) get equal keys
__device__ __forceinline__ unsigned order_key(float v) {
  unsigned u = __float_as_uint(v);
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// The lowest index lane + 32 j whose hit[j] holds in some lane, or -1;
// *col is the same lane's col[j].
template <int R>
__device__ __forceinline__ int lowest_hit(const bool (&hit)[R],
                                          const int (&col)[R], int* c) {
  int at = -1;
#pragma unroll
  for (int j = R - 1; j >= 0; --j) {  // the lowest j with a hit wins
    const unsigned b = __ballot_sync(kFull, hit[j]);
    const int src = __ffs(b) - 1;
    const int cj = __shfl_sync(kFull, col[j], src < 0 ? 0 : src);
    if (b) {
      at = src + kWarp * j;
      *c = cj;
    }
  }
  return at;
}

// The lowest index i * 32 + lane whose hit[i] holds in some lane, or -1.
template <int R>
__device__ __forceinline__ int lowest_index(const bool (&hit)[R]) {
  int at = -1;
#pragma unroll
  for (int i = R - 1; i >= 0; --i) {  // the lowest i with a hit wins
    const unsigned b = __ballot_sync(kFull, hit[i]);
    if (b) at = __ffs(b) - 1 + kWarp * i;
  }
  return at;
}

template <int R>
__global__ void __launch_bounds__(kThreads)
greedy_match_kernel(const float* __restrict__ scores, int* __restrict__ ia,
                    int* __restrict__ ib, float* __restrict__ out_score,
                    unsigned char* __restrict__ out_valid, int k) {
  extern __shared__ float tile[];
  const int ld = k | 1;
  const int mat = blockIdx.x;
  const int lane = threadIdx.x % kWarp;
  {  // warp w stages rows w, w + 8, ...: each a coalesced row of K floats
    const float* src = scores + static_cast<size_t>(mat) * k * k;
    for (int r = threadIdx.x / kWarp; r < k; r += kThreads / kWarp)
      for (int c = lane; c < k; c += kWarp)
        cp_async4(tile + r * ld + c, src + r * k + c);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
  }
  if (threadIdx.x >= kWarp) return;  // one warp runs the chain

  const float neg = -CUDART_INF_F;
  const unsigned neg_key = order_key(neg);
  // lane + 32 i < k for every i < R - 1; only the last may fall outside
  const bool last_in = lane + kWarp * (R - 1) < k;
  const int last = last_in ? lane + kWarp * (R - 1) : k - 1;
  // the cache: row lane + 32 j's masked max and column (-1: dead row)
  float rmax[R];
  int rcol[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    rmax[j] = neg;
    rcol[j] = -1;
  }
#pragma unroll 4
  for (int c = 0; c < k; ++c) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int r = j < R - 1 ? lane + kWarp * j : last;
      float v = tile[r * ld + c];
      if (j == R - 1 && !last_in) v = neg;
      const bool up = v > rmax[j];  // strict: the lowest column keeps a tie
      rmax[j] = up ? v : rmax[j];
      rcol[j] = up ? c : rcol[j];
    }
  }

  int* const out_a = ia + static_cast<size_t>(mat) * k;
  int* const out_b = ib + static_cast<size_t>(mat) * k;
  float* const out_s = out_score + static_cast<size_t>(mat) * k;
  unsigned char* const out_v = out_valid + static_cast<size_t>(mat) * k;
  unsigned col_used = 0u;  // bit i: column lane + 32 i
  int t = 0;
  for (; t < k; ++t) {
    float lv = rmax[0];
#pragma unroll
    for (int j = 1; j < R; ++j) lv = fmaxf(lv, rmax[j]);
    const unsigned best = __reduce_max_sync(kFull, order_key(lv));
    if (best == neg_key) break;  // nothing left: every later round fails too
    const float bv = key_value(best);
    bool hit[R];
#pragma unroll
    for (int j = 0; j < R; ++j) hit[j] = rmax[j] == bv;
    int col = 0;
    const int row = lowest_hit<R>(hit, rcol, &col);
#pragma unroll
    for (int j = 0; j < R; ++j) {  // the row is taken: its entry dies
      const bool me = lane + kWarp * j == row;
      rmax[j] = me ? neg : rmax[j];
      rcol[j] = me ? -1 : rcol[j];
    }
    col_used |= lane == col % kWarp ? 1u << (col / kWarp) : 0u;
    if (lane == 0) {
      out_a[t] = row;
      out_b[t] = col;
      out_s[t] = bv;
      out_v[t] = 1;
    }

    // rescan the rows whose cached column was taken
#pragma unroll
    for (int j = 0; j < R; ++j) {
      for (unsigned lanes = __ballot_sync(kFull, rcol[j] == col); lanes;
           lanes &= lanes - 1u) {
        const int src = __ffs(lanes) - 1;
        const float old = __shfl_sync(kFull, rmax[j], src);
        const float* rowp = tile + (src + kWarp * j) * ld;
        float v[R];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const bool in = (i < R - 1 || last_in) && !((col_used >> i) & 1u);
          v[i] = rowp[i < R - 1 ? lane + kWarp * i : last];
          v[i] = in ? v[i] : neg;
        }
        bool eq[R];
#pragma unroll
        for (int i = 0; i < R; ++i) eq[i] = v[i] == old;
        float nv = old;
        int nc = lowest_index<R>(eq);  // the max stands further right
        if (nc < 0) {                  // it fell: the new max, lowest column
          float lm = v[0];
#pragma unroll
          for (int i = 1; i < R; ++i) lm = fmaxf(lm, v[i]);
          const unsigned m = __reduce_max_sync(kFull, order_key(lm));
          nv = neg;
          if (m != neg_key) {
            nv = key_value(m);
#pragma unroll
            for (int i = 0; i < R; ++i) eq[i] = v[i] == nv;
            nc = lowest_index<R>(eq);
          }
        }
        rmax[j] = lane == src ? nv : rmax[j];
        rcol[j] = lane == src ? nc : rcol[j];
      }
    }
  }
  for (int u = t + lane; u < k; u += kWarp) {
    out_a[u] = -1;
    out_b[u] = -1;
    out_s[u] = 0.0f;
    out_v[u] = 0;
  }
}

template <int R>
int launch(const float* scores, int* ia, int* ib, float* out_score,
           unsigned char* out_valid, int n_mats, int k, cudaStream_t stream) {
  const size_t smem = smem_bytes(k);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        greedy_match_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  greedy_match_kernel<R><<<n_mats, kThreads, smem, stream>>>(
      scores, ia, ib, out_score, out_valid, k);
  return static_cast<int>(cudaGetLastError());
}

// The latency the chain pays: one warp runs n dependent shuffles, then n
// dependent redux.sync reductions, timed by the SM's clock. A probe for
// the kernel's latency bound; no path calls it.
__global__ void latency_probe_kernel(long long* out, int n) {
  unsigned v = threadIdx.x;
  const long long t0 = clock64();
  for (int i = 0; i < n; ++i) v = __shfl_xor_sync(kFull, v, 1);
  const long long t1 = clock64();
  for (int i = 0; i < n; ++i) v = __reduce_max_sync(kFull, v);
  const long long t2 = clock64();
  if (threadIdx.x == 0) {
    out[0] = t1 - t0;
    out[1] = t2 - t1;
    out[2] = v;  // keeps both chains
  }
}

}  // namespace

// out: 3 int64 (cycles of n shuffles, cycles of n reductions, a sink)
extern "C" int ekp_match_latency_probe(long long* out, int n, void* stream) {
  latency_probe_kernel<<<1, kWarp, 0, static_cast<cudaStream_t>(stream)>>>(
      out, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ekp_greedy_match(const float* scores, int* ia, int* ib,
                                float* out_score, unsigned char* out_valid,
                                int n_mats, int k, void* stream) {
  if (n_mats <= 0 || k <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((k + kWarp - 1) / kWarp) {  // rows a lane owns
    case 1: return launch<1>(scores, ia, ib, out_score, out_valid, n_mats, k, s);
    case 2: return launch<2>(scores, ia, ib, out_score, out_valid, n_mats, k, s);
    case 3: return launch<3>(scores, ia, ib, out_score, out_valid, n_mats, k, s);
    case 4: return launch<4>(scores, ia, ib, out_score, out_valid, n_mats, k, s);
    case 5: return launch<5>(scores, ia, ib, out_score, out_valid, n_mats, k, s);
    case 6: return launch<6>(scores, ia, ib, out_score, out_valid, n_mats, k, s);
    case 7: return launch<7>(scores, ia, ib, out_score, out_valid, n_mats, k, s);
    case 8: return launch<8>(scores, ia, ib, out_score, out_valid, n_mats, k, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
