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
// previous one wrote, so an image is one dependent chain of n_valid short
// steps (a few tens to a few hundred); the bytes are nothing.
//
// Design. One block of 128 threads per image. All four warps stage a
// chunk of up to kChunk connections in shared memory with coalesced
// loads, and with each connection's two peak scores already looked up, so
// the peak table is read off the chain and K is not limited here. Then
// warp 0 alone walks the chunk; no global load sits on the step-to-step
// chain. The table lives in dynamic shared memory, column-major
// [20][cap_pad] with cap_pad = cap | 1 odd: the scan of one column by 32
// lanes reads 32 consecutive words, and the row update by 20 lanes (lane
// c on column c) reads words cap_pad apart, both free of bank conflicts.
// Lane l owns rows l, l + 32, l + 64, ... and holds their active flags as
// bits (bit j: row 32 j + l); one __ballot_sync per 32 rows gives the
// matching rows, in row order, and the lowest set bits give the first two
// matches. The scan stops after the rows opened so far. A step has no
// divergent branch: the flags are read and updated by selects in every
// lane, so no reconvergence point sits on the chain. The additions keep
// the twin's association, e.g. row[18] + (sc2 + score) and (sc1 + sc2) +
// score, and use selects, so the result equals the twin bit for bit. An
// image with n_valid = 0 only writes the empty table.
//
// Latency model: kernel time = a few us (launch, staging, the table's
// init and copy-out) + steps x per-step time, the steps being the batch's
// largest n_valid. Measured by scripts/profile_torch_decode.py (NVIDIA
// H100 80GB HBM3, 700 W, SM clock ~1.95 GHz by a timed spin): a step took
// ~600 ns (~1,200 cycles) when its fields and peak scores came from
// global memory and its flags went through branches (76 steps 0.0461 ms;
// 188 steps 0.125 ms); staging alone made it ~400-570 ns; with the flags
// and the first two matches by selects it takes ~250 ns (~500 cycles)
// with up to 32 opened rows and ~370 ns (~720 cycles) with up to 96
// (0.0224 and 0.0724 ms). What remains is the step's dependent chain:
// two shared-memory reads, a vote, the row reads, a vote and a shuffle,
// the selects and the write, each waiting on the one before.
//
// Shared memory: 8 kChunk words of staged fields plus 20 cap_pad words of
// table, within the 227 KB a block may opt into: cap <= 2495
// (ops/merge.py::smem_bytes, MAX_CAP).
//
// Plain C interface, bound with ctypes by ops/_build.py.

#include <cuda_runtime.h>

namespace {

constexpr int kCols = 20;
constexpr int kParts = 18;
constexpr int kWarp = 32;
constexpr int kThreads = 128;
constexpr int kChunk = 1024;      // connections staged at a time
constexpr int kActRegs = 3;       // active bits per lane: 96 -> cap <= 3072
constexpr unsigned kFull = 0xffffffffu;

// staged fields, then the table (ops/merge.py::smem_bytes)
size_t smem_bytes(int cap) {
  return sizeof(float) * (8 * static_cast<size_t>(kChunk) +
                          kCols * static_cast<size_t>(cap | 1));
}

// Bit j of this lane's active set (row 32 j + lane), by selects: a branch
// per register word would put a reconvergence point on every step.
__device__ __forceinline__ bool active(const unsigned (&act)[kActRegs],
                                       int j) {
  unsigned word = act[0];
#pragma unroll
  for (int w = 1; w < kActRegs; ++w) word = j / kWarp == w ? act[w] : word;
  return (word >> (j % kWarp)) & 1u;
}

// Sets (on) or clears row `row`'s flag, held by lane row % 32; every lane
// runs it, so the warp does not diverge.
__device__ __forceinline__ void mark(unsigned (&act)[kActRegs], int row,
                                     int lane, bool on) {
  const int j = row / kWarp;
  const unsigned m = row % kWarp == lane ? 1u << (j % kWarp) : 0u;
#pragma unroll
  for (int w = 0; w < kActRegs; ++w) {
    const unsigned mw = j / kWarp == w ? m : 0u;
    act[w] = on ? (act[w] | mw) : (act[w] & ~mw);
  }
}

__global__ void __launch_bounds__(kThreads)
merge_people_kernel(const int* __restrict__ pair, const int* __restrict__ p1,
                    const int* __restrict__ p2, const int* __restrict__ cid1,
                    const int* __restrict__ cid2,
                    const float* __restrict__ score,
                    const int* __restrict__ n_valid,
                    const float* __restrict__ peak,
                    float* __restrict__ subset,
                    unsigned char* __restrict__ active_out, int n_slots,
                    int n_peaks, int cap) {
  extern __shared__ float smem[];
  const int img = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  float* out = subset + static_cast<size_t>(img) * cap * kCols;
  unsigned char* act_out = active_out + static_cast<size_t>(img) * cap;
  const int nv = min(n_valid[img], n_slots);
  if (nv <= 0) {
    for (int e = tid; e < cap * kCols; e += kThreads) out[e] = -1.0f;
    for (int r = tid; r < cap; r += kThreads) act_out[r] = 0;
    return;
  }

  int* s_pair = reinterpret_cast<int*>(smem);
  int* s_a = s_pair + kChunk;
  int* s_b = s_a + kChunk;
  float* s_c1 = reinterpret_cast<float*>(s_b + kChunk);
  float* s_c2 = s_c1 + kChunk;
  float* s_sc = s_c2 + kChunk;
  float* s_sc1 = s_sc + kChunk;
  float* s_sc2 = s_sc1 + kChunk;
  float* table = s_sc2 + kChunk;  // [kCols][ld]
  const int ld = cap | 1;
  for (int e = tid; e < kCols * ld; e += kThreads) table[e] = -1.0f;

  unsigned act[kActRegs] = {};  // warp 0: bit j of lane l = row 32 j + l
  int n_rows = 0;
  const size_t conn0 = static_cast<size_t>(img) * n_slots;
  const float* peaks = peak + static_cast<size_t>(img) * n_peaks;
  for (int base = 0; base < nv; base += kChunk) {
    const int n = min(kChunk, nv - base);
    __syncthreads();  // warp 0 is done with the previous chunk
#pragma unroll 4
    for (int i = tid; i < n; i += kThreads) {
      const size_t g = conn0 + base + i;
      const int c1 = cid1[g], c2 = cid2[g];
      s_pair[i] = pair[g];
      s_a[i] = p1[g];
      s_b[i] = p2[g];
      s_c1[i] = static_cast<float>(c1);
      s_c2[i] = static_cast<float>(c2);
      s_sc[i] = score[g];
      s_sc1[i] = peaks[max(c1, 0)];
      s_sc2[i] = peaks[max(c2, 0)];
    }
    __syncthreads();  // the chunk (and the cleared table) is staged
    if (tid >= kWarp) continue;

    // the staged fields are read-only during the walk, so each step's are
    // loaded one step ahead, off the chain
    int pr = s_pair[0], a = s_a[0], b = s_b[0];
    float c1f = s_c1[0], c2f = s_c2[0], sc = s_sc[0];
    float sc1 = s_sc1[0], sc2 = s_sc2[0];
    for (int s = 0; s < n; ++s) {
      const int t = min(s + 1, n - 1);
      const int pr_next = s_pair[t], a_next = s_a[t], b_next = s_b[t];
      const float c1_next = s_c1[t], c2_next = s_c2[t], sc_next = s_sc[t];
      const float sc1_next = s_sc1[t], sc2_next = s_sc2[t];
      const float* col_a = table + a * ld;
      const float* col_b = table + b * ld;

      // rows holding cid1 in column p1 or cid2 in column p2, in row order
      // (a lane past the opened rows reads a row it ignores: never active);
      // the first two come from the ballots' lowest bits, by selects. The
      // loop has no early exit, so the compiler can batch its reads.
      const int words = (n_rows + kWarp - 1) / kWarp;
      int found = 0, m1 = -1, m2 = -1;
#pragma unroll 4
      for (int j = 0; j < words; ++j) {
        const int r = min(j * kWarp + lane, cap - 1);
        const bool hit =
            active(act, j) & ((col_a[r] == c1f) | (col_b[r] == c2f));
        const unsigned mask = __ballot_sync(kFull, hit);
        const unsigned rest = mask & (mask - 1u);
        const int lo = mask != 0u ? j * kWarp + __ffs(mask) - 1 : -1;
        const int next = rest != 0u ? j * kWarp + __ffs(rest) - 1 : -1;
        m2 = m2 >= 0 ? m2 : m1 >= 0 ? lo : next;
        m1 = m1 >= 0 ? m1 : lo;
        found += __popc(mask);
      }

      if (found == 1 || found == 2) {
        const float r1 = lane < kCols ? table[lane * ld + m1] : 0.0f;
        const float r2 =
            (found == 2 && lane < kCols) ? table[lane * ld + m2] : 0.0f;
        const bool overlap =
            found == 2 &&
            __ballot_sync(kFull, lane < kParts && r1 > 0.0f && r2 > 0.0f) !=
                0u;
        // set_p2: row[p2] = cid2; score += peak2 + conn; count += 1
        const float p2v = lane == b    ? c2f
                          : lane == 18 ? r1 + (sc2 + sc)
                          : lane == 19 ? r1 + 1.0f
                                       : r1;
        const float row1_b = __shfl_sync(kFull, r1, b);
        float v;
        if (found == 1) {
          v = row1_b != c2f ? p2v : r1;
        } else if (overlap) {
          v = p2v;
        } else {
          v = lane < kParts ? r1 + (r2 + 1.0f)
              : lane == 18  ? r1 + (r2 + sc)
                            : r1 + r2;
        }
        // lane c reads and writes column c only: no barrier before this
        if (lane < kCols) table[lane * ld + m1] = v;
        if (found == 2 && !overlap) mark(act, m2, lane, false);
      } else if (found == 0 && pr < kParts && n_rows < cap) {
        const float v = lane == b    ? c2f
                        : lane == a  ? c1f
                        : lane == 18 ? (sc1 + sc2) + sc
                        : lane == 19 ? 2.0f
                                     : -1.0f;
        if (lane < kCols) table[lane * ld + n_rows] = v;
        mark(act, n_rows, lane, true);
        ++n_rows;
      }
      pr = pr_next, a = a_next, b = b_next;
      c1f = c1_next, c2f = c2_next, sc = sc_next;
      sc1 = sc1_next, sc2 = sc2_next;
      __syncwarp();  // this step's writes are seen by the next step's scan
    }
  }
  __syncthreads();  // warp 0's last write is seen by every thread

  for (int e = tid; e < cap * kCols; e += kThreads)
    out[e] = table[(e % kCols) * ld + e / kCols];
  if (tid < kWarp) {
    for (int r = lane; r < cap; r += kWarp)
      act_out[r] = active(act, r / kWarp) ? 1 : 0;
  }
}

}  // namespace

extern "C" int ekp_merge_people(const int* pair, const int* p1, const int* p2,
                                const int* cid1, const int* cid2,
                                const float* score, const int* n_valid,
                                const float* peak, float* subset,
                                unsigned char* active, int b, int n_slots,
                                int n_peaks, int cap, void* stream) {
  if (cap > kActRegs * kWarp * kWarp)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b > 0 && cap > 0) {
    const size_t smem = smem_bytes(cap);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          merge_people_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    merge_people_kernel<<<b, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
        pair, p1, p2, cid1, cid2, score, n_valid, peak, subset, active,
        n_slots, n_peaks, cap);
  }
  return static_cast<int>(cudaGetLastError());
}
