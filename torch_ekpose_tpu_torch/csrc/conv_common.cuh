// Pieces of the fused bf16 3x3 conv chain kernel (conv_chain.cu).
//
// A fused kernel keeps one output tile's chain of intermediates in shared
// memory. Each intermediate is a region of pixels, row-major, and each
// pixel holds its channels padded to a multiple of 16 plus 8 more:
//
//   buf[(r * cols + c) * ps + ch],  ps = round_up(channels, 16) + 8
//
// The 8 extra channels (16 bytes) put the rows of one ldmatrix 8x8 load
// in 8 different bank groups, so the loads are conflict-free.
//
// conv_layer() is one 3x3 layer: an implicit GEMM with the layer's output
// pixels as M, its (padded) output channels as N and taps x padded input
// channels as K, on the tensor cores with mma.sync.m16n8k16 (bf16
// operands, f32 sums): A comes from the input region in shared memory by
// ldmatrix, one row address per pixel, so the 3x3 window needs no im2col
// copy; B comes from device memory (L2) in fragment order, packed by the
// Python wrapper. Each warp owns 32 pixels x 64 channels at a time.
// bf16 only: float32 chains run one conv3x3_f32.cu launch per layer.
//
// Plain C++ for nvcc; no PyTorch headers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ekp_conv {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWarpM = 32;   // pixels per warp tile (two m16 tiles)
constexpr int kWarpN = 64;   // channels per warp tile (eight n8 tiles)
constexpr int kMaxSmem = 232448;

__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ inline int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}
// padded channel count (the K chunk and the N tile are both 16)
__host__ __device__ inline int pad_ch(int c) { return round_up(c, 16); }
// pixel stride in elements of a shared-memory region
__host__ __device__ inline int pix_stride(int c) { return pad_ch(c) + 8; }

using bf16 = __nv_bfloat16;

__device__ inline void ldmatrix_x4(unsigned (&r)[4], const void* smem) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ inline void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One 3x3 conv layer + bias + ReLU, rounded to bf16, from one
// shared-memory region into another.
//
//   in:   input region, (out_rows + 2) x (out_cols + 2) pixels, stride
//         in_ps
//   out:  out_rows x out_cols pixels, stride out_ps, np channels written
//   w:    packed weights, 9 x (kc * 16) x np in fragment order
//         ([tap][k chunk][n tile][lane][4])
//   bias: np floats (zero beyond the real channels)
//   mask: zero every output pixel outside the image; (oy, ox) is the
//         image position of the region's pixel (0, 0)
__device__ inline void conv_layer(const bf16* in, int in_ps, bf16* out, int out_ps,
                           int out_rows, int out_cols,
                           const bf16* __restrict__ w,
                           const float* __restrict__ bias, int kc, int np,
                           bool mask, int oy, int ox, int height, int width) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int in_cols = out_cols + 2;
  const int m_total = out_rows * out_cols;
  const int m_groups = (m_total + kWarpM - 1) / kWarpM;
  const int n_groups = (np + kWarpN - 1) / kWarpN;
  const int n_tiles_all = np / 8;

  for (int item = warp; item < m_groups * n_groups; item += kWarps) {
    const int m0 = (item % m_groups) * kWarpM;
    const int n0 = (item / m_groups) * kWarpN;
    const int n_tiles = min(8, (np - n0) / 8);
    float acc[2][8][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

    // ldmatrix rows: lane l gives pixel row l % 16 at k offset (l/16)*8
    int a_pix[2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      int m = m0 + mt * 16 + (lane & 15);
      if (m >= m_total) m = 0;  // padding rows: read pixel 0, never stored
      a_pix[mt] = (m / out_cols) * in_cols + (m % out_cols);
    }
    const int koff = (lane >> 4) * 8;
    const uint2* wf = reinterpret_cast<const uint2*>(w);
    for (int tap = 0; tap < 9; ++tap) {
      const int shift = (tap / 3) * in_cols + (tap % 3);
      for (int kk = 0; kk < kc; ++kk) {
        unsigned a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          ldmatrix_x4(a[mt],
                      in + (a_pix[mt] + shift) * in_ps + kk * 16 + koff);
        const uint2* wk =
            wf + ((tap * kc + kk) * n_tiles_all + n0 / 8) * 32 + lane;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          if (nt < n_tiles) {
            const uint2 b = __ldg(wk + nt * 32);
            mma_bf16(acc[0][nt], a[0], b.x, b.y);
            mma_bf16(acc[1][nt], a[1], b.x, b.y);
          }
        }
      }
    }

    // epilogue: bias, ReLU, round to bf16, zero outside the image, store
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + mt * 16 + (lane >> 2) + 8 * h;
        if (m >= m_total) continue;
        const int r = m / out_cols, c = m % out_cols;
        const bool zero = mask && (oy + r < 0 || oy + r >= height ||
                                   ox + c < 0 || ox + c >= width);
        bf16* dst = out + m * out_ps;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          if (nt < n_tiles) {
            const int n = n0 + nt * 8 + 2 * (lane & 3);
            const float v0 = fmaxf(acc[mt][nt][2 * h] + bias[n], 0.f);
            const float v1 = fmaxf(acc[mt][nt][2 * h + 1] + bias[n + 1], 0.f);
            dst[n] = __float2bfloat16_rn(zero ? 0.f : v0);
            dst[n + 1] = __float2bfloat16_rn(zero ? 0.f : v1);
          }
        }
      }
    }
  }
}

// Last step of a tile: its final region (rows x cols pixels, stride ps)
// to NHWC device memory, with an optional 2x2/2 max pool. (y0, x0) is the
// image position of the region's pixel (0, 0) before pooling; out_h x
// out_w x co is the output image.
__device__ inline void store_tile(const bf16* buf, int ps, int rows, int cols,
                           int co, bool pool, bf16* __restrict__ out, int y0,
                           int x0, int out_h, int out_w) {
  if (pool) {
    const int pr = rows / 2, pc = cols / 2;
    const int oy0 = y0 / 2, ox0 = x0 / 2;
    for (int i = threadIdx.x; i < pr * pc * co; i += kThreads) {
      const int ch = i % co, p = i / co;
      const int py = p / pc, px = p % pc;
      if (oy0 + py >= out_h || ox0 + px >= out_w) continue;
      const bf16* s = buf + ((2 * py) * cols + 2 * px) * ps + ch;
      const float v =
          fmaxf(fmaxf(__bfloat162float(s[0]), __bfloat162float(s[ps])),
                fmaxf(__bfloat162float(s[cols * ps]),
                      __bfloat162float(s[cols * ps + ps])));
      out[((size_t)(oy0 + py) * out_w + ox0 + px) * co + ch] =
          __float2bfloat16_rn(v);
    }
    return;
  }
  constexpr int kVec = 16 / sizeof(bf16);
  if (co % kVec == 0) {  // 16-byte copies
    const int cv = co / kVec;
    for (int i = threadIdx.x; i < rows * cols * cv; i += kThreads) {
      const int v = i % cv, p = i / cv;
      const int r = p / cols, c = p % cols;
      if (y0 + r >= out_h || x0 + c >= out_w) continue;
      const uint4 val =
          *reinterpret_cast<const uint4*>(buf + p * ps + v * kVec);
      *reinterpret_cast<uint4*>(
          out + ((size_t)(y0 + r) * out_w + x0 + c) * co + v * kVec) = val;
    }
    return;
  }
  for (int i = threadIdx.x; i < rows * cols * co; i += kThreads) {
    const int ch = i % co, p = i / co;
    const int r = p / cols, c = p % cols;
    if (y0 + r >= out_h || x0 + c >= out_w) continue;
    out[((size_t)(y0 + r) * out_w + x0 + c) * co + ch] = buf[p * ps + ch];
  }
}

// Host side: pick the largest output tile of 32x32 ... 2x2 (no taller or
// wider than the even-rounded image) whose two shared buffers fit, then
// launch one block per (image, tile) on `stream`. `sizes(a, th, tw, &b0,
// &b1)` gives each buffer's elements; the plan goes into a.th, a.tw,
// a.buf1 (buffer 1's offset, 16-byte aligned), a.tiles_y and a.tiles_x.
// Returns a cudaError_t as int; a shape no tile fits is
// cudaErrorInvalidConfiguration.
template <typename Args>
int launch_tiled(void (*kernel)(Args), Args a, int batch,
                 void (*sizes)(const Args&, int, int, long*, long*),
                 cudaStream_t stream) {
  static const int kTiles[][2] = {{32, 32}, {32, 16}, {16, 16}, {16, 8},
                                  {8, 8},   {8, 4},   {4, 4},   {2, 2}};
  long smem = -1;
  for (const auto& t : kTiles) {
    const int th = imin(t[0], round_up(a.height, 2));
    const int tw = imin(t[1], round_up(a.width, 2));
    long b0, b1;
    sizes(a, th, tw, &b0, &b1);
    b0 = round_up((int)b0, 8);
    const long bytes = (b0 + b1) * (long)sizeof(bf16);
    if (bytes <= kMaxSmem) {
      a.th = th;
      a.tw = tw;
      a.buf1 = (int)b0;
      smem = bytes;
      break;
    }
  }
  if (smem < 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  a.tiles_y = (a.height + a.th - 1) / a.th;
  a.tiles_x = (a.width + a.tw - 1) / a.tw;
  const long blocks = (long)batch * a.tiles_y * a.tiles_x;
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) {
    void* args[] = {&a};
    err = cudaLaunchKernel(reinterpret_cast<const void*>(kernel),
                           dim3((unsigned)blocks), dim3(kThreads), args,
                           (size_t)smem, stream);
  }
  const cudaError_t last = cudaGetLastError();  // read and cleared
  return static_cast<int>(err != cudaSuccess ? err : last);
}

}  // namespace ekp_conv
