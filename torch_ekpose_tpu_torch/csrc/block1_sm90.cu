// VGG block 1 in bf16 with 64 channels: conv1_1 (3 -> 64) + bias + ReLU
// alone (conv1_only), or conv1_1, conv1_2 (64 -> 64) + bias + ReLU and a
// 2x2/2 max pool fused, every result rounded to bf16 as the unfused chain
// rounds it.
//
// Replaces the JAX package's TPU kernels scripts/profile_block1.py::
// conv1_fused (_conv1_kernel) and ::block1_fused (_kernel, variants A and
// B, which differ only in the shape of conv1_2's MXU product and compute
// the same function). ops/block1.py picks this kernel for bf16 with
// c1 == c2 == 64 (plan_block1); float32 and other widths go to
// conv_chain.cu, which computes the same functions.
//
// Bound on this card: conv1_only by device-memory bytes (a 163 MB output
// at batch 8, 368x432, for 4.4 GFLOP: ~0.05 ms at 3.35 TB/s); the fused
// block by tensor-core operations (98 GFLOP: ~0.1 ms at 989 TFLOP/s).
//
// Design. One persistent CTA per SM (two for conv1_only) walks the tiles
// with a static stride, so the weights are read once per CTA: w2 lives in
// shared memory as wgmma's A operand, conv1_1's weights live in registers
// as mma.sync B fragments. A tile's input box (its rows plus a 2-pixel
// halo, 3 channels, zero outside the image) is loaded with coalesced
// 2-byte loads into registers one tile ahead, so the loads of tile i+1
// run under tile i's math; 16-byte copies would need W % 8 == 0. conv1_1
// is one m16n8k16 product per 16 pixels with K = 27 patch entries padded
// to 32, its A fragments read straight from the staged rows (entry k of a
// pixel sits a fixed offset from the pixel: no im2col). conv1_2 swaps the
// usual roles: M is the 64 output channels (A = w2), N is 256 pixels (B =
// the conv1_1 region). The region is stored [8 channel groups][pixel][8
// channels] with 64 pixels a row, so 8 consecutive pixels of one group
// are one 128-byte core matrix of wgmma's no-swizzle K-major layout, and
// the window of tap (dy, dx) for 4 output rows is the same layout moved by
// (dy * 64 + dx) pixels: an address offset. Each warpgroup runs 9 taps x
// 4 k16 steps = 36 wgmma.m64n256k16 on its 4 output rows, 62 of each 64
// columns real. The 2x2 pool then needs no data movement: horizontal
// pairs are neighbouring accumulator registers and vertical pairs are 32
// registers apart. Pooled bf16 values go through a staging tile to
// 16-byte stores. conv1_only stages conv1_1's 64 channels and stores them
// the same way.
//
// No mbarrier is used: the input goes through registers, and wgmma reads
// what the CTA's own threads wrote after a proxy fence and a barrier.
//
// Plain C interface, bound with ctypes by ops/_build.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;              // two warpgroups
constexpr int kC = 64;                     // c1 == c2
constexpr int kCols = 64;                  // region pixels a row
constexpr int kBoxW = 200;                 // staged input row: 66 px x 3 ch
constexpr int kW1Rows = 27;                // 3 x 3 taps x 3 channels
constexpr int kW2Elems = 9 * kC * kC;
// region pixels: 10 rows of 64, then the 2 the last window overreaches
constexpr int kRegionPix = 648;
constexpr int kGroupBytes = kRegionPix * 16;
constexpr int kPitch = kC + 8;             // staging row, in elements

template <bool kFused>
struct Mode;

template <>
struct Mode<true> {                        // block1_fused
  static constexpr int kRows = 10;         // region: the tile's 8 + halo
  static constexpr int kTileW = 62;        // real output columns a tile
  static constexpr int kHalo = 1;
  static constexpr int kStagePix = 4 * 32;
  static constexpr int kOffW2 = 0;
  static constexpr int kOffRegion = kOffW2 + kW2Elems * 2;
  static constexpr int kOffIn = kOffRegion + 8 * kGroupBytes;
  static constexpr int kBlocks = 1;
};

template <>
struct Mode<false> {                       // conv1_fused
  static constexpr int kRows = 8;
  static constexpr int kTileW = 64;
  static constexpr int kHalo = 0;
  static constexpr int kStagePix = 8 * 64;
  static constexpr int kOffIn = 0;
  static constexpr int kBlocks = 2;
};

template <bool kFused>
struct Layout : Mode<kFused> {
  using M = Mode<kFused>;
  static constexpr int kTileH = 8;
  static constexpr int kBoxRows = M::kRows + 2;
  static constexpr int kLoads = (kBoxRows * kBoxW + kThreads - 1) / kThreads;
  static constexpr int kOffStaging = M::kOffIn + kBoxRows * kBoxW * 2;
  static constexpr int kOffBias = kOffStaging + M::kStagePix * kPitch * 2;
  static constexpr int kSmem = kOffBias + kC * 4;
};

struct Args {
  const bf16* x;
  bf16* out;
  const bf16* w;      // packed: w1 [27][64], then w2 [72][64][8]
  const float* b1;
  const float* b2;
  int batch, height, width, tiles_y, tiles_x;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack2(unsigned short lo,
                                          unsigned short hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// wgmma shared-memory descriptor, no swizzle (layout type 0), K-major: the
// operand is 8-row x 16-byte core matrices of 128 contiguous bytes; `lbo`
// is the byte step between the two core matrices of a k16 step (along K),
// `sbo` the byte step to the next 8 rows (along M or N).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma instructions.
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define EKP_ACC8(i)                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),         \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64 x 256] += A[64 x 16] * B[16 x 256], both K-major in shared memory,
// f32 sums. Register i of thread (warp w of the warpgroup, lane l) holds
// row 16 w + l / 4 + 8 ((i / 2) % 2), column 8 (i / 4) + 2 (l % 4) + i % 2.
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t a,
                                                 uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, "
      "%122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : EKP_ACC8(0), EKP_ACC8(8), EKP_ACC8(16), EKP_ACC8(24), EKP_ACC8(32),
        EKP_ACC8(40), EKP_ACC8(48), EKP_ACC8(56), EKP_ACC8(64), EKP_ACC8(72),
        EKP_ACC8(80), EKP_ACC8(88), EKP_ACC8(96), EKP_ACC8(104),
        EKP_ACC8(112), EKP_ACC8(120)
      : "l"(a), "l"(b), "r"(1));
}

#undef EKP_ACC8

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Image, output row and output column of tile t (row tiles of 8, column
// tiles of Mode::kTileW).
template <bool kFused>
__device__ __forceinline__ void tile_origin(const Args& a, int t, int* b,
                                            int* y0, int* x0) {
  const int per_image = a.tiles_y * a.tiles_x;
  *b = t / per_image;
  const int r = t % per_image;
  *y0 = r / a.tiles_x * Layout<kFused>::kTileH;
  *x0 = r % a.tiles_x * Mode<kFused>::kTileW;
}

// The input box of tile t into registers: rows y0 - halo - 1 .. , columns
// x0 - halo - 1 .. (3 channels a pixel, kBoxW elements a row), zero
// outside the image. Consecutive threads load consecutive elements.
template <bool kFused>
__device__ __forceinline__ void load_input(
    const Args& a, int t, unsigned short (&pre)[Layout<kFused>::kLoads]) {
  using L = Layout<kFused>;
  int b, y0, x0;
  tile_origin<kFused>(a, t, &b, &y0, &x0);
  const int row_elems = 3 * a.width;
  const int iy0 = y0 - L::kHalo - 1, ie0 = 3 * (x0 - L::kHalo - 1);
  const unsigned short* x = reinterpret_cast<const unsigned short*>(a.x) +
                            (size_t)b * a.height * row_elems;
#pragma unroll
  for (int i = 0; i < L::kLoads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int y = iy0 + e / kBoxW, xe = ie0 + e % kBoxW;
    pre[i] = (e < L::kBoxRows * kBoxW && y >= 0 && y < a.height && xe >= 0 &&
              xe < row_elems)
                 ? __ldg(x + (size_t)y * row_elems + xe)
                 : static_cast<unsigned short>(0);
  }
}

template <bool kFused>
__device__ __forceinline__ void store_input(
    unsigned short* in, const unsigned short (&pre)[Layout<kFused>::kLoads]) {
  using L = Layout<kFused>;
#pragma unroll
  for (int i = 0; i < L::kLoads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    if (e < L::kBoxRows * kBoxW) in[e] = pre[i];
  }
}

template <bool kFused>
__global__ void __launch_bounds__(kThreads, Mode<kFused>::kBlocks)
    block1_kernel(const Args a) {
  using L = Layout<kFused>;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned short* in = reinterpret_cast<unsigned short*>(smem + L::kOffIn);
  bf16* staging = reinterpret_cast<bf16*>(smem + L::kOffStaging);
  float* bias1 = reinterpret_cast<float*>(smem + L::kOffBias);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int h = a.height, w = a.width;
  const int tiles = a.batch * a.tiles_y * a.tiles_x;

  if (tid < kC) bias1[tid] = a.b1[tid];
  if constexpr (kFused) {
    // w2 arrives packed in wgmma's A layout, [72 k-groups][64 co][8 k]
    const uint4* src = reinterpret_cast<const uint4*>(a.w + kW1Rows * kC);
    uint4* dst = reinterpret_cast<uint4*>(smem + L::kOffW2);
    for (int i = tid; i < kW2Elems / 8; i += kThreads) dst[i] = __ldg(src + i);
    // the region pixels past row 9, read only by discarded columns
    for (int i = tid; i < 8 * (kRegionPix - 10 * kCols); i += kThreads)
      *reinterpret_cast<uint4*>(smem + L::kOffRegion +
                                i / (kRegionPix - 10 * kCols) * kGroupBytes +
                                (10 * kCols + i % (kRegionPix - 10 * kCols)) *
                                    16) = make_uint4(0, 0, 0, 0);
  }

  // conv1_1's B fragments: k = 16 s + 2q + {0, 1} (.x) and + {8, 9} (.y)
  // of column 8 nt + g; the patch has 27 entries, so k >= 27 is zero
  uint32_t wb[2][8][2];
  const unsigned short* w1 = reinterpret_cast<const unsigned short*>(a.w);
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int k = 16 * s + 2 * q + 8 * r, n = 8 * nt + g;
        wb[s][nt][r] =
            pack2(k < kW1Rows ? __ldg(w1 + k * kC + n) : 0,
                  k + 1 < kW1Rows ? __ldg(w1 + (k + 1) * kC + n) : 0);
      }
  // A: patch entry k = 9 dy + 3 dx + c of a pixel lies (k / 9) rows and
  // k % 9 elements from the pixel's first staged element; k >= 27 meets
  // a zero weight, so it reads entry 26 (any finite value would do)
  int off[2][4];
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = min(16 * s + 2 * q + (j & 1) + 8 * (j >> 1), kW1Rows - 1);
      off[s][j] = k / 9 * kBoxW + k % 9;
    }
  float bias2[2] = {0.f, 0.f};
  if constexpr (kFused) {
    bias2[0] = a.b2[16 * (warp % 4) + g];
    bias2[1] = a.b2[16 * (warp % 4) + g + 8];
  }

  unsigned short pre[L::kLoads];
  if (blockIdx.x < tiles) {
    load_input<kFused>(a, blockIdx.x, pre);
    store_input<kFused>(in, pre);
  }
  __syncthreads();

  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    if (t + gridDim.x < tiles) load_input<kFused>(a, t + gridDim.x, pre);
    int b, y0, x0;
    tile_origin<kFused>(a, t, &b, &y0, &x0);
    const int ry0 = y0 - L::kHalo, rx0 = x0 - L::kHalo;

    // conv1_1 over the region, 16 pixels (a quarter row) a step
    for (int mt = warp; mt < L::kRows * kCols / 16; mt += kThreads / 32) {
      const int m0 = mt * 16, r = m0 / kCols, c0 = m0 % kCols;
      const int pa = r * kBoxW + (c0 + g) * 3, pb = pa + 8 * 3;
      uint32_t af[2][4];
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        af[s][0] = pack2(in[pa + off[s][0]], in[pa + off[s][1]]);
        af[s][1] = pack2(in[pb + off[s][0]], in[pb + off[s][1]]);
        af[s][2] = pack2(in[pa + off[s][2]], in[pa + off[s][3]]);
        af[s][3] = pack2(in[pb + off[s][2]], in[pb + off[s][3]]);
      }
      float acc[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll
        for (int s = 0; s < 2; ++s)
          mma_bf16(acc[nt], af[s], wb[s][nt][0], wb[s][nt][1]);
      }
      // bias, ReLU, bf16; zero outside the image (conv1_2's SAME border)
      const int y = ry0 + r, xa = rx0 + c0 + g, xb = xa + 8;
      const bool row_in = y >= 0 && y < h;
      const bool in_a = row_in && xa >= 0 && xa < w;
      const bool in_b = row_in && xb >= 0 && xb < w;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float2 bb =
            *reinterpret_cast<const float2*>(bias1 + 8 * nt + 2 * q);
        const __nv_bfloat162 zero = __floats2bfloat162_rn(0.f, 0.f);
        const __nv_bfloat162 va =
            in_a ? __floats2bfloat162_rn(fmaxf(acc[nt][0] + bb.x, 0.f),
                                         fmaxf(acc[nt][1] + bb.y, 0.f))
                 : zero;
        const __nv_bfloat162 vb =
            in_b ? __floats2bfloat162_rn(fmaxf(acc[nt][2] + bb.x, 0.f),
                                         fmaxf(acc[nt][3] + bb.y, 0.f))
                 : zero;
        if constexpr (kFused) {
          unsigned char* grp = smem + L::kOffRegion + nt * kGroupBytes + q * 4;
          *reinterpret_cast<__nv_bfloat162*>(grp + (m0 + g) * 16) = va;
          *reinterpret_cast<__nv_bfloat162*>(grp + (m0 + g + 8) * 16) = vb;
        } else {
          bf16* st = staging + 8 * nt + 2 * q;
          *reinterpret_cast<__nv_bfloat162*>(st + (m0 + g) * kPitch) = va;
          *reinterpret_cast<__nv_bfloat162*>(st + (m0 + g + 8) * kPitch) = vb;
        }
      }
    }

    if constexpr (kFused) {
      fence_proxy_async();  // the region, written here, is read by wgmma
      __syncthreads();

      // conv1_2: warpgroup wg owns output rows 4 wg .. 4 wg + 3, as 256
      // pixels of 64-pixel rows (columns 62 and 63 are discarded)
      const int wg = warp / 4;
      const uint32_t w2a = smem_u32(smem + L::kOffW2);
      const uint32_t rga = smem_u32(smem + L::kOffRegion);
      float d[128];
#pragma unroll
      for (int i = 0; i < 128; ++i) d[i] = 0.f;
      fence_acc(d);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const uint32_t window =
            rga + ((4 * wg + tap / 3) * kCols + tap % 3) * 16;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n256k16(
              d, desc(w2a + (tap * 8 + 2 * kk) * 1024, 1024, 128),
              desc(window + 2 * kk * kGroupBytes, kGroupBytes, 128));
      }
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      fence_acc(d);

      // pool in registers: columns c, c + 1 are registers i, i + 1, rows
      // r, r + 1 are i and i + 32; then bias, ReLU, bf16 (max commutes
      // with a per-channel bias, ReLU and rounding)
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) {
        const int j = jj < 8 ? jj : jj + 8;   // column group of rows 0, 2
        const int p = (2 * wg + j / 16) * 32 + 4 * (j % 8) + q;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int i = 4 * j + 2 * hh;
          const float v = fmaxf(fmaxf(d[i], d[i + 1]),
                                fmaxf(d[i + 32], d[i + 33]));
          staging[p * kPitch + 16 * (warp % 4) + g + 8 * hh] =
              __float2bfloat16_rn(fmaxf(v + bias2[hh], 0.f));
        }
      }
      __syncthreads();

      // 4 pooled rows x 31 real columns, 16 bytes a thread
      const int ho = h / 2, wo = w / 2, py0 = y0 / 2, px0 = x0 / 2;
      for (int i = tid; i < L::kStagePix * 8; i += kThreads) {
        const int p = i / 8, v = i % 8, y = py0 + p / 32, x = px0 + p % 32;
        if (p % 32 < Mode<kFused>::kTileW / 2 && y < ho && x < wo)
          *reinterpret_cast<uint4*>(
              a.out + (((size_t)b * ho + y) * wo + x) * kC + v * 8) =
              *reinterpret_cast<const uint4*>(staging + p * kPitch + v * 8);
      }
    } else {
      __syncthreads();
      for (int i = tid; i < L::kStagePix * 8; i += kThreads) {
        const int p = i / 8, v = i % 8, y = y0 + p / kCols, x = x0 + p % kCols;
        if (y < h && x < w)
          *reinterpret_cast<uint4*>(
              a.out + (((size_t)b * h + y) * w + x) * kC + v * 8) =
              *reinterpret_cast<const uint4*>(staging + p * kPitch + v * 8);
      }
    }
    store_input<kFused>(in, pre);  // the next tile's box, loaded above
    __syncthreads();
  }
}

template <bool kFused>
int launch(Args a, cudaStream_t stream) {
  using L = Layout<kFused>;
  const auto kernel = block1_kernel<kFused>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, L::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  a.tiles_y = (a.height + L::kTileH - 1) / L::kTileH;
  a.tiles_x = (a.width + L::kTileW - 1) / L::kTileW;
  const long tiles = (long)a.batch * a.tiles_y * a.tiles_x;
  const long grid = tiles < (long)sms * per_sm ? tiles : (long)sms * per_sm;
  kernel<<<static_cast<unsigned>(grid), kThreads, L::kSmem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// One wgmma.m64n256k16 with the kernel's descriptors, on operands laid out
// as the kernel lays out w2 (A) and the region (B, with a group stride of
// kProbePix pixels): pins the no-swizzle LBO / SBO meaning on the card.
constexpr int kProbePix = 264;

__global__ void __launch_bounds__(128)
    wgmma_probe_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b,
                       float* __restrict__ d_out) {
  __shared__ __align__(128) unsigned char sa[2 * 64 * 16];
  __shared__ __align__(128) unsigned char sb[2 * kProbePix * 16];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint4* a16 = reinterpret_cast<const uint4*>(a);   // [64][16]
  const uint4* b16 = reinterpret_cast<const uint4*>(b);   // [256][16]
  for (int i = tid; i < 64 * 2; i += 128)                 // (row, k group)
    *reinterpret_cast<uint4*>(sa + (i % 2) * 1024 + (i / 2) * 16) = a16[i];
  for (int i = tid; i < 256 * 2; i += 128)
    *reinterpret_cast<uint4*>(sb + (i % 2) * kProbePix * 16 + (i / 2) * 16) =
        b16[i];
  fence_proxy_async();
  __syncthreads();
  float d[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) d[i] = 0.f;
  fence_acc(d);
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
  wgmma_m64n256k16(d, desc(smem_u32(sa), 1024, 128),
                   desc(smem_u32(sb), kProbePix * 16, 128));
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  fence_acc(d);
#pragma unroll
  for (int i = 0; i < 128; ++i) {
    const int row = 16 * warp + lane / 4 + 8 * ((i / 2) % 2);
    const int col = 8 * (i / 4) + 2 * (lane % 4) + i % 2;
    d_out[row * 256 + col] = d[i];
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// x [b, h, w, 3] bf16 NHWC; w the packed bf16 weights
// (ops/block1.py::pack_block1: w1 as [27][64], then w2 as [72][64][8]
// when fused);
// b1, b2 float32 [64]. out: [b, h, w, 64] (fused == 0) or
// [b, h/2, w/2, 64] bf16 (fused, h and w even).
extern "C" int ekp_block1_sm90(const void* x, void* out, const void* w,
                               const void* b1, const void* b2, int batch,
                               int h, int wd, int fused, void* stream) {
  if (batch < 1 || h < 1 || wd < 1 || !x || !b1 || !aligned16(out) ||
      !aligned16(w) || (fused && (h % 2 || wd % 2 || !b2)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = {};
  a.x = static_cast<const bf16*>(x);
  a.out = static_cast<bf16*>(out);
  a.w = static_cast<const bf16*>(w);
  a.b1 = static_cast<const float*>(b1);
  a.b2 = static_cast<const float*>(b2);
  a.batch = batch;
  a.height = h;
  a.width = wd;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return fused ? launch<true>(a, s) : launch<false>(a, s);
}

// a [64][16], b [256][16] bf16 (16-byte aligned); d [64][256] float32 =
// a @ b^T through one wgmma.m64n256k16 (test hook, not a path kernel).
extern "C" int ekp_block1_sm90_probe(const void* a, const void* b, void* d,
                                     void* stream) {
  if (!aligned16(a) || !aligned16(b) || !d)
    return static_cast<int>(cudaErrorInvalidValue);
  wgmma_probe_kernel<<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b),
      static_cast<float*>(d));
  return static_cast<int>(cudaGetLastError());
}
