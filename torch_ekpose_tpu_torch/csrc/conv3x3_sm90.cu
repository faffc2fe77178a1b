// One 3x3 SAME conv + bias + ReLU layer, rounded to bf16, with an optional
// 2x2/2 max pool after it: VGG blocks 2 and 3, and conv1_2 after conv1_1
// alone, one launch per layer.
//
// Replaces, for bf16 chains whose every layer has ci % 64 == 0 and
// co % 64 == 0 (vgg2016's blocks 2 and 3, and block 1's conv1_2), the JAX
// package's TPU kernel torch_ekpose_tpu/ops/pallas_conv.py::conv_chain.
// ops/conv_chain.py picks this route by shape (plan_chain) and launches it
// once per layer; the bf16 [3, 64, 64] pooled chain goes to
// block1_sm90.cu, and every other chain stays on conv_chain.cu.
//
// Bound on this card: tensor-core operations. A block-3 layer at batch 8,
// 92x108, 256 -> 256 channels is 93.8 GFLOP against ~82 MB of input,
// weight and output, far above the H100's ~295 bf16 operations per byte;
// conv1_2 + pool at 368x432 is 93.8 GFLOP against ~204 MB.
//
// Design. The TPU kernel fuses the chain to keep the intermediates in
// ~100 MB of VMEM. A fused Hopper block of 227 KB holds only an 8x8 tile
// at 256 channels and recomputes ~2x the FLOPs in its halo, while one
// bf16 intermediate of block 3 costs ~24 us of HBM traffic. So each layer
// is its own implicit GEMM of output pixels x co x (9 taps x ci), with no
// im2col. A CTA owns kTileH rows x 16 columns of one image and kTileN
// output channels. For tap (dy, dx) and 64-channel chunk c, one TMA load
// of the 4-D box {64, 16, kTileH, 1} at (64c, x0 + dx - 1, y0 + dy - 1, b)
// brings the shifted pixel tile; TMA fills what lies outside the image
// with zeros, which is the SAME padding, so nothing is masked. The weight
// is packed [co][9 ci] (K contiguous), a 2-D box {64, kTileN}. Both land
// 128B-swizzled in a ring of 4 stages, the layout wgmma reads as K-major
// operands. One producer thread starts the loads (a full and an empty
// mbarrier per stage); two consumer warpgroups each run four
// wgmma.m64n128k16 per stage on their half of the pixels, with one
// stage's products in flight while the next stage's start. Two tiles:
//   kTileN = 128 (co % 128 == 0): 8x16 pixels; M = a warpgroup's 64
//     pixels (A from the pixel tile), N = the 128 channels (B = weights);
//   kTileN = 64 (co % 64 == 0 otherwise): 16x16 pixels; M = the 64
//     channels (A = weights), N = a warpgroup's 128 pixels (B from the
//     pixel tile). The roles swap so that both tiles issue the same
//     m64n128k16 (6 KB of operands per 262k FLOP, where m64n64k16 would
//     read 4 KB per 131k), and the 256-pixel tile halves the ring fill
//     and epilogue per FLOP against 128 pixels.
// The epilogue adds the bias, applies ReLU and rounds to bf16 into a
// staging tile [pixel][channel] of its own (no ring buffer that the async
// proxy wrote is rewritten), takes the optional pool from it (tile origins
// are even, so a pool window never crosses a tile), and stores 16 bytes a
// thread, masked at the ragged edge.
//
// Plain C interface, bound with ctypes by ops/_build.py. The tensor maps
// are encoded on every call by cuTensorMapEncodeTiled, found at run time
// with cudaGetDriverEntryPoint, so the library needs no -lcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTileW = 16;                      // output columns of a CTA
constexpr int kChunk = 64;                      // K per stage: 128 B of bf16
constexpr int kStages = 4;
constexpr int kConsumers = 256;                 // two warpgroups
constexpr int kThreads = kConsumers + 128;      // and the producer's

// The CTA tile for kTileN output channels (128 or 64); see the note above.
template <int kTileN>
struct Tile {
  static constexpr bool kPixelsAreA = kTileN == 128;
  static constexpr int kTileH = kPixelsAreA ? 8 : 16;
  static constexpr int kTileM = kTileH * kTileW;     // pixels: 128 or 256
  static constexpr int kStageA = kTileM * kChunk * 2;  // the pixel box
  static constexpr int kStageB = kTileN * kChunk * 2;  // the weight box
  static constexpr int kStageBytes = kStageA + kStageB;
  static constexpr int kPitch = kTileN + 8;          // staging row, elements
  static constexpr int kOffB = kStages * kStageA;
  static constexpr int kOffStaging = kOffB + kStages * kStageB;
  static constexpr int kOffBars = kOffStaging + kTileM * kPitch * 2;
  // + 1 KB to align the ring to the 1024 B that the 128B swizzle repeats on
  static constexpr int kSmemBytes = kOffBars + 2 * kStages * 8 + 1024;
};
static_assert(Tile<128>::kSmemBytes <= 232448 &&
                  Tile<64>::kSmemBytes <= 232448,
              "a block may opt into 227 KB of shared memory");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed. A
// pipeline stalled for ~2^32 cycles (a load that never lands) traps, so a
// fault ends the launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long start = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1LL << 32)) __trap();
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile of 128-byte rows in the
// 128B swizzle: start address >> 4, LBO 1 (unused for this layout), SBO
// 1024 B (8 rows of 128 B), layout type 1 (128B swizzle) in bits 62-63.
// A k16 step inside the 64-wide chunk adds 32 B, i.e. 2, to the start.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma instructions.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define EKP_ACC8(i)                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),         \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64 x 128] += A[64 x 16] * B[16 x 128], both from shared memory,
// K-major (no transpose), f32 sums. d's layout: register i of thread
// (warp w, lane l) of the warpgroup holds row 16 w + l / 4 + 8 ((i / 2) % 2),
// column 8 (i / 4) + 2 (l % 4) + i % 2.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a,
                                                 uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : EKP_ACC8(0), EKP_ACC8(8), EKP_ACC8(16), EKP_ACC8(24), EKP_ACC8(32),
        EKP_ACC8(40), EKP_ACC8(48), EKP_ACC8(56)
      : "l"(a), "l"(b), "r"(1));
}

#undef EKP_ACC8

__device__ __forceinline__ uint4 max8(uint4 a, uint4 b) {
  uint32_t* pa = reinterpret_cast<uint32_t*>(&a);
  const uint32_t* pb = reinterpret_cast<const uint32_t*>(&b);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 m = __hmax2(*reinterpret_cast<__nv_bfloat162*>(&pa[i]),
                               *reinterpret_cast<const __nv_bfloat162*>(&pb[i]));
    pa[i] = *reinterpret_cast<uint32_t*>(&m);
  }
  return a;
}

// grid (tiles_y * tiles_x * batch, co / kTileN), kThreads threads:
// warpgroups 0-1 consume (wgmma, epilogue), warpgroup 2 produces (one
// thread, TMA).
template <int kTileN>
__global__ void __launch_bounds__(kThreads, 1)
    conv3x3_kernel(__grid_constant__ const CUtensorMap map_x,
                   __grid_constant__ const CUtensorMap map_w,
                   const float* __restrict__ bias, bf16* __restrict__ out,
                   int height, int width, int ci, int co, int tiles_x,
                   int tiles_y, int pool) {
  using T = Tile<kTileN>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t full = base + T::kOffBars, empty = full + kStages * 8;

  const int tiles = tiles_y * tiles_x;
  const int img = blockIdx.x / tiles;
  const int tile = blockIdx.x % tiles;
  const int y0 = tile / tiles_x * T::kTileH, x0 = tile % tiles_x * kTileW;
  const int n0 = blockIdx.y * kTileN;
  const int chunks = ci / kChunk, steps = 9 * chunks;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // the producer warpgroup: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (threadIdx.x == kConsumers) {
      int st = 0;
      uint32_t phase = 0;
      for (int s = 0; s < steps; ++s) {
        const int tap = s / chunks, c = s % chunks;
        mbar_wait(empty + 8 * st, phase ^ 1);
        mbar_expect_tx(full + 8 * st, T::kStageBytes);
        tma_load_4d(base + st * T::kStageA, &map_x, full + 8 * st,
                    c * kChunk, x0 + tap % 3 - 1, y0 + tap / 3 - 1, img);
        tma_load_2d(base + T::kOffB + st * T::kStageB, &map_w, full + 8 * st,
                    tap * ci + c * kChunk, n0);
        if (++st == kStages) {
          st = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // the consumer warpgroups: warpgroup g owns the g-th half of the
    // pixels (64 for kTileN = 128, 128 for kTileN = 64)
    const int wg = threadIdx.x / 128;
    float d[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0.f;
    int st = 0, prev = 0;
    uint32_t phase = 0;
    for (int s = 0; s < steps; ++s) {
      mbar_wait(full + 8 * st, phase);
      const uint64_t dpix =
          sw128_desc(base + st * T::kStageA + wg * (T::kStageA / 2));
      const uint64_t dw = sw128_desc(base + T::kOffB + st * T::kStageB);
      const uint64_t da = T::kPixelsAreA ? dpix : dw;
      const uint64_t db = T::kPixelsAreA ? dw : dpix;
      fence_acc(d);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int k = 0; k < kChunk / 16; ++k)
        wgmma_m64n128k16(d, da + 2 * k, db + 2 * k);
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      // the stage before this one is done once at most this one is pending
      asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
      fence_acc(d);
      if (s > 0) mbar_arrive(empty + 8 * prev);
      prev = st;
      if (++st == kStages) {
        st = 0;
        phase ^= 1;
      }
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_acc(d);

    // bias, ReLU, bf16 into the staging tile [pixel][channel]. Register
    // 4 j + 2 h + e holds the product's row m = 16 warp + lane / 4 + 8 h
    // and column n = 8 j + 2 (lane % 4) + e: (pixel, channel) for
    // kTileN = 128, (channel, pixel) for kTileN = 64.
    bf16* staging = reinterpret_cast<bf16*>(smem + T::kOffStaging);
    const int lane = threadIdx.x % 32;
    const int m = (threadIdx.x % 128) / 32 * 16 + lane / 4;
    if constexpr (T::kPixelsAreA) {
#pragma unroll
      for (int j = 0; j < kTileN / 8; ++j) {
        const int n = j * 8 + lane % 4 * 2;
        const float b0 = bias[n0 + n], b1 = bias[n0 + n + 1];
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<__nv_bfloat162*>(
              staging + (wg * 64 + m + 8 * h) * T::kPitch + n) =
              __floats2bfloat162_rn(fmaxf(d[4 * j + 2 * h] + b0, 0.f),
                                    fmaxf(d[4 * j + 2 * h + 1] + b1, 0.f));
      }
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = m + 8 * h;
        const float bc = bias[n0 + c];
#pragma unroll
        for (int j = 0; j < 16; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int p = wg * 128 + j * 8 + lane % 4 * 2 + e;
            staging[p * T::kPitch + c] =
                __float2bfloat16_rn(fmaxf(d[4 * j + 2 * h + e] + bc, 0.f));
          }
        }
      }
    }
    asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");

    // 16-byte stores of 8 channels, masked at the ragged edge
    constexpr int kVec = 8, kVecs = kTileN / kVec, kPitch = T::kPitch;
    const int out_h = pool ? height / 2 : height;
    const int out_w = pool ? width / 2 : width;
    bf16* dst = out + (size_t)img * out_h * out_w * co + n0;
    if (!pool) {
      for (int i = threadIdx.x; i < T::kTileM * kVecs; i += kConsumers) {
        const int p = i / kVecs, q = i % kVecs;
        const int y = y0 + p / kTileW, x = x0 + p % kTileW;
        if (y < out_h && x < out_w)
          *reinterpret_cast<uint4*>(dst + ((size_t)y * out_w + x) * co +
                                    q * kVec) =
              *reinterpret_cast<const uint4*>(staging + p * kPitch + q * kVec);
      }
    } else {
      constexpr int kPooledW = kTileW / 2;
      for (int i = threadIdx.x; i < T::kTileM / 4 * kVecs; i += kConsumers) {
        const int p = i / kVecs, q = i % kVecs;
        const int py = p / kPooledW, px = p % kPooledW;
        const int y = y0 / 2 + py, x = x0 / 2 + px;
        if (y < out_h && x < out_w) {
          const bf16* s = staging + (2 * py * kTileW + 2 * px) * kPitch +
                          q * kVec;
          const uint4 top = max8(*reinterpret_cast<const uint4*>(s),
                                 *reinterpret_cast<const uint4*>(s + kPitch));
          const uint4 bottom = max8(
              *reinterpret_cast<const uint4*>(s + kTileW * kPitch),
              *reinterpret_cast<const uint4*>(s + (kTileW + 1) * kPitch));
          *reinterpret_cast<uint4*>(dst + ((size_t)y * out_w + x) * co +
                                    q * kVec) = max8(top, bottom);
        }
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the libcuda that the runtime has loaded
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A tiled bf16 map with 128B swizzle; zeros where a box leaves the tensor.
bool encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int rank,
            const cuuint64_t* dims, const cuuint64_t* strides,
            const cuuint32_t* box) {
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr),
            dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// One launch of the kTileN variant; the maps' boxes follow its tile.
template <int kTileN>
int launch(EncodeTiled fn, const void* x, void* out, const void* w,
           const void* bias, int b, int h, int wd, int ci, int co, int pool,
           cudaStream_t stream) {
  using T = Tile<kTileN>;
  CUtensorMap map_x, map_w;
  const cuuint64_t e = 2;  // bytes of a bf16
  const cuuint64_t x_dims[4] = {(cuuint64_t)ci, (cuuint64_t)wd, (cuuint64_t)h,
                                (cuuint64_t)b};
  const cuuint64_t x_strides[3] = {ci * e, wd * ci * e, h * wd * ci * e};
  const cuuint32_t x_box[4] = {kChunk, kTileW, T::kTileH, 1};
  const cuuint64_t w_dims[2] = {9 * (cuuint64_t)ci, (cuuint64_t)co};
  const cuuint64_t w_strides[1] = {9 * ci * e};
  const cuuint32_t w_box[2] = {kChunk, kTileN};
  if (!encode(fn, &map_x, x, 4, x_dims, x_strides, x_box) ||
      !encode(fn, &map_w, w, 2, w_dims, w_strides, w_box))
    return static_cast<int>(cudaErrorInvalidValue);

  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_kernel<kTileN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_x = (wd + kTileW - 1) / kTileW;
  const int tiles_y = (h + T::kTileH - 1) / T::kTileH;
  const dim3 grid(tiles_y * tiles_x * b, co / kTileN);
  conv3x3_kernel<kTileN><<<grid, kThreads, T::kSmemBytes, stream>>>(
      map_x, map_w, static_cast<const float*>(bias), static_cast<bf16*>(out),
      h, wd, ci, co, tiles_x, tiles_y, pool);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [b, h, w, ci] and out ([b, h, w, co], or [b, h/2, w/2, co] when
// pooling) bf16 NHWC; w the weight packed [co][9 ci] bf16
// (ops/conv_chain.py::pack_weight_kmajor); bias float32 [co]. tile_n is
// 128 (co % 128 == 0) or 64 (co % 64 == 0) (ops/conv_chain.py::
// sm90_tile_n); ci % 64 == 0; every pointer 16-byte aligned.
extern "C" int ekp_conv3x3_sm90(const void* x, void* out, const void* w,
                                const void* bias, int b, int h, int wd, int ci,
                                int co, int pool, int tile_n, void* stream) {
  if (b < 1 || h < 1 || wd < 1 || ci < kChunk || ci % kChunk ||
      (tile_n != 64 && tile_n != 128) || co < tile_n || co % tile_n ||
      (pool && (h % 2 || wd % 2)) || !aligned16(x) || !aligned16(out) ||
      !aligned16(w) || !bias)
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled fn = encode_tiled();
  if (!fn) return static_cast<int>(cudaErrorNotSupported);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return tile_n == 128
             ? launch<128>(fn, x, out, w, bias, b, h, wd, ci, co, pool, s)
             : launch<64>(fn, x, out, w, bias, b, h, wd, ci, co, pool, s);
}
