// One 3x3 SAME conv + bias + ReLU layer in float32, with an optional
// 2x2/2 max pool after it: every float32 chain of the VGG prefix, one
// launch per layer.
//
// Replaces, for float32 chains, the JAX package's TPU kernel
// torch_ekpose_tpu/ops/pallas_conv.py::conv_chain (_conv_chain_tpu,
// _chain_kernel) and, through ops/block1.py, the float32 calls of
// scripts/profile_block1.py's conv1_fused and block1_fused (27-deep
// patches are conv1_1 with ci = 3). ops/conv_chain.py sends every float32
// chain here (plan_chain) and launches it once per layer; bf16 chains go
// to block1_sm90.cu, conv3x3_sm90.cu or conv_chain.cu.
//
// Bound on this card: float32 operations. The FMAs run outside the tensor
// cores (67 TFLOP/s): TF32 or 3xTF32 would not give the JAX reference's
// float32 at HIGHEST. Block 1 at batch 8, 368x432, is 98.2 GFLOP (1.47 ms
// at that peak) against ~0.2 ms of HBM traffic for its 325 MB float32
// intermediate, written once and read once.
//
// Design. No halo recompute: each intermediate is a float32 NHWC tensor in
// device memory, and the chain is one launch per layer. A CTA of 256
// threads owns kTileH x 16 output pixels of one image and kTileN output
// channels: 8 x 16 x 128 where co > 64, 16 x 16 x 64 where co <= 64. Each
// thread sums 8 pixels (2 rows x 4 columns) x 8 channels, 64 float32
// accumulators in registers. The K loop walks 8-channel chunks of the
// input; per chunk, cp.async stages into shared memory, double-buffered,
// the (kTileH + 2) x 18 x 8 input box, transposed to [channel][row]
// [column] and zero-filled outside the image and beyond ci (the SAME
// padding and the channel padding, so nothing is masked in the loop), and
// the 9 x 8 x kTileN weight slab (the wrapper packs the weight
// [9][ci_pad][co_pad], zero-padded). A tap is an address offset into the
// box, so there is no im2col copy. For one input channel and tap row dy a
// thread reads its two rows' 6 columns (a 16-byte and an 8-byte load
// each), which serve all three dx taps, and per tap its 8 weights as two
// 16-byte loads (channels 4 cg .. 4 cg + 3 and kTileN / 2 + 4 cg .., so a
// warp's weight loads are contiguous): 10 shared loads per 192 FFMA. The
// box's channel stride is padded by 4 floats, so the 4-byte cp.async
// writes of a warp (4 pixels x 8 channels) fall in distinct banks. The
// epilogue adds the bias, applies ReLU, takes the optional pool inside the
// thread's 2 x 4 pixels (tile origins are even, so a window never crosses
// a thread), and stores 16 bytes at a time where co % 4 == 0, masked at
// the ragged edge.
//
// Plain C interface, bound with ctypes by ops/_build.py.

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 8;            // input channels a K step stages
constexpr int kTileW = 16;           // output columns of a CTA
constexpr int kBoxW = kTileW + 2;    // box columns
constexpr int kRowStride = 20;       // box row: 18 columns, 16-byte rows

template <int kTileN>
struct Tile {
  static constexpr int kTileH = kTileN == 128 ? 8 : 16;
  static constexpr int kGroupsN = kTileN / 8;   // threads across channels
  static constexpr int kBoxH = kTileH + 2;
  // channel stride of the box: its rows, plus 4 floats (bank spread)
  static constexpr int kChStride = kBoxH * kRowStride + 4;
  static constexpr int kBoxFloats = kChunk * kChStride;
  static constexpr int kSlabFloats = 9 * kChunk * kTileN;
  static constexpr int kStageFloats = kBoxFloats + kSlabFloats;
  static constexpr int kSmemBytes = 2 * kStageFloats * 4;
  static_assert(kGroupsN * (kTileH / 2) * (kTileW / 4) == kThreads,
                "one thread per 2x4-pixel x 8-channel micro-tile");
  static_assert(kBoxFloats % 4 == 0 && kStageFloats % 4 == 0,
                "16-byte aligned slabs");
};

struct Args {
  const float* x;
  float* out;
  const float* w;     // [9][ci_pad][co_pad]
  const float* bias;  // [co_pad]
  int h, wd, ci, co, ci_pad, co_pad, tiles_x, tiles_y, tiles_n, pool;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 4 bytes; zeros where !valid (src-size 0 reads nothing)
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// One input channel of the chunk: 9 taps x 8 pixels x 8 channels of FMAs.
// a_k: the box at this channel, row 2 pr, column 4 pc; b_k: the slab at
// this channel, channel 4 cg.
template <int kTileN>
__device__ __forceinline__ void mac(float (&acc)[2][4][8], const float* a_k,
                                    const float* b_k) {
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    float av[2][6];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float* row = a_k + (i + dy) * kRowStride;
      const float4 lo = *reinterpret_cast<const float4*>(row);
      const float2 hi = *reinterpret_cast<const float2*>(row + 4);
      av[i][0] = lo.x;
      av[i][1] = lo.y;
      av[i][2] = lo.z;
      av[i][3] = lo.w;
      av[i][4] = hi.x;
      av[i][5] = hi.y;
    }
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const float* bt = b_k + (3 * dy + dx) * kChunk * kTileN;
      const float4 b0 = *reinterpret_cast<const float4*>(bt);
      const float4 b1 = *reinterpret_cast<const float4*>(bt + kTileN / 2);
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int e = 0; e < 8; ++e)
            acc[i][q][e] = fmaf(av[i][q + dx], bv[e], acc[i][q][e]);
    }
  }
}

// A pixel's 8 channels: ch0 .. ch0 + 3 and ch1 .. ch1 + 3, those < co.
__device__ __forceinline__ void store8(float* pix, const float (&v)[8],
                                       int ch0, int ch1, int co) {
  if ((co & 3) == 0) {  // the pixel is 16-byte aligned
    if (ch0 < co)
      *reinterpret_cast<float4*>(pix + ch0) =
          make_float4(v[0], v[1], v[2], v[3]);
    if (ch1 < co)
      *reinterpret_cast<float4*>(pix + ch1) =
          make_float4(v[4], v[5], v[6], v[7]);
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (ch0 + e < co) pix[ch0 + e] = v[e];
    if (ch1 + e < co) pix[ch1 + e] = v[4 + e];
  }
}

template <int kTileN>
__global__ void __launch_bounds__(kThreads, 2)
conv3x3_f32_kernel(const Args a) {
  using T = Tile<kTileN>;
  extern __shared__ __align__(16) float smem[];
  int id = blockIdx.x;  // channel tile fastest: neighbours share the box
  const int nt = id % a.tiles_n;
  id /= a.tiles_n;
  const int tx = id % a.tiles_x;
  id /= a.tiles_x;
  const int ty = id % a.tiles_y;
  const int b = id / a.tiles_y;
  const int y0 = ty * T::kTileH, x0 = tx * kTileW, n0 = nt * kTileN;
  const float* xb = a.x + static_cast<size_t>(b) * a.h * a.wd * a.ci;

  const int tid = threadIdx.x;
  const int cg = tid % T::kGroupsN, pg = tid / T::kGroupsN;
  const int pr = pg >> 2, pc = pg & 3;  // row pair, column quad

  // chunk `chunk` of the input box and of the weight slab -> stage s
  auto stage = [&](int chunk, int s) {
    float* box = smem + s * T::kStageFloats;
    float* slab = box + T::kBoxFloats;
    const int c0 = chunk * kChunk;
    for (int i = tid; i < T::kBoxH * kBoxW * kChunk; i += kThreads) {
      const int k = i % kChunk, p = i / kChunk;
      const int r = p / kBoxW, c = p % kBoxW;
      const int iy = y0 - 1 + r, ix = x0 - 1 + c, ch = c0 + k;
      const bool ok =
          iy >= 0 && iy < a.h && ix >= 0 && ix < a.wd && ch < a.ci;
      cp_async4(box + k * T::kChStride + r * kRowStride + c,
                ok ? xb + (static_cast<size_t>(iy) * a.wd + ix) * a.ci + ch
                   : a.x,
                ok);
    }
    constexpr int kRowVecs = kTileN / 4;
    for (int i = tid; i < T::kSlabFloats / 4; i += kThreads) {
      const int j = i % kRowVecs, row = i / kRowVecs;  // row = tap x 8 + k
      const int tap = row / kChunk, k = row % kChunk;
      cp_async16(slab + row * kTileN + 4 * j,
                 a.w + static_cast<size_t>(tap * a.ci_pad + c0 + k) *
                           a.co_pad + n0 + 4 * j);
    }
    cp_async_commit();
  };

  float acc[2][4][8];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[i][q][e] = 0.f;

  const int chunks = a.ci_pad / kChunk;
  stage(0, 0);
  for (int chunk = 0; chunk < chunks; ++chunk) {
    if (chunk + 1 < chunks) {
      stage(chunk + 1, (chunk + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* box = smem + (chunk & 1) * T::kStageFloats;
    const float* a_k = box + 2 * pr * kRowStride + 4 * pc;
    const float* b_k = box + T::kBoxFloats + 4 * cg;
    // the channels this chunk really has: conv1_1's 3 of 8 run 3 steps
    const int kn = min(kChunk, a.ci - chunk * kChunk);
#pragma unroll 1
    for (int k = 0; k < kn; ++k)
      mac<kTileN>(acc, a_k + k * T::kChStride, b_k + k * kTileN);
    __syncthreads();  // the next staging overwrites this stage
  }

  // epilogue: bias, ReLU, the optional pool, masked stores
  const int ch0 = n0 + 4 * cg, ch1 = n0 + kTileN / 2 + 4 * cg;
  const float4 bias0 = *reinterpret_cast<const float4*>(a.bias + ch0);
  const float4 bias1 = *reinterpret_cast<const float4*>(a.bias + ch1);
  const float bv[8] = {bias0.x, bias0.y, bias0.z, bias0.w,
                       bias1.x, bias1.y, bias1.z, bias1.w};
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 8; ++e)
        acc[i][q][e] = fmaxf(acc[i][q][e] + bv[e], 0.f);

  if (a.pool) {
    const int oh = a.h / 2, ow = a.wd / 2;
    const int py = y0 / 2 + pr;
#pragma unroll
    for (int q2 = 0; q2 < 2; ++q2) {
      const int px = x0 / 2 + 2 * pc + q2;
      if (py < oh && px < ow) {
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[e] = fmaxf(fmaxf(acc[0][2 * q2][e], acc[0][2 * q2 + 1][e]),
                       fmaxf(acc[1][2 * q2][e], acc[1][2 * q2 + 1][e]));
        store8(a.out + ((static_cast<size_t>(b) * oh + py) * ow + px) * a.co,
               v, ch0, ch1, a.co);
      }
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int y = y0 + 2 * pr + i;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int x = x0 + 4 * pc + q;
      if (y < a.h && x < a.wd)
        store8(a.out + ((static_cast<size_t>(b) * a.h + y) * a.wd + x) * a.co,
               acc[i][q], ch0, ch1, a.co);
    }
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <int kTileN>
int launch(Args a, int b, cudaStream_t stream) {
  using T = Tile<kTileN>;
  a.tiles_x = (a.wd + kTileW - 1) / kTileW;
  a.tiles_y = (a.h + T::kTileH - 1) / T::kTileH;
  a.tiles_n = a.co_pad / kTileN;
  const long long blocks =
      static_cast<long long>(b) * a.tiles_y * a.tiles_x * a.tiles_n;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_f32_kernel<kTileN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  conv3x3_f32_kernel<kTileN><<<static_cast<unsigned>(blocks), kThreads,
                               T::kSmemBytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [b, h, w, ci] and out ([b, h, w, co], or [b, h/2, w/2, co] when
// pooling) float32 NHWC; w the weight packed [9][ci_pad][co_pad] and bias
// [co_pad], both zero-padded (ops/conv_chain.py::conv3x3_f32), with
// ci_pad = ci rounded up to 8 and co_pad = co rounded up to tile_n, which
// is 128 (co > 64) or 64 (co <= 64) (ops/conv_chain.py::f32_tile_n); w
// and bias 16-byte aligned, out too where co % 4 == 0.
extern "C" int ekp_conv3x3_f32(const void* x, void* out, const void* w,
                               const void* bias, int b, int h, int wd, int ci,
                               int co, int pool, int tile_n, void* stream) {
  if (b < 1 || h < 1 || wd < 1 || ci < 1 || co < 1 ||
      (tile_n != 64 && tile_n != 128) || (pool && (h % 2 || wd % 2)) ||
      !aligned(x, 4) || !aligned(out, co % 4 == 0 ? 16 : 4) ||
      !aligned(w, 16) || !aligned(bias, 16))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = {};
  a.x = static_cast<const float*>(x);
  a.out = static_cast<float*>(out);
  a.w = static_cast<const float*>(w);
  a.bias = static_cast<const float*>(bias);
  a.h = h;
  a.wd = wd;
  a.ci = ci;
  a.co = co;
  a.ci_pad = (ci + kChunk - 1) / kChunk * kChunk;
  a.co_pad = (co + tile_n - 1) / tile_n * tile_n;
  a.pool = pool;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return tile_n == 128 ? launch<128>(a, b, s) : launch<64>(a, b, s);
}
