// VGG block 1 fused: conv1_1 (3 -> c1) + conv1_2 (c1 -> c2) + 2x2/2 max
// pool, or conv1_1 alone (conv1_only), each conv + bias + ReLU.
//
// Replaces the JAX package's TPU kernels scripts/profile_block1.py::
// block1_fused (_kernel, variants A and B) and ::conv1_fused
// (_conv1_kernel). Both compute conv1_1 as ONE product of 27-deep patches
// (3x3 taps x 3 channels, padded to 32) instead of nine 3-deep taps.
//
// Variants A (patches-576) and B (dy-concat-192) differ only in the shape
// of conv1_2's product on the TPU's 128x128 MXU; they compute the same
// function. On Hopper the implicit GEMM of conv_common.cuh reads the 3x3
// window straight from shared memory by ldmatrix row addresses, so the
// 576-deep product needs no patch copy and there is nothing left for a
// second variant to choose: this file has one kernel, with no variant.
//
// Bound on this card: conv1_fused by device-memory bytes (4.4 GFLOP but a
// 163 MB 64-channel output at batch 8, 368x432, bf16: ~0.05 ms at
// 3.35 TB/s); block1_fused by tensor-core operations (98 GFLOP: ~0.1 ms
// at 989 TFLOP/s, against 7.6 MB in and 41 MB out). Design: a block owns
// a 2-D output tile (the host picks the largest of 32x32 ... 2x2 whose
// buffers fit: 32x32 for conv1_only, 32x16 for the block in bf16). It
// writes the conv1_1 region's 27-value patches into shared memory, runs
// conv1_1 as a 1-tap 32-deep GEMM, zeroes that intermediate outside the
// image (the halo conv1_2 reads), runs conv1_2 as a 9-tap GEMM, and pools
// while it writes the tile out, so the full-resolution intermediate never
// reaches device memory. conv1_only writes its tile with 16-byte stores.
//
// Plain C interface, bound with ctypes by ops/_build.py.

#include "conv_common.cuh"

namespace {

using namespace ekp_conv;

constexpr int kPatch = 27;                   // 3 x 3 taps x 3 channels
constexpr int kPatchPs = 32 + 8;             // padded to 32, + 8 (banks)

struct Block1Args {
  const void* x;
  void* out;
  const void* w1;
  const float* b1;
  const void* w2;
  const float* b2;
  int c1, c2, height, width, conv1_only, th, tw, tiles_y, tiles_x, buf1;
};

void buffer_sizes(const Block1Args& a, int th, int tw, long* b0, long* b1) {
  const int halo = a.conv1_only ? 0 : 1;
  const long region = (long)(th + 2 * halo) * (tw + 2 * halo);
  *b0 = region * kPatchPs;                  // patches, then conv1_2's out
  if (!a.conv1_only) {
    const long out2 = (long)th * tw * pix_stride(a.c2);
    if (out2 > *b0) *b0 = out2;
  }
  *b1 = region * pix_stride(a.c1);          // conv1_1's out
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
block1_kernel(const Block1Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* buf0 = reinterpret_cast<T*>(smem_raw);
  T* buf1 = buf0 + a.buf1;
  const int tiles = a.tiles_y * a.tiles_x;
  const int b = blockIdx.x / tiles;
  const int ty = (blockIdx.x % tiles) / a.tiles_x;
  const int tx = blockIdx.x % a.tiles_x;
  const int y0 = ty * a.th, x0 = tx * a.tw;
  const int h = a.height, w = a.width;
  const int halo = a.conv1_only ? 0 : 1;
  const int rows = a.th + 2 * halo, cols = a.tw + 2 * halo;

  // patches of conv1_1's region: k = (3 * dy + dx) * 3 + c, the row order
  // of the HWIO weight reshaped to [27, c1]; zero outside the image
  const T* x = static_cast<const T*>(a.x) + (size_t)b * h * w * 3;
  for (int i = threadIdx.x; i < rows * cols * 32; i += kThreads) {
    const int k = i % 32, p = i / 32;
    T v = from_f<T>(0.f);
    if (k < kPatch) {
      const int tap = k / 3, c = k % 3;
      const int iy = y0 - halo + p / cols + tap / 3 - 1;
      const int ix = x0 - halo + p % cols + tap % 3 - 1;
      if (iy >= 0 && iy < h && ix >= 0 && ix < w)
        v = x[((size_t)iy * w + ix) * 3 + c];
    }
    buf0[p * kPatchPs + k] = v;
  }
  __syncthreads();

  conv_layer<T, 1>(buf0, kPatchPs, buf1, pix_stride(a.c1), rows, cols,
                   static_cast<const T*>(a.w1), a.b1, 2, pad_ch(a.c1),
                   !a.conv1_only, y0 - halo, x0 - halo, h, w);
  __syncthreads();
  if (a.conv1_only) {
    store_tile<T>(buf1, pix_stride(a.c1), a.th, a.tw, a.c1, false,
                  static_cast<T*>(a.out) + (size_t)b * h * w * a.c1, y0, x0,
                  h, w);
    return;
  }

  conv_layer<T, 9>(buf1, pix_stride(a.c1), buf0, pix_stride(a.c2), a.th,
                   a.tw, static_cast<const T*>(a.w2), a.b2, pad_ch(a.c1) / 16,
                   pad_ch(a.c2), false, y0, x0, h, w);
  __syncthreads();
  store_tile<T>(buf0, pix_stride(a.c2), a.th, a.tw, a.c2, true,
                static_cast<T*>(a.out) + (size_t)b * (h / 2) * (w / 2) * a.c2,
                y0, x0, h / 2, w / 2);
}

}  // namespace

// x [b, h, w, 3] NHWC of bf16 (is_bf16) or float32; w1 the packed
// [1, 32, pad_ch(c1)] patch weights and w2 the packed [9, pad_ch(c1),
// pad_ch(c2)] weights (ops/conv_chain.py::pack_weight); b1, b2 float32
// padded likewise. out: [b, h, w, c1] (conv1_only) or [b, h/2, w/2, c2].
extern "C" int ekp_block1(const void* x, void* out, const void* w1,
                          const void* b1, const void* w2, const void* b2,
                          int c1, int c2, int b, int h, int wd,
                          int conv1_only, int is_bf16, void* stream) {
  Block1Args a = {};
  a.x = x;
  a.out = out;
  a.w1 = w1;
  a.b1 = static_cast<const float*>(b1);
  a.w2 = w2;
  a.b2 = static_cast<const float*>(b2);
  a.c1 = c1;
  a.c2 = c2;
  a.height = h;
  a.width = wd;
  a.conv1_only = conv1_only;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_tiled<__nv_bfloat16>(
                       block1_kernel<__nv_bfloat16>, a, b, buffer_sizes, s)
                 : launch_tiled<float>(block1_kernel<float>, a, b,
                                       buffer_sizes, s);
}
