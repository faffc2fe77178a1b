// Fused chain of bf16 3x3 SAME conv + bias + ReLU layers, then an
// optional 2x2/2 max pool, in one pass: the narrow bf16 chains.
//
// Replaces, for bf16 chains that no other route takes (a layer with ci or
// co not a multiple of 64, block-1 shapes other than vgg2016's), the JAX
// package's TPU kernel torch_ekpose_tpu/ops/pallas_conv.py::conv_chain
// (_conv_chain_tpu, _chain_kernel). Each layer's result is rounded to
// bf16 and zeroed outside the image before the next layer reads it, so the
// chain equals the unfused one: a chained SAME conv sees zeros beyond the
// image border, not the previous layer's halo. vgg2016's prefix never
// comes here: its bf16 block 1 runs on block1_sm90.cu, its bf16 blocks 2-3
// on conv3x3_sm90.cu, and every float32 chain on conv3x3_f32.cu (one
// launch per layer), so this kernel has no float32 instantiation.
//
// Bound on this card: tensor-core operations for wide chains; the narrow
// chains it keeps are small and bound by their halo recompute and launch.
//
// Design. The TPU kernel keeps a 16-row, full-width tile of every
// intermediate in ~100 MB of VMEM. A Hopper block has at most 227 KB, so
// a block here owns a 2-D output tile and recomputes the halo: for n
// layers it loads the (th + 2n) x (tw + 2n) input region, layer j computes
// a region 2 (n - 1 - j) pixels wider than the tile, and the intermediates
// ping-pong between two shared-memory buffers. The host picks the largest
// tile of 32x32 ... 2x2 whose buffers fit. Each layer is an implicit GEMM
// on mma.sync (conv_common.cuh), with the weights read from L2 in
// fragment order, so no weight lives in shared memory.
//
// Plain C interface, bound with ctypes by ops/_build.py.

#include "conv_common.cuh"

namespace {

using namespace ekp_conv;

constexpr int kMaxLayers = 8;

struct ChainArgs {
  const void* x;
  void* out;
  const void* w[kMaxLayers];
  const float* bias[kMaxLayers];
  int ch[kMaxLayers + 1];  // real channels: input, then each layer's out
  int n_layers, height, width, pool, th, tw, tiles_y, tiles_x;
  int buf1;  // element offset of the second shared buffer
};

// shared-memory elements of each ping-pong buffer for a th x tw tile
void buffer_sizes(const ChainArgs& a, int th, int tw, long* b0, long* b1) {
  const int n = a.n_layers;
  *b0 = (long)(th + 2 * n) * (tw + 2 * n) * pix_stride(a.ch[0]);
  *b1 = 0;
  for (int j = 0; j < n; ++j) {
    const int halo = n - 1 - j;
    const long e = (long)(th + 2 * halo) * (tw + 2 * halo) *
                   pix_stride(a.ch[j + 1]);
    long* dst = (j % 2 == 0) ? b1 : b0;  // layer j writes buffer (j+1) % 2
    if (e > *dst) *dst = e;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
conv_chain_kernel(const ChainArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* bufs[2] = {reinterpret_cast<bf16*>(smem_raw),
                   reinterpret_cast<bf16*>(smem_raw) + a.buf1};
  const int n = a.n_layers;
  const int tiles = a.tiles_y * a.tiles_x;
  const int b = blockIdx.x / tiles;
  const int ty = (blockIdx.x % tiles) / a.tiles_x;
  const int tx = blockIdx.x % a.tiles_x;
  const int y0 = ty * a.th, x0 = tx * a.tw;
  const int h = a.height, w = a.width;

  // the input region, zero outside the image and beyond the real channels
  {
    const int rows = a.th + 2 * n, cols = a.tw + 2 * n;
    const int c0 = a.ch[0], cp = pad_ch(c0), ps = pix_stride(c0);
    const bf16* x = static_cast<const bf16*>(a.x) + (size_t)b * h * w * c0;
    for (int i = threadIdx.x; i < rows * cols * cp; i += kThreads) {
      const int c = i % cp, p = i / cp;
      const int iy = y0 - n + p / cols, ix = x0 - n + p % cols;
      bf16 v = __float2bfloat16_rn(0.f);
      if (c < c0 && iy >= 0 && iy < h && ix >= 0 && ix < w)
        v = x[((size_t)iy * w + ix) * c0 + c];
      bufs[0][p * ps + c] = v;
    }
  }
  __syncthreads();

  for (int j = 0; j < n; ++j) {
    const int halo = n - 1 - j;
    const int ci = a.ch[j], co = a.ch[j + 1];
    conv_layer(bufs[j % 2], pix_stride(ci), bufs[(j + 1) % 2],
               pix_stride(co), a.th + 2 * halo, a.tw + 2 * halo,
               static_cast<const bf16*>(a.w[j]), a.bias[j], pad_ch(ci) / 16,
               pad_ch(co), halo > 0, y0 - halo, x0 - halo, h, w);
    __syncthreads();
  }

  const int co = a.ch[n];
  const int out_h = a.pool ? h / 2 : h, out_w = a.pool ? w / 2 : w;
  store_tile(bufs[n % 2], pix_stride(co), a.th, a.tw, co, a.pool != 0,
             static_cast<bf16*>(a.out) + (size_t)b * out_h * out_w * co, y0,
             x0, out_h, out_w);
}

}  // namespace

// x [b, h, w, ch[0]] and out NHWC bf16; w[j] the packed weights of layer j
// (ops/conv_chain.py::pack_weight), bias[j] float32 padded to
// pad_ch(ch[j + 1]).
extern "C" int ekp_conv_chain(const void* x, void* out, const void* const* w,
                              const void* const* bias, const int* ch,
                              int n_layers, int b, int h, int wd, int pool,
                              void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers)
    return static_cast<int>(cudaErrorInvalidValue);
  ChainArgs a = {};
  a.x = x;
  a.out = out;
  for (int j = 0; j < n_layers; ++j) {
    a.w[j] = w[j];
    a.bias[j] = static_cast<const float*>(bias[j]);
  }
  for (int j = 0; j <= n_layers; ++j) a.ch[j] = ch[j];
  a.n_layers = n_layers;
  a.height = h;
  a.width = wd;
  a.pool = pool;
  return launch_tiled(conv_chain_kernel, a, b, buffer_sizes,
                      static_cast<cudaStream_t>(stream));
}
