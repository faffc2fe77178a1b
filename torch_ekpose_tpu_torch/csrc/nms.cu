// Peak NMS for the pose decoder: 4-neighbour local-max masking.
//
// Replaces the JAX package's TPU kernel
// torch_ekpose_tpu/ops/pallas_nms.py::masked_peak_scores (_nms_kernel):
//
//   out[y, x] = m[y, x]  if m[y, x] >= max(4 neighbours) and m[y, x] > t
//               -inf     otherwise      (cells outside the map are -inf)
//
// Bound on this card: device-memory bytes. Each output reads five inputs
// that neighbouring threads share, so after L1 it is one 4-byte read and
// one 4-byte write per cell; there is no arithmetic to speak of. Design:
// one thread per output cell of [B, C, H, W], consecutive threads on
// consecutive x, so every load and store is coalesced. The input may be a
// channel slice of a larger NCHW tensor (the 18 part channels of the
// 19-channel heatmap): the kernel takes the batch and channel strides and
// needs only H x W to be contiguous. The maximum propagates NaN, like
// jnp.maximum / torch.maximum, so the kernel equals its twin bit for bit.
//
// Plain C interface, bound with ctypes by ops/_build.py.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? CUDART_NAN_F : fmaxf(a, b);
}

__global__ void nms_kernel(const float* __restrict__ maps,
                           float* __restrict__ out, int c, int h, int w,
                           int stride_b, int stride_c, float thresh,
                           int total) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int x = i % w;
  const int y = (i / w) % h;
  const int ch = (i / (w * h)) % c;
  const int b = i / (w * h * c);
  const float* m = maps + static_cast<size_t>(b) * stride_b +
                   static_cast<size_t>(ch) * stride_c;
  const float neg = -CUDART_INF_F;
  const float v = m[y * w + x];
  const float up = y > 0 ? m[(y - 1) * w + x] : neg;
  const float down = y + 1 < h ? m[(y + 1) * w + x] : neg;
  const float left = x > 0 ? m[y * w + x - 1] : neg;
  const float right = x + 1 < w ? m[y * w + x + 1] : neg;
  const float neigh = nan_max(nan_max(up, down), nan_max(left, right));
  out[i] = (v >= neigh && v > thresh) ? v : neg;
}

}  // namespace

extern "C" int ekp_nms(const float* maps, float* out, int b, int c, int h,
                       int w, int stride_b, int stride_c, float thresh,
                       void* stream) {
  const int total = b * c * h * w;
  if (total > 0) {
    const int threads = 256;
    const int blocks = (total + threads - 1) / threads;
    nms_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        maps, out, c, h, w, stride_b, stride_c, thresh, total);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ekp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
