// Peak NMS for the pose decoder: 4-neighbour local-max masking.
//
// Replaces the JAX package's TPU kernel
// torch_ekpose_tpu/ops/pallas_nms.py::masked_peak_scores (_nms_kernel):
//
//   out[y, x] = m[y, x]  if m[y, x] >= max(4 neighbours) and m[y, x] > t
//               -inf     otherwise      (cells outside the map are -inf)
//
// Bound on this card: device-memory bytes, one 4-byte read and one 4-byte
// write per cell (the serving decode's [8, 18, 46, 54] is 2.86 MB, 0.85 us
// at 3.35 TB/s); there is no arithmetic to speak of, so what is left is
// latency: one round trip to memory, one barrier, one store.
//
// Design. One CTA per (image, channel, band of rows): b, c and the band
// come from blockIdx, so no thread divides to find its plane. The CTA
// stages its band plus one halo row above and below in shared memory
// (rows outside the plane as -inf, so up and down need no test), then
// each thread makes 4 consecutive cells of the flattened band from there
// with one division, one 16-byte and two 4-byte loads for the cells and
// their left and right neighbours, two loads for up and down a cell, five
// compares a cell, and one store for the four. ops/nms.py::plan_nms picks
// the band height (the decode shape: see there).
//
// Two paths, one kernel template:
//  - aligned (the plane's base, both strides and H*W are multiples of 4
//    floats, the band height a multiple of 4 / gcd(W, 4)): the staged span
//    is widened to 16-byte boundaries, which stay inside the plane, and
//    copied with 16-byte cp.async; every band starts on a 16-byte
//    boundary, so each thread's 4 cells are one float4 load and store;
//  - 4-byte (any other plane, e.g. 45x53 maps): the same walk with scalar
//    loads and stores; the last thread of a band may have fewer than 4
//    cells.
// The input may be a channel slice of a larger NCHW tensor (the 18 part
// channels of the 19-channel heatmap): the kernel takes the batch and
// channel strides and needs only each H x W plane to be dense. A NaN
// neighbour fails its >= test as it fails the twin's NaN-propagating
// maximum, so the kernel equals its twin bit for bit.
// tests/test_torch_nms_walk.py emulates this walk on the CPU.
//
// Plain C interface, bound with ctypes by ops/_build.py.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxSmemBytes = 48 * 1024;

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

template <bool kAligned>
__global__ void __launch_bounds__(kMaxThreads)
    nms_kernel(const float* __restrict__ maps, float* __restrict__ out, int h,
               int w, int stride_b, int stride_c, int band_rows,
               float thresh) {
  extern __shared__ __align__(16) float tile[];
  const int c = blockIdx.y, b = blockIdx.z;
  const int y0 = blockIdx.x * band_rows;
  const int y1 = min(h, y0 + band_rows);
  const int hw = h * w;
  const float* plane = maps + static_cast<size_t>(b) * stride_b +
                       static_cast<size_t>(c) * stride_c;
  float* out_plane = out + (static_cast<size_t>(b) * gridDim.y + c) * hw;
  const float neg = -CUDART_INF_F;

  // The tile holds cells [lo, hi) of the flattened plane: rows y0 - 1 to
  // y1 (on the aligned path widened to 16-byte boundaries). Cells outside
  // the plane, in the rows above the first and below the last, hold -inf,
  // so the up and down neighbours need no test.
  int lo = (y0 - 1) * w;
  int hi = (y1 + 1) * w;
  if (kAligned) {
    lo &= ~3;
    hi = (hi + 3) & ~3;
  }
  const int in_lo = max(lo, 0) - lo;  // the plane's part of the tile
  const int in_hi = min(hi, hw) - lo;
  for (int i = threadIdx.x; i < in_lo; i += blockDim.x) tile[i] = neg;
  for (int i = in_hi + threadIdx.x; i < hi - lo; i += blockDim.x) {
    tile[i] = neg;
  }
  if (kAligned) {  // in_lo, in_hi and lo are multiples of 4
    for (int i = in_lo + 4 * threadIdx.x; i < in_hi; i += 4 * blockDim.x) {
      cp_async16(tile + i, plane + lo + i);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::);
  } else {
    for (int i = in_lo + threadIdx.x; i < in_hi; i += blockDim.x) {
      tile[i] = plane[lo + i];
    }
  }
  __syncthreads();

  // A thread makes cells rel .. rel + 3 of the band. A neighbour that is
  // NaN fails its >= test, as it fails the NaN-propagating maximum of the
  // twin, so the four tests stand for that maximum.
  const int base = y0 * w;
  const int cells = (y1 - y0) * w;
  for (int rel = 4 * threadIdx.x; rel < cells; rel += 4 * blockDim.x) {
    const float* cell = tile + (base + rel - lo);
    float v[6];  // the left neighbour, the 4 cells, the right neighbour
    if (kAligned) {
      const float4 q = *reinterpret_cast<const float4*>(cell);
      v[1] = q.x;
      v[2] = q.y;
      v[3] = q.z;
      v[4] = q.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k + 1] = cell[k];
    }
    v[0] = cell[-1];
    v[5] = cell[4];
    int x = rel % w;  // one division for 4 cells
    float r[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float m = v[k + 1];
      const bool peak = (m > thresh) & (m >= cell[k - w]) &
                        (m >= cell[k + w]) & ((x == 0) | (m >= v[k])) &
                        ((x + 1 == w) | (m >= v[k + 2]));
      r[k] = peak ? m : neg;
      if (++x == w) x = 0;
    }
    if (kAligned) {
      *reinterpret_cast<float4*>(out_plane + base + rel) =
          make_float4(r[0], r[1], r[2], r[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (rel + k < cells) out_plane[base + rel + k] = r[k];
      }
    }
  }
}

}  // namespace

// maps: [b, c, h, w] with dense h x w planes at stride_b / stride_c
// floats; out: dense [b, c, h, w]. band_rows and threads come from
// ops/nms.py::plan_nms; aligned selects the 16-byte path, whose
// conditions are checked here again (cudaErrorInvalidValue otherwise).
extern "C" int ekp_nms(const float* maps, float* out, int b, int c, int h,
                       int w, int stride_b, int stride_c, float thresh,
                       int band_rows, int threads, int aligned,
                       void* stream) {
  if (b <= 0 || c <= 0 || h <= 0 || w <= 0) return 0;
  const size_t smem = (static_cast<size_t>(band_rows + 2) * w + 8) *
                      sizeof(float);
  if (band_rows <= 0 || threads <= 0 || threads > kMaxThreads ||
      threads % 32 != 0 || smem > kMaxSmemBytes || c > 65535 || b > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((h + band_rows - 1) / band_rows, c, b);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (aligned) {
    const bool ok = reinterpret_cast<size_t>(maps) % 16 == 0 &&
                    reinterpret_cast<size_t>(out) % 16 == 0 &&
                    stride_b % 4 == 0 && stride_c % 4 == 0 &&
                    (h * w) % 4 == 0 &&
                    (static_cast<long long>(band_rows) * w) % 4 == 0;
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
    nms_kernel<true><<<grid, threads, smem, s>>>(maps, out, h, w, stride_b,
                                                 stride_c, band_rows, thresh);
  } else {
    nms_kernel<false><<<grid, threads, smem, s>>>(
        maps, out, h, w, stride_b, stride_c, band_rows, thresh);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ekp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
