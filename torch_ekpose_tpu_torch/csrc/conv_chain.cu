// A fused chain of bf16 3x3 SAME conv + bias + ReLU layers, then an
// optional 2x2/2 max pool, in one launch: the narrow bf16 chains.
//
// Replaces, for the bf16 chains that no other route takes (a layer with ci
// or co not a multiple of 64, block-1 shapes other than vgg2016's), the JAX
// package's TPU kernel torch_ekpose_tpu/ops/pallas_conv.py::conv_chain
// (:163; its kernel _conv_chain_tpu, :110). Each layer's result is rounded
// to bf16 and zeroed outside the image before the next layer reads it, so
// the chain equals the unfused one. vgg2016's prefix never comes here: its
// bf16 block 1 runs on block1_sm90.cu, its bf16 blocks 2-3 on
// conv3x3_sm90.cu and every float32 chain on conv3x3_f32.cu.
//
// Bound on this card (H100 SXM: 989 TFLOP/s bf16, 3.35 TB/s). A one-layer
// chain at 8 channels is bound by bytes: at batch 8, 368x432 it is 1.5
// GFLOP (1.5 us) against 40.7 MB in and out (12.1 us). The timed block,
// [3, 32, 32] + pool at batch 8, 368x432, is bound by operations: 25.6
// GFLOP (25.9 us) against 28 MB (8.4 us).
//
// Design. The TPU kernel keeps a 16-row, full-width tile of every
// intermediate in ~100 MB of VMEM. Here one persistent CTA per SM walks
// the output tiles with a static stride and keeps a tile's whole chain on
// chip: for n layers it holds the (th + 2n) x (tw + 2n) input box, layer
// j computes a region 2 (n - 1 - j) pixels wider than the tile (the halo
// is recomputed), and the intermediates ping-pong between two regions of
// shared memory, each pixel's channels padded to 16 plus 8 more so that
// ldmatrix rows fall in distinct banks. The host (ops/conv_chain.py::
// fused_plan) picks the tile, 32x64 down to 2x2, from a cost model
// calibrated on this kernel's phase trace (at the timed shape 32x48: the
// first layer recomputes 11% of its pixels) and lays out shared memory;
// this file reads that plan. Every chain the mma.sync kernel before this
// one took fits (tests/test_torch_conv_narrow.py sweeps them).
//   - Weights are loaded once per CTA by one bulk copy and stay resident.
//     A chain whose weights do not fit beside the tile's buffers streams
//     them one chunk (a layer's K x nc block) at a time into one slot, and
//     a layer whose one chunk does not fit (K = 9 x 2048 at nc = 8, say)
//     streams it K slice by K slice for each M tile (the kSliced kernel:
//     slow, and only where nothing else fits). Biases are read from device
//     memory once a chunk.
//   - The input box of the next tile is loaded while the current one
//     computes: one TMA load, completing on an mbarrier, of the input
//     described as [B, H, W, C] where C is a multiple of 8 up to 256 (a
//     box dimension is at most 256), else as [B, H, W*C] (B its own
//     dimension, so rows above the image are TMA's zero fill, not the
//     image before; the box starts on 16 bytes). A patch layer reads its
//     box, so that box has two buffers; any other first layer's box is
//     repacked into the padded region at once, and the next box comes into
//     the one buffer after that. Where TMA cannot describe the box (a row
//     over 256 elements, an unaligned base or start), each thread holds up
//     to kPre elements of the next box in registers across the tile and
//     stores them after it, a patch layer's into the dense buffer, any
//     other's straight into the padded region.
//   - A first layer with ci <= 8 is one patch product, K = round_up(9 ci,
//     16) (32 for 3 channels, not 9 taps x 16), its A fragments read from
//     the dense box by a table of patch offsets. Other layers are an
//     implicit GEMM over 9 taps x round_up(ci, 16), K ordered 16-channel
//     slice by slice (the 9 taps of a slice together), so that a slice of
//     the packed weights is contiguous.
//   - Every layer runs on wgmma.m64nNk16 with A from registers: M = 64
//     output pixels a warpgroup (three warpgroups take turns over a
//     layer's 64-pixel tiles), each warp's 16 rows in the register layout
//     of mma.sync's A fragment, which ldmatrix fills from the shifted 3x3
//     window (no im2col). B is the layer's weights in shared memory, in
//     wgmma's no-swizzle K-major layout [K / 8][nc][8]. Weights as A
//     (block1_sm90's roles) would leave most of M empty at co < 64. A
//     layer's A fragments go into registers a batch at a time (the patch
//     layer's steps; the 9 taps of one 16-channel slice otherwise), then
//     the batch's wgmmas issue back to back under one fence, and two
//     register batches alternate so that the next batch's ldmatrix runs
//     under this one's products.
//   - N: every layer's output is computed in chunks of nc = 8, 16, 24 or
//     32 channels, one width for the whole chain (the widest layer's
//     output rounded up to 8, at most 32), and each width is its own
//     kernel: ptxas serializes every wgmma of a function that holds
//     accumulators of several shapes, or of 64 columns beside the A
//     batches, for want of registers.
//   - The epilogue works on the accumulators: bias, ReLU, bf16, the zero
//     mask outside the image, branch-free. The last layer's rows are 2x8
//     pixel blocks a warp (columns past a tile narrower than 8 dropped),
//     so a 2x2 pool window is two registers of one thread and the same
//     registers of the lane 4 apart (one shuffle). The pooled or full tile
//     goes through a staging region to 16-byte stores.
//
// Where the time goes (scripts/profile_torch_chain.py, which builds this
// file with -DEKP_CHAIN_PROBE): at the timed block the second layer's
// products, the first layer's per-tile overhead (its K is 32: loads and
// epilogue, not products) and the epilogues. See PERF.md.
//
// Plain C interface, bound with ctypes by ops/_build.py. The tensor map is
// encoded on every call by cuTensorMapEncodeTiled, found at run time with
// cudaGetDriverEntryPoint, so the library needs no -lcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxLayers = 8;
constexpr int kThreads = 384;                // three warpgroups
constexpr int kGroups = kThreads / 128;
constexpr int kPre = 8;                      // fallback: box elements a
                                             // thread holds ahead

// One layer of the plan (ops/conv_chain.py::FusedLayer).
struct Layer {
  int ci, co;       // real channels in and out
  int n;            // channels computed: round_up(co, nc)
  int nc;           // N of a weight chunk: 8, 16, 24 or 32, one for all
                    // layers (n is a multiple of it)
  int ksteps;       // k16 steps: the patch's, or 9 x round_up(ci, 16) / 16
  int w_off;        // byte offset of the layer's packed weights
  int b_off;        // float offset of its bias
  int ks;           // 16-channel K slices (9 k16 steps each) a weight
                    // load of a sliced plan; round_up(ci, 16) / 16 else
};

// The launch plan, field by field as ops/conv_chain.py::FusedPlan.ints packs
// it (its fields, then kMaxLayers layers). Offsets are bytes from
// the 128-byte aligned start of shared memory.
struct Plan {
  int n_layers, batch, height, width, pool;
  int th, tw, tiles_y, tiles_x;
  int patch, resident;
  int sliced;       // weights stream K slice by K slice (kSliced kernel)
  int tma;          // the box by TMA: 3 as [B, H, W * C], 4 as [B, H, W, C];
                    // 0 through registers
  int smem, off_in0, off_in1, off_buf0, off_buf1, off_w, off_patch;
  int in_pitch, box_rows, box_cols, box_shift;
  int w_bytes;
  Layer layer[kMaxLayers];
};
constexpr int kPlanInts = sizeof(Plan) / sizeof(int);

struct Args {
  CUtensorMap map;      // the input, when p.tma
  const bf16* x;
  bf16* out;
  const bf16* w;        // every layer's packed weights
  const float* bias;    // every layer's bias, zero-padded to its n
  Plan p;
};

__host__ __device__ __forceinline__ int pad16(int c) {
  return (c + 15) / 16 * 16;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack2(unsigned short lo,
                                          unsigned short hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed. A copy
// that never lands traps after ~2^32 cycles instead of hanging the card.
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

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// `bytes` contiguous bytes from global memory to shared memory, completing
// on `bar` (16-byte aligned, a multiple of 16).
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// wgmma shared-memory descriptor, no swizzle (layout type 0), K-major: the
// operand is 8-row x 16-byte core matrices of 128 contiguous bytes; `lbo`
// is the byte step between the two core matrices of a k16 step (along K),
// `sbo` the byte step to the next 8 rows (along N).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(kPending)
               : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma instructions.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define EKP_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])

// d[64 x N] (+)= A[64 x 16] * B[16 x N]: A from registers (each warp's 16
// rows in mma.sync's m16n8k16 A fragment layout), B K-major in shared
// memory (descriptor b), f32 sums; scale_d == 0 ignores d's old value.
// Register i of thread (warp w of the warpgroup, lane l) holds row
// 16 w + l / 4 + 8 ((i / 2) % 2), column 8 (i / 4) + 2 (l % 4) + i % 2.
template <int N>
struct Wgmma;

template <>
struct Wgmma<8> {
  static __device__ __forceinline__ void mma(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : EKP_D4(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void mma(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : EKP_D4(0), EKP_D4(4)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<24> {
  static __device__ __forceinline__ void mma(float (&d)[12],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11"
      "}, {%12, %13, %14, %15}, %16, p, 1, 1, 0;\n}\n"
      : EKP_D4(0), EKP_D4(4), EKP_D4(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : EKP_D4(0), EKP_D4(4), EKP_D4(8), EKP_D4(12)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

#undef EKP_D4

// Phase probes for scripts/profile_torch_chain.py. Built with
// -DEKP_CHAIN_PROBE, thread 0 of each CTA adds up the clock cycles of each
// phase of its tiles (kProbeWait: the box's wait, kProbeRepack, then each
// layer, kProbeStore: the store and the next box's fallback store) and
// counts its tiles, into ekp_chain_probe[block][probe]; otherwise the
// probes compile to nothing.
#ifdef EKP_CHAIN_PROBE
constexpr int kProbeWait = 0, kProbeRepack = 1, kProbeLayer = 2,
              kProbeStore = kProbeLayer + kMaxLayers,
              kProbeTiles = kProbeStore + 1, kProbes = kProbeTiles + 1;
__device__ long long ekp_chain_probe[1024 * kProbes];
#define EKP_PROBE_START \
  long long probe_t = clock64(), probe_acc[kProbes] = {};
#define EKP_PROBE(i)                                 \
  {                                                  \
    const long long probe_now = clock64();           \
    probe_acc[i] += probe_now - probe_t;             \
    probe_t = probe_now;                             \
  }
#define EKP_PROBE_END                                               \
  if (threadIdx.x == 0)                                             \
    for (int i = 0; i < kProbes; ++i)                               \
      ekp_chain_probe[blockIdx.x * kProbes + i] = probe_acc[i];
#define EKP_PROBE_TILE ++probe_acc[kProbeTiles];
// inside the M tiles of warpgroup 0 (thread 0), by layer: the cycles of
// kMtProbes segments (address setup, A loads, the products' issue, their
// wait, the epilogue), summed in registers over a chunk and added to
// ekp_chain_probe_mt[block][layer][segment] at its end
constexpr int kMtProbes = 5;
__device__ long long ekp_chain_probe_mt[1024 * kMaxLayers * kMtProbes];
#define EKP_PROBE_MT_DECL long long probe_seg[kMtProbes] = {}, probe_mt = 0;
#define EKP_PROBE_MT_START probe_mt = clock64();
#define EKP_PROBE_MT(i)                         \
  {                                             \
    const long long probe_now = clock64();      \
    probe_seg[i] += probe_now - probe_mt;       \
    probe_mt = probe_now;                       \
  }
#define EKP_PROBE_MT_FLUSH                                                 \
  if (threadIdx.x == 0)                                                    \
    for (int i = 0; i < kMtProbes; ++i)                                    \
      ekp_chain_probe_mt[(blockIdx.x * kMaxLayers + k.j) * kMtProbes + i] \
          += probe_seg[i];
#else
#define EKP_PROBE_MT_DECL
#define EKP_PROBE_MT_START
#define EKP_PROBE_MT(i)
#define EKP_PROBE_MT_FLUSH
#define EKP_PROBE_START
#define EKP_PROBE(i)
#define EKP_PROBE_END
#define EKP_PROBE_TILE
#endif

// Image, first output row and first output column of tile t.
__device__ __forceinline__ void tile_origin(const Plan& p, int t, int* b,
                                            int* y0, int* x0) {
  const int per_image = p.tiles_y * p.tiles_x;
  *b = t / per_image;
  const int r = t % per_image;
  *y0 = r / p.tiles_x * p.th;
  *x0 = r % p.tiles_x * p.tw;
}

// ---------------------------------------------------------------------------
// the input box: rows y0 - n .., elements (x0 - n) C .. of the [B, H, W C]
// input, zero outside the image, in rows of in_pitch elements from element
// box_shift on (a TMA box starts on 16 bytes: x0 C is a multiple of 8, so
// box_shift = (-n C) mod 8 is one number for every tile)
// ---------------------------------------------------------------------------

// One TMA load of tile t's box into input buffer `buf`.
__device__ __forceinline__ void issue_box(const Args& a, unsigned char* smem,
                                          int t, int buf) {
  const Plan& p = a.p;
  int b, y0, x0;
  tile_origin(p, t, &b, &y0, &x0);
  const uint32_t bar = smem_u32(smem) + 8 * buf;
  const uint32_t dst = smem_u32(smem + (buf ? p.off_in1 : p.off_in0));
  const int n = p.n_layers;
  mbar_expect_tx(bar, p.box_rows * p.in_pitch * 2);
  if (p.tma == 4)
    tma_load_4d(dst, &a.map, bar, 0, x0 - n, y0 - n, b);
  else
    tma_load_3d(dst, &a.map, bar, (x0 - n) * p.layer[0].ci - p.box_shift,
                y0 - n, b);
}

// The fallback: element e of a box as bf16 bits, read from device memory,
// and its place in smem. A patch layer's box is dense (row-major over
// box_cols x ci elements a row, as TMA lands it); any other first layer's
// goes straight to the padded region it reads (buffer 0, pixel stride
// round_up(ci, 16) + 8): e runs over round_up(ci, 16) channels a pixel,
// zero past ci.
struct Box {
  int b, iy0, ix0;      // image, first row, first column
};

__device__ __forceinline__ Box box_of(const Plan& p, int t) {
  int b, y0, x0;
  tile_origin(p, t, &b, &y0, &x0);
  return {b, y0 - p.n_layers, x0 - p.n_layers};
}

__device__ __forceinline__ int box_total(const Plan& p) {
  const int c = p.layer[0].ci;
  return p.box_rows * p.box_cols * (p.patch ? c : pad16(c));
}

__device__ __forceinline__ unsigned short box_elem(const Args& a,
                                                   const Box& bx, int e) {
  const Plan& p = a.p;
  const int c = p.layer[0].ci, cp = p.patch ? c : pad16(c);
  const int pix = e / cp, ch = e % cp;
  const int y = bx.iy0 + pix / p.box_cols, x = bx.ix0 + pix % p.box_cols;
  if (ch >= c || y < 0 || y >= p.height || x < 0 || x >= p.width) return 0;
  return __ldg(reinterpret_cast<const unsigned short*>(a.x) +
               (((size_t)bx.b * p.height + y) * p.width + x) * c + ch);
}

__device__ __forceinline__ void put_elem(const Plan& p, unsigned short* in,
                                         int e, unsigned short v) {
  const int c = p.layer[0].ci;
  if (p.patch) {
    const int row_e = p.box_cols * c;
    in[e / row_e * p.in_pitch + p.box_shift + e % row_e] = v;
  } else {
    const int cp = pad16(c);
    in[e / cp * (cp + 8) + e % cp] = v;
  }
}

// The fallback's box of tile t into input buffer `buf` (a patch layer's)
// or buffer 0: the `pre` elements loaded ahead (kPre a thread), then the
// rest.
__device__ __forceinline__ void store_box(const Args& a, unsigned char* smem,
                                          int t, int buf,
                                          const unsigned short (&pre)[kPre],
                                          bool have_pre) {
  const Plan& p = a.p;
  unsigned short* in = reinterpret_cast<unsigned short*>(
      smem + (!p.patch ? p.off_buf0 : buf ? p.off_in1 : p.off_in0));
  const int total = box_total(p);
  const Box bx = box_of(p, t);
  int e = threadIdx.x;
  if (have_pre) {
#pragma unroll
    for (int i = 0; i < kPre; ++i, e += kThreads)
      if (e < total) put_elem(p, in, e, pre[i]);
  }
  for (; e < total; e += kThreads) put_elem(p, in, e, box_elem(a, bx, e));
}

__device__ __forceinline__ void prefetch_box(const Args& a, int t,
                                             unsigned short (&pre)[kPre]) {
  const Plan& p = a.p;
  const int total = box_total(p);
  const Box bx = box_of(p, t);
#pragma unroll
  for (int i = 0; i < kPre; ++i) {
    const int e = threadIdx.x + i * kThreads;
    pre[i] = e < total ? box_elem(a, bx, e) : static_cast<unsigned short>(0);
  }
}

// A first layer that is not one patch product reads a padded region like
// every later layer: the dense box TMA landed -> buffer 0, pixel stride
// round_up(ci, 16) + 8, zero past ci.
__device__ __forceinline__ void repack_box(const Plan& p, unsigned char* smem,
                                           int in_off) {
  const int c = p.layer[0].ci, cp = pad16(c), ps = cp + 8;
  const int px = p.box_rows * p.box_cols;
  const bf16* in = reinterpret_cast<const bf16*>(smem + in_off) + p.box_shift;
  bf16* dst = reinterpret_cast<bf16*>(smem + p.off_buf0);
  if (c % 8 == 0) {
    const int groups = cp / 8;
    for (int i = threadIdx.x; i < px * groups; i += kThreads) {
      const int pix = i / groups, gi = i % groups;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (8 * gi < c)
        v = *reinterpret_cast<const uint4*>(
            in + pix / p.box_cols * p.in_pitch + pix % p.box_cols * c + 8 * gi);
      *reinterpret_cast<uint4*>(dst + pix * ps + 8 * gi) = v;
    }
    return;
  }
  const unsigned short* s = reinterpret_cast<const unsigned short*>(in);
  unsigned short* d = reinterpret_cast<unsigned short*>(dst);
  for (int i = threadIdx.x; i < px * cp; i += kThreads) {
    const int pix = i / cp, ch = i % cp;
    d[pix * ps + ch] =
        ch < c ? s[pix / p.box_cols * p.in_pitch + pix % p.box_cols * c + ch]
               : static_cast<unsigned short>(0);
  }
}

// ---------------------------------------------------------------------------
// one layer
// ---------------------------------------------------------------------------

// One layer's walk over its output region (for the last layer, the tile),
// with the plan's numbers that its M tiles read, copied out of the kernel
// parameters once a layer (reading those in the inner loops costs a load
// each time).
struct Walk {
  int j;                // the layer
  bool last, patch, pool;
  int th, tw, height, width, in_pitch;
  int ci, n, ksteps, ks;  // the layer's
  const float* bias;    // its bias (device memory)
  int patch_off;        // smem byte offset of the patch offsets
  int rows, cols;       // output region
  int span;             // last: 2x8 blocks a block row (round_up(tw, 8) /
                        // 8); else cols
  int step_q, step_r;   // kGroups M tiles on: rows (block rows) and columns
                        // (blocks) a tracked row moves (see RowPix)
  int halo;             // the region starts `halo` pixels before the tile
  int mtiles;           // 64-row M tiles
  int in_off;           // the dense box (patch) or the input region
  int in_cols, in_ps, kc;  // input region: width, pixel stride, k16 a tap
  int out_off, out_ps;  // output region, or the last layer's staging
  int trash;            // the spare pixel after the output (see epilogue)
  int y0, x0;           // image position of the tile's first output pixel
};

// Which pixel of the output region row r (0 .. 15) of warp w in M tile mt
// computes: consecutive pixels m = 64 mt + 16 w + r, or for the last layer
// the 2x8 block 4 mt + w (rows 0-7 one image row, rows 8-15 the next), so
// that a pool window is rows r, r + 8 of neighbouring columns; a block's
// columns past a tile narrower than 8 are dropped. A warpgroup
// walks its tiles mt, mt + kGroups, ...; row_next moves a row along
// without a division.
struct RowPix {
  int m;                // the pixel index; last: the block index
  int y, x;             // its row and column; last: block row and column
};

__device__ __forceinline__ RowPix row_start(const Walk& k, int mt, int w,
                                            int r) {
  RowPix t;
  t.m = k.last ? 4 * mt + w : 64 * mt + 16 * w + r;
  t.y = t.m / k.span;
  t.x = t.m % k.span;
  return t;
}

__device__ __forceinline__ void row_next(const Walk& k, RowPix& t) {
  t.m += k.last ? 4 * kGroups : 64 * kGroups;
  t.y += k.step_q;
  t.x += k.step_r;
  if (t.x >= k.span) {
    t.x -= k.span;
    ++t.y;
  }
}

// Row r's pixel (pr, pc); false for the padding rows past the region,
// which compute pixel (0, 0) and are dropped.
__device__ __forceinline__ bool row_at(const Walk& k, const RowPix& t, int r,
                                       int* pr, int* pc) {
  const int y = k.last ? 2 * t.y + (r >> 3) : t.y;
  const int x = k.last ? 8 * t.x + (r & 7) : t.x;
  const bool valid = k.last ? t.m < (k.th / 2) * k.span && x < k.tw
                            : t.m < k.rows * k.cols;
  *pr = valid ? y : 0;
  *pc = valid ? x : 0;
  return valid;
}

// A first layer's patch product has at most this many k16 steps (ci <= 8:
// K = round_up(9 ci, 16) <= 80).
constexpr int kPatchSteps = 5;

// The end of an M tile: bias, ReLU, bf16 and the zero mask outside the
// image from the accumulators into the output region, or for the last
// layer (pooled in registers where it pools) into the staging region.
// Register 4 jj + 2 h + e holds row g + 8 h (tracked by rg[h]), channel
// ch0 + 8 jj + 2 q + e; bias[jj] is that channel pair's. Branch-free, so
// that the warp stays converged for the next tile's wgmma: a row past the
// region, or a pooled value a lane does not own, goes to the spare pixel
// after the region (`trash`).
template <int NC>
__device__ __forceinline__ void epilogue(const Walk& k, bf16* out, int ch0,
                                         const float2 (&bias)[NC / 8],
                                         const RowPix (&rg)[2],
                                         const float (&d)[NC / 2]) {
  const int g = (threadIdx.x & 31) >> 2;
  int pr, pc;
  if (k.last && k.pool) {
    // rows g and g + 8 are one column of two image rows, lane ^ 4 the
    // next column: max first (it commutes with the bias, ReLU and bf16)
    const bool valid = row_at(k, rg[0], g, &pr, &pc);
    const int pix = valid && (g & 1) == 0
                        ? (pr / 2) * (k.tw / 2) + pc / 2
                        : k.trash;
    bf16* dst = out + pix * k.out_ps;
#pragma unroll
    for (int jj = 0; jj < NC / 8; ++jj) {
      float v0 = fmaxf(d[4 * jj], d[4 * jj + 2]);
      float v1 = fmaxf(d[4 * jj + 1], d[4 * jj + 3]);
      v0 = fmaxf(v0, __shfl_xor_sync(0xffffffffu, v0, 4));
      v1 = fmaxf(v1, __shfl_xor_sync(0xffffffffu, v1, 4));
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * jj) =
          __floats2bfloat162_rn(fmaxf(v0 + bias[jj].x, 0.f),
                                fmaxf(v1 + bias[jj].y, 0.f));
    }
    return;
  }
  const bool pad_next = !k.last && ch0 + NC == k.n && k.n % 16 == 8;
  const __nv_bfloat162 zero = __floats2bfloat162_rn(0.f, 0.f);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool valid = row_at(k, rg[h], g + 8 * h, &pr, &pc);
    // zero outside the image: the next layer's SAME border
    const int y = k.y0 - k.halo + pr, x = k.x0 - k.halo + pc;
    const bool inside =
        k.last || (y >= 0 && y < k.height && x >= 0 && x < k.width);
    bf16* dst = out + (valid ? pr * k.cols + pc : k.trash) * k.out_ps;
#pragma unroll
    for (int jj = 0; jj < NC / 8; ++jj)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * jj) =
          inside ? __floats2bfloat162_rn(
                       fmaxf(d[4 * jj + 2 * h] + bias[jj].x, 0.f),
                       fmaxf(d[4 * jj + 2 * h + 1] + bias[jj].y, 0.f))
                 : zero;
    // channels n .. n + 7 when n % 16 == 8: the next layer's K padding
    if (pad_next) *reinterpret_cast<__nv_bfloat162*>(dst + NC) = zero;
  }
}

// Output channels ch0 .. ch0 + NC of layer k.j for every M tile of the
// walk, the warpgroups taking turns; the chunk's weights are at `wsm`.
//
// A k16 step reads B at wsm + s * 2 * NC * 16 bytes, s = the patch layer's
// step (< ksteps), or 9 kk + (3 dy + dx) for 16-channel slice kk. The A
// fragments of a batch of steps go into registers first (the patch layer's
// <= 5 steps; one kk over the 9 taps otherwise), then one wgmma.fence and
// the batch's wgmmas back to back. Two register batches alternate, so that
// batch kk + 1's ldmatrix runs under batch kk's products.
//
// kSliced (a layer whose K x nc chunk does not fit beside the tile): `wsm`
// is a slot that holds k.ks slices at a time, copied from the chunk at
// `wsrc` for each M tile (every warpgroup walks as many M tiles, the extra
// ones all padding rows, so that all reach each refill's __syncthreads).
template <int NC, bool kSliced>
__device__ __forceinline__ void run_chunk(unsigned char* smem, const Walk& k,
                                          int ch0, uint32_t wsm,
                                          const unsigned char* wsrc,
                                          int* loads) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, q = lane & 3;
  const uint64_t b_desc = desc(wsm, NC * 16, 128);
  bf16* out = reinterpret_cast<bf16*>(smem + k.out_off) + ch0 + 2 * q;
  // this thread's bias pairs: channels ch0 + 8 jj + 2 q, + 1
  float2 bias[NC / 8];
  {
#pragma unroll
    for (int jj = 0; jj < NC / 8; ++jj)
      bias[jj] = __ldg(reinterpret_cast<const float2*>(k.bias + ch0 + 8 * jj +
                                                       2 * q));
  }
  // the M tiles' loop bound is uniform in a warpgroup; read through a
  // shuffle, ptxas knows it (a divergent wgmma path would be serialized)
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  RowPix rg[2] = {row_start(k, wg, warp, g), row_start(k, wg, warp, g + 8)};
  float d[NC / 2];
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) d[i] = 0.f;
  int pr, pc;

  if (k.patch) {
    // A rows g and g + 8 read the dense box through the patch offsets of
    // entries 16 s + 2 q + {0, 1, 8, 9}
    const unsigned short* in16 =
        reinterpret_cast<const unsigned short*>(smem + k.in_off);
    const int* poff = reinterpret_cast<const int*>(smem + k.patch_off);
    int po[kPatchSteps][4];
#pragma unroll
    for (int s = 0; s < kPatchSteps; ++s)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        po[s][e] = s < k.ksteps
                       ? poff[16 * s + 2 * q + (e & 1) + 8 * (e >> 1)]
                       : 0;
    uint32_t af[kPatchSteps][4];
    EKP_PROBE_MT_DECL
    for (int mt = wg; mt < k.mtiles; mt += kGroups) {
      EKP_PROBE_MT_START
      row_at(k, rg[0], g, &pr, &pc);
      const int bg = pr * k.in_pitch + pc * k.ci;
      row_at(k, rg[1], g + 8, &pr, &pc);
      const int bg8 = pr * k.in_pitch + pc * k.ci;
      EKP_PROBE_MT(0)
#pragma unroll
      for (int s = 0; s < kPatchSteps; ++s) {
        if (s < k.ksteps) {
          af[s][0] = pack2(in16[bg + po[s][0]], in16[bg + po[s][1]]);
          af[s][1] = pack2(in16[bg8 + po[s][0]], in16[bg8 + po[s][1]]);
          af[s][2] = pack2(in16[bg + po[s][2]], in16[bg + po[s][3]]);
          af[s][3] = pack2(in16[bg8 + po[s][2]], in16[bg8 + po[s][3]]);
        }
      }
      fence_acc(d);
      EKP_PROBE_MT(1)
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < kPatchSteps; ++s)
        if (s < k.ksteps)
          Wgmma<NC>::mma(d, af[s],
                         b_desc + static_cast<uint64_t>(s * NC * 2), s);
      wgmma_commit();
      EKP_PROBE_MT(2)
      wgmma_wait<0>();
      fence_acc(d);
      EKP_PROBE_MT(3)
      epilogue<NC>(k, out, ch0, bias, rg, d);
      row_next(k, rg[0]);
      row_next(k, rg[1]);
      EKP_PROBE_MT(4)
    }
    EKP_PROBE_MT_FLUSH
    return;
  }

  // ldmatrix row lane % 16 at k offset 8 (lane / 16); tap (dy, dx) adds
  // dy rows and dx pixels, kk adds 32 bytes
  const uint32_t pix_b = k.in_ps * 2, row_b = k.in_cols * pix_b;
  RowPix ra = row_start(k, wg, warp, lane & 15);
  uint32_t af[2][9][4];
  const int mt_end =
      kSliced ? (k.mtiles + kGroups - 1) / kGroups * kGroups : k.mtiles;
  EKP_PROBE_MT_DECL
  for (int mt = wg; mt < mt_end; mt += kGroups) {
    EKP_PROBE_MT_START
    row_at(k, ra, lane & 15, &pr, &pc);
    const uint32_t base = smem_u32(smem + k.in_off) +
                          (pr * k.in_cols + pc) * pix_b + (lane >> 4) * 16;
    EKP_PROBE_MT(0)
    auto load = [&](uint32_t(&r)[9][4], int kk) {
#pragma unroll
      for (int t = 0; t < 9; ++t)
        ldmatrix_x4(r[t], base + (t / 3) * row_b + (t % 3) * pix_b + kk * 32);
    };
    // slice kk's B from wsm, which holds slices kb on
    auto issue = [&](uint32_t(&r)[9][4], int kk, int kb) {
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < 9; ++t)
        Wgmma<NC>::mma(
            d, r[t],
            b_desc + static_cast<uint64_t>((9 * (kk - kb) + t) * NC * 2),
            kk > 0 || t > 0);
      wgmma_commit();
    };
    // slices k0 .. k1 - 1
    auto steps = [&](int k0, int k1, int kb) {
      load(af[0], k0);
      fence_acc(d);
      EKP_PROBE_MT(1)
      for (int kk = k0; kk < k1; kk += 2) {
        issue(af[0], kk, kb);
        if (kk + 1 < k1) {
          wgmma_wait<1>();           // batch kk - 1, af[1]'s reader, is done
          load(af[1], kk + 1);
          issue(af[1], kk + 1, kb);
        }
        if (kk + 2 < k1) {
          wgmma_wait<1>();           // batch kk, af[0]'s reader, is done
          load(af[0], kk + 2);
        }
      }
    };
    if (kSliced) {
      const uint32_t bar_w = smem_u32(smem) + 16;
      for (int k0 = 0; k0 < k.kc; k0 += k.ks) {
        const int k1 = min(k.kc, k0 + k.ks);
        const uint32_t bytes = (k1 - k0) * 9 * 16 * NC * 2;
        __syncthreads();             // the slot's last readers are done
        if (threadIdx.x == 0) {
          fence_proxy_async();
          mbar_expect_tx(bar_w, bytes);
          bulk_copy(wsm, wsrc + k0 * 9 * 16 * NC * 2, bytes, bar_w);
        }
        mbar_wait(bar_w, *loads & 1);
        ++*loads;
        steps(k0, k1, k0);
        wgmma_wait<0>();
      }
    } else {
      steps(0, k.kc, 0);
    }
    EKP_PROBE_MT(2)
    wgmma_wait<0>();
    fence_acc(d);
    EKP_PROBE_MT(3)
    epilogue<NC>(k, out, ch0, bias, rg, d);
    row_next(k, ra);
    row_next(k, rg[0]);
    row_next(k, rg[1]);
    EKP_PROBE_MT(4)
  }
  EKP_PROBE_MT_FLUSH
}

// Layer k.j over its walk, chunk by chunk; a chain whose weights are not
// resident streams each chunk into the one slot first, or under kSliced
// lets run_chunk stream its K slices (`loads` counts the slot's copies: the
// barrier's phase).
template <int NC, bool kSliced>
__device__ __forceinline__ void run_layer(const Args& a, unsigned char* smem,
                                          const Walk& k, int* loads) {
  const Plan& p = a.p;
  const Layer& L = p.layer[k.j];
  const int chunk_bytes = L.ksteps * 16 * NC * 2;
  const uint32_t bar_w = smem_u32(smem) + 16;
  for (int c = 0; c * NC < L.n; ++c) {
    uint32_t wsm = smem_u32(smem + p.off_w);
    const unsigned char* wsrc =
        reinterpret_cast<const unsigned char*>(a.w) + L.w_off + c * chunk_bytes;
    if (p.resident) {
      wsm += L.w_off + c * chunk_bytes;
    } else if (!kSliced || k.patch) {
      __syncthreads();                 // the slot's last readers are done
      if (threadIdx.x == 0) {
        fence_proxy_async();
        mbar_expect_tx(bar_w, chunk_bytes);
        bulk_copy(wsm, wsrc, chunk_bytes, bar_w);
      }
      mbar_wait(bar_w, *loads & 1);
      ++*loads;
    }
    run_chunk<NC, kSliced>(smem, k, c * NC, wsm, wsrc, loads);
  }
  __syncthreads();
}

// The last layer's staging region -> the output, 16 bytes a thread where
// co % 8 == 0, masked at the ragged edge.
__device__ __forceinline__ void store_tile(const Args& a,
                                           const unsigned char* smem, int b,
                                           int y0, int x0) {
  const Plan& p = a.p;
  const Layer& L = p.layer[p.n_layers - 1];
  const int co = L.co, ps = L.n + 8, f = p.pool ? 2 : 1;
  const int th = p.th / f, tw = p.tw / f, oh = p.height / f,
            ow = p.width / f, oy0 = y0 / f, ox0 = x0 / f;
  const bf16* stg = reinterpret_cast<const bf16*>(
      smem + (p.n_layers % 2 ? p.off_buf1 : p.off_buf0));
  bf16* out = a.out + (size_t)b * oh * ow * co;
  if (co % 8 == 0) {
    const int vecs = co / 8;
    for (int i = threadIdx.x; i < th * tw * vecs; i += kThreads) {
      const int pix = i / vecs, v = i % vecs;
      const int y = oy0 + pix / tw, x = ox0 + pix % tw;
      if (y < oh && x < ow)
        *reinterpret_cast<uint4*>(out + ((size_t)y * ow + x) * co + 8 * v) =
            *reinterpret_cast<const uint4*>(stg + pix * ps + 8 * v);
    }
    return;
  }
  for (int i = threadIdx.x; i < th * tw * co; i += kThreads) {
    const int pix = i / co, ch = i % co;
    const int y = oy0 + pix / tw, x = ox0 + pix % tw;
    if (y < oh && x < ow) out[((size_t)y * ow + x) * co + ch] = stg[pix * ps + ch];
  }
}

// One kernel per chunk width: ptxas keeps a batch of wgmmas in flight only
// when one accumulator shape is live in the function (with several it
// serializes every wgmma for want of registers). kSliced: the chains whose
// weights fit only K slice by K slice (at NC = 8).
template <int NC, bool kSliced>
__global__ void __launch_bounds__(kThreads, 1)
    conv_chain_kernel(const __grid_constant__ Args a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((128u - (smem_u32(smem_raw) & 127u)) & 127u);
  const Plan& p = a.p;
  const int tid = threadIdx.x, n = p.n_layers;
  const int tiles = p.batch * p.tiles_y * p.tiles_x;
  const uint32_t bars = smem_u32(smem);  // input buffers 0 and 1, weights
  const Layer& first = p.layer[0];

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bars + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (p.patch) {
    // patch entry e = (3 dy + dx) ci + c lies e / 3ci rows and e % 3ci
    // elements from its pixel's first box element (box_shift into a row);
    // e >= 9 ci meets a zero weight and reads entry 9 ci - 1 (any finite
    // value would do)
    int* poff = reinterpret_cast<int*>(smem + p.off_patch);
    const int row = 3 * first.ci;
    for (int e = tid; e < 16 * first.ksteps; e += kThreads) {
      const int f = min(e, 9 * first.ci - 1);
      poff[e] = f / row * p.in_pitch + f % row + p.box_shift;
    }
  }
  __syncthreads();
  if (tid == 0) {
    if (p.resident) {
      mbar_expect_tx(bars + 16, p.w_bytes);
      bulk_copy(smem_u32(smem + p.off_w), a.w, p.w_bytes, bars + 16);
    }
    if (p.tma) issue_box(a, smem, blockIdx.x, 0);
  }
  unsigned short pre[kPre];
  if (!p.tma) store_box(a, smem, blockIdx.x, 0, pre, false);
  if (p.resident) mbar_wait(bars + 16, 0);
  __syncthreads();

  int loads = 0;
  int it = 0;
  EKP_PROBE_START
  // A patch layer reads its box, so the next box goes to the other of two
  // buffers as the tile starts; any other first layer's box is repacked
  // first (or, through registers, stored repacked), and the next one comes
  // into the one buffer once the repack is done.
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++it) {
    const int buf = p.patch ? it & 1 : 0, next = t + gridDim.x;
    int b, y0, x0;
    tile_origin(p, t, &b, &y0, &x0);
    EKP_PROBE_TILE
    if (p.tma) {
      mbar_wait(bars + 8 * buf, p.patch ? (it >> 1) & 1 : it & 1);
      if (p.patch && tid == 0 && next < tiles) {
        fence_proxy_async();   // the buffer's generic reads are done
        issue_box(a, smem, next, buf ^ 1);
      }
    } else if (next < tiles) {
      prefetch_box(a, next, pre);
    }
    EKP_PROBE(kProbeWait)
    const int in_off = buf ? p.off_in1 : p.off_in0;
    if (!p.patch && p.tma) {
      repack_box(p, smem, in_off);
      __syncthreads();
      if (tid == 0 && next < tiles) {
        fence_proxy_async();
        issue_box(a, smem, next, 0);
      }
    }
    EKP_PROBE(kProbeRepack)
    for (int j = 0; j < n; ++j) {
      const Layer& L = p.layer[j];
      Walk k;
      k.j = j;
      k.last = j == n - 1;
      k.patch = j == 0 && p.patch;
      k.pool = p.pool;
      k.th = p.th;
      k.tw = p.tw;
      k.height = p.height;
      k.width = p.width;
      k.in_pitch = p.in_pitch;
      k.ci = L.ci;
      k.n = L.n;
      k.ksteps = L.ksteps;
      k.ks = L.ks;
      k.bias = a.bias + L.b_off;
      k.patch_off = p.off_patch;
      k.halo = n - 1 - j;
      k.rows = p.th + 2 * k.halo;
      k.cols = p.tw + 2 * k.halo;
      // a tracked row moves kGroups M tiles at a time (see RowPix)
      k.span = k.last ? (p.tw + 7) / 8 : k.cols;
      k.step_q = (k.last ? 4 * kGroups : 64 * kGroups) / k.span;
      k.step_r = (k.last ? 4 * kGroups : 64 * kGroups) % k.span;
      k.mtiles = k.last ? ((p.th / 2) * k.span + 3) / 4
                        : (k.rows * k.cols + 63) / 64;
      // layer j reads buffer j % 2 (the patch layer: the box) and writes
      // buffer (j + 1) % 2
      k.in_off = k.patch ? in_off : (j % 2 ? p.off_buf1 : p.off_buf0);
      k.in_cols = k.cols + 2;
      k.in_ps = pad16(j > 0 ? p.layer[j - 1].n : L.ci) + 8;
      k.kc = pad16(L.ci) / 16;
      k.out_off = (j + 1) % 2 ? p.off_buf1 : p.off_buf0;
      k.out_ps = k.last ? L.n + 8 : pad16(L.n) + 8;
      k.trash = k.last && k.pool ? k.th * k.tw / 4 : k.rows * k.cols;
      k.y0 = y0;
      k.x0 = x0;
      run_layer<NC, kSliced>(a, smem, k, &loads);
      EKP_PROBE(kProbeLayer + j)
    }
    store_tile(a, smem, b, y0, x0);
    if (!p.tma && next < tiles) {
      if (!p.patch) __syncthreads();  // buffer 0 may be the staging read
      store_box(a, smem, next, buf ^ 1, pre, true);
    }
    __syncthreads();
    EKP_PROBE(kProbeStore)
  }
  EKP_PROBE_END
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

}  // namespace

#ifdef EKP_CHAIN_PROBE
// The probes of the last launch: `blocks` x kProbes cycles (int64) to dst.
extern "C" int ekp_conv_chain_probe(void* dst, int blocks) {
  return static_cast<int>(cudaMemcpyFromSymbol(
      dst, ekp_chain_probe, sizeof(long long) * kProbes * blocks));
}

// The M-tile probes summed since the last call (which zeroes them):
// `blocks` x kMaxLayers x kMtProbes cycles (int64) to dst.
extern "C" int ekp_conv_chain_probe_mt(void* dst, int blocks) {
  cudaError_t err = cudaMemcpyFromSymbol(
      dst, ekp_chain_probe_mt,
      sizeof(long long) * kMaxLayers * kMtProbes * blocks);
  static const long long zeros[1024 * kMaxLayers * kMtProbes] = {};
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(ekp_chain_probe_mt, zeros, sizeof(zeros));
  return static_cast<int>(err);
}
#endif

// x [batch, h, w, ci] bf16 NHWC; out [batch, h, w, co] or, pooled,
// [batch, h/2, w/2, co]; w every layer's packed weights and bias every
// layer's padded bias (ops/conv_chain.py::pack_chain); plan the kPlanInts
// ints of ops/conv_chain.py::fused_plan. Launches min(tiles, SMs) CTAs.
extern "C" int ekp_conv_chain(const void* x, void* out, const void* w,
                              const void* bias, const int* plan,
                              int plan_ints, void* stream) {
  if (plan_ints != kPlanInts || !x || !out || !w || !bias)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = {};
  a.x = static_cast<const bf16*>(x);
  a.out = static_cast<bf16*>(out);
  a.w = static_cast<const bf16*>(w);
  a.bias = static_cast<const float*>(bias);
  Plan& p = a.p;
  for (int i = 0; i < kPlanInts; ++i) reinterpret_cast<int*>(&p)[i] = plan[i];
  if (p.n_layers < 1 || p.n_layers > kMaxLayers || p.batch < 1 ||
      p.th % 2 || p.tw % 2 || p.smem > 232448 ||
      reinterpret_cast<uintptr_t>(w) % 16 || reinterpret_cast<uintptr_t>(out) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.tma) {
    // 3: [B, H, W * C], a box of in_pitch elements x box_rows rows; 4 (C a
    // multiple of 8): [B, H, W, C], a box of C x box_cols x box_rows. Both
    // land as box_rows rows of in_pitch elements.
    const EncodeTiled fn = encode_tiled();
    if (!fn) return static_cast<int>(cudaErrorNotSupported);
    const cuuint64_t c = p.layer[0].ci, w = p.width, h = p.height;
    const cuuint64_t dims3[3] = {w * c, h, (cuuint64_t)p.batch};
    const cuuint64_t dims4[4] = {c, w, h, (cuuint64_t)p.batch};
    const cuuint64_t strides[3] = {c * 2, w * c * 2, h * w * c * 2};
    const cuuint32_t box3[3] = {(cuuint32_t)p.in_pitch,
                                (cuuint32_t)p.box_rows, 1};
    const cuuint32_t box4[4] = {(cuuint32_t)c, (cuuint32_t)p.box_cols,
                                (cuuint32_t)p.box_rows, 1};
    const cuuint32_t ones[4] = {1, 1, 1, 1};
    const bool four = p.tma == 4;
    if (fn(&a.map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, four ? 4 : 3,
           const_cast<void*>(x), four ? dims4 : dims3,
           four ? strides : strides + 1, four ? box4 : box3, ones,
           CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
           CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
           CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nc = p.layer[0].nc;
  const auto kernel = p.sliced   ? conv_chain_kernel<8, true>
                      : nc == 8  ? conv_chain_kernel<8, false>
                      : nc == 16 ? conv_chain_kernel<16, false>
                      : nc == 24 ? conv_chain_kernel<24, false>
                                 : conv_chain_kernel<32, false>;
  if (nc % 8 || nc < 8 || nc > 32 || (p.sliced && (nc != 8 || p.resident)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long tiles = (long)p.batch * p.tiles_y * p.tiles_x;
  const long grid = tiles < sms ? tiles : sms;
  kernel<<<static_cast<unsigned>(grid), kThreads, p.smem,
           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
