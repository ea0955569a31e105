// SAME 3x3 stride-1 convolution + bias + activation, for Hopper (sm_90a).
//
// Two kernels, one function in two layouts. They replace the three Pallas TPU
// study kernels of sequitr_tpu/studies:
//   conv3x3_nhwc_kernel      <- pallas_conv2d.py::_kernel      (conv3x3_bias_act)
//   conv3x3_flat_chw_kernel  <- pallas_conv2d_gemm.py::_kernel  (conv3x3_gemm)
//                            <- pallas_conv2d_gemm2.py::_kernel (conv3x3_gemm2)
// The two TPU GEMM kernels differ only in the row stride of the flat layout
// (W+8 against a multiple of 128, which aligned every tap to the TPU's 128
// lanes). On this card the stride is an argument and nothing else changes, so
// one kernel serves both.
//
// Bound: at the thin widths the studies look at (32 -> 32 channels, bf16,
// 1024x1024) the function moves 2 x 64 MiB and does 19.3 GFLOP: 0.040 ms of
// device memory against 0.020 ms of bf16 tensor-core time on an H100 SXM, so
// its floor is bytes (chip_smoke.py times a device-to-device copy of as many
// bytes beside the kernel: what the card's memory gives a mixed stream of
// reads and writes). Three more things sat in the way before this design:
//   * every mma operand is read from shared memory (4.7 M mma.sync.m16n8k16:
//     two 128-byte wavefronts per mma cost as long as the device memory does);
//   * loads and stores to device memory issued by the warps that multiply:
//     under load each such instruction waits in the load-store unit's queue
//     for device memory, and with it the warp's ldmatrix and mma behind it;
//   * mma.sync itself stays below the data sheet's rate, which only wgmma
//     reaches (studies/conv3x3_parts.py measures it: csrc/mma_rate.cu); it
//     still hides behind the memory once the other two are out of the way.
// studies/conv3x3_parts.py shows what is left: it compiles the products, the
// stores or the transposition out of this file (the CONV3X3_WITHOUT_*
// switches below) and times the rest.
//
// Each kernel has three bodies, chosen by the launcher from what it can see
// in its arguments (seq_conv3x3_body reports the choice without launching):
//   2 tensor cores, pipelined: bf16 input, C_in a multiple of 16, the weights
//     of one block of 32 output channels and two tiles fitting shared memory,
//     and every 16-byte piece it would copy aligned: the base of x (NHWC),
//     or the base of x, the row stride and the margin being multiples of 8
//     elements (flat). Its tiles come by TMA where C_in is 16, 32 or 64 (the
//     row lengths TMA can swizzle), else by cp.async.
//   1 tensor cores, synchronous staging (flat layout only): the same product
//     where the stride, the margin or a base is not 16-byte aligned (odd
//     widths); tiles are gathered through registers in 2-byte pieces.
//   0 CUDA cores, f32 multiply-add (simt_body): anything else (f32 input,
//     which must multiply in f32; C_in = 1 or 3). At 67 TFLOP/s peak that
//     body is bound by its own arithmetic, 0.29 ms for the work above.
//
// The tensor-core design:
//   * A block of 4 warps owns an 8 x 32 tile of output pixels and 32 output
//     channels, and walks tiles blockIdx.x, + gridDim.x, ... (a persistent
//     grid of as many blocks as the card holds at once), so the whole
//     contraction's weights are staged once, as wt[co][k] with k = tap*C_in +
//     ci contiguous. No im2col matrix is made: the nine taps are nine offsets
//     into the halo'd tile (10 x 34 pixels), held pixel-major with channels
//     contiguous, xs[pixel][ci].
//   * A ring of tiles in shared memory, filled by the copy engine (TMA): one
//     thread asks for a whole halo'd tile with one cp.async.bulk.tensor (x
//     as a tensor (C, W, H), box C_in x 34 x 10; what lies outside the image
//     arrives as zeros, so no padded copy of the input exists), while the
//     block multiplies the tiles that have landed. An mbarrier a stage says
//     when its bytes are there (full), another when the four warps have let
//     go of it (empty); no barrier of the whole block is left in the NHWC
//     loop. The tile lies dense and swizzled (TMA's 32-, 64- or 128-byte
//     swizzle for 16, 32 or 64 channels): the 16-byte chunks of a pixel are
//     exchanged by the pixel's index, which keeps the 8 rows of an ldmatrix
//     block in 8 distinct groups of 4 banks without padding. Stages: 2 or
//     3; a third is taken when it costs no resident block. At C_in = 32 a
//     block holds 18.9 KB of weights, 8 KB of epilogue rows and 22 KB a
//     stage: 2 stages, 3 blocks an SM (12 warps; a third stage would cost
//     the third block). At C_in = 64 (37.4 + 43.5 a stage) one block fits
//     either way and gets 3 stages. Tile height 8: a 16-row tile would cut
//     the halo from 1.33x to 1.19x of the tile's bytes (read from L2, not
//     from device memory) but halve the blocks an SM.
//   * Where C_in has no swizzle (48, 80, ...) the ring is filled by 16-byte
//     cp.async from all four warps into rows padded by 8 bf16 (the row stride
//     an odd multiple of 16 bytes, which spreads the banks the same way), the
//     zero-fill form for the image border, cp.async.wait_group and one
//     barrier a tile handing a stage over.
//   * Fewer shared-memory bytes per mma (mma_tile): a warp owns two tile rows
//     by 32 pixels by 32 channels (64 f32 accumulators a thread). For one dx
//     and one 16-channel step it loads the weight fragments of the three dy
//     once (6 ldmatrix.x4) and each of its 4 input rows once (2 ldmatrix.x4
//     a row); a weight fragment then serves 4 pixel fragments and an input
//     row's fragment every dy it is a tap of: 14 ldmatrix.x4 (56 wavefronts)
//     for 48 mma, 1.17 a mma where one row a warp needed 2. The fragments
//     are fetched one group of mma ahead by hand.
//   * Epilogue: a warp adds the f32 bias, applies the activation, rounds once
//     to the output type and places one output row in its own 2 KB of shared
//     memory (stmatrix for bf16; for the flat layout stmatrix.trans, which
//     lands it channel-major), then one lane sends it off as one TMA store
//     of a 32 x 32 box (y as (C, W, H), or (column, row, C) for the flat
//     layout), which clips what lies outside y and is waited for only when
//     the buffer is needed again. Where y's rows do not start on 16-byte
//     boundaries or the output is f32, the lanes write whole channel runs
//     (NHWC: 64 bytes a pixel) or plane-row runs (flat: 64 bytes a channel)
//     as 16-byte vectors, or single values where even those are unaligned.
//   * Flat layout: the transposition on the chip. TMA brings, for each halo
//     row and channel, the 48-element window that starts 8 columns left of
//     the tile (x as a tensor (column, C, row), box 48 x C_in x 10) into a
//     raw stage raw[row][ci][48]. Then 8x8 blocks are transposed inside
//     shared memory, ldmatrix.trans on 8 channels x 8 pixels and stmatrix to
//     xs[pixel][ci], and the product runs from the same xs with the same
//     mma_tile as the NHWC kernel. The ring is the raw stages plus xs. The
//     shortcut, feeding the channel-major stage to the tensor cores with
//     ldmatrix.trans per tap, fails on alignment: ldmatrix wants 16-byte-
//     aligned 8-pixel runs, which the dx = +-1 taps do not have. The
//     pad-column mask (1 <= c <= W) is applied to the accumulators before
//     they are placed. What is left between this kernel and the NHWC one is
//     device memory's: its boxes are 320 pieces of 96 bytes and its stores 32
//     pieces of 64 bytes where NHWC moves runs of 2 KB.
//   * simt_body keeps the tile as f32 channel planes and walks the input
//     channels in chunks of at most 32. A thread owns 4 rows x 1 column x 8
//     channels (32 accumulators). For one input channel and one dx it loads
//     the 6 rows its 4 outputs touch once and uses them for all three dy. A
//     warp spans the 32 columns of a tile row, so its plane reads are
//     consecutive words and its weight reads are one broadcast address.
//   * The flat kernel keeps the layout contract of the TPU kernels: input
//     (C_in, margin + (H+16)*Wb) with a zero ring, output (C_out, H*Wb) whose
//     columns 0 and > W are written as zero so that the output can be re-padded
//     for a following layer. Taps are flat shifts dy*Wb + dx; column 0 of a row
//     reads the last element of the row before it (or, by TMA, a zero), which
//     only the zero ring and the output mask make harmless.
//   * Operands multiply into f32; the f32 accumulator gets the f32 bias and
//     the activation and is rounded once, to the output type.
//   * Index arithmetic that multiplies three sizes is 64-bit.

#include <cuda.h>  // CUtensorMap and its enums: types only, libcuda is reached through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TW = 32;              // tile width: a warp spans one tile row
constexpr int ROWS = 4;             // output rows per thread
constexpr int RG = 2;               // row groups per tile
constexpr int TH = ROWS * RG;       // tile height
constexpr int CO_T = 8;             // output channels per thread
constexpr int CG = 4;               // channel groups per block
constexpr int CO_B = CO_T * CG;     // output channels per block
constexpr int THREADS = TW * RG * CG;
constexpr int PITCH = TW + 2;       // halo'd tile row
// words per channel plane; odd, so that staging consecutive channels of one
// pixel (the NHWC order in device memory) hits distinct banks
constexpr int PLANE = (TH + 2) * PITCH + 1;
constexpr int CI_MAX = 32;          // input channels per chunk

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// ws[(tap*cb + ci)*CO_B + co] = w[(tap*c_in + c0 + ci), co0 + co], zero past c_out.
// w is the HWIO kernel viewed as (9*c_in, c_out): tap-major, dy outer.
template <typename TI>
__device__ __forceinline__ void stage_weights(float* ws, const TI* __restrict__ w,
                                              int c_in, int c_out, int c0,
                                              int cb, int co0) {
  const int n = 9 * cb * CO_B;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const int co = i % CO_B;
    const int k = i / CO_B;
    const int ci = k % cb;
    const int tap = k / cb;
    const int gco = co0 + co;
    float v = 0.0f;
    if (gco < c_out) {
      v = to_float(w[static_cast<long long>(tap * c_in + c0 + ci) * c_out + gco]);
    }
    ws[i] = v;
  }
}

// One chunk of input channels: acc[j][u] += sum over ci, dy, dx of
// plane[ci][row j + dy][col + dx] * ws[(dy*3+dx)*cb + ci][u].
// xt points at this thread's first halo row and column of plane 0.
__device__ __forceinline__ void compute_chunk(const float* xt, const float* wt,
                                              int cb, float (&acc)[ROWS][CO_T]) {
  for (int ci = 0; ci < cb; ++ci) {
    const float* xp = xt + ci * PLANE;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      float xv[ROWS + 2];
#pragma unroll
      for (int i = 0; i < ROWS + 2; ++i) xv[i] = xp[i * PITCH + dx];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const float4* wp = reinterpret_cast<const float4*>(
            wt + ((dy * 3 + dx) * cb + ci) * CO_B);
        const float4 w0 = wp[0];
        const float4 w1 = wp[1];
#pragma unroll
        for (int j = 0; j < ROWS; ++j) {
          const float xj = xv[j + dy];
          acc[j][0] = fmaf(xj, w0.x, acc[j][0]);
          acc[j][1] = fmaf(xj, w0.y, acc[j][1]);
          acc[j][2] = fmaf(xj, w0.z, acc[j][2]);
          acc[j][3] = fmaf(xj, w0.w, acc[j][3]);
          acc[j][4] = fmaf(xj, w1.x, acc[j][4]);
          acc[j][5] = fmaf(xj, w1.y, acc[j][5]);
          acc[j][6] = fmaf(xj, w1.z, acc[j][6]);
          acc[j][7] = fmaf(xj, w1.w, acc[j][7]);
        }
      }
    }
  }
}

struct ThreadTile {
  int lc;   // column in the tile
  int rg;   // row group
  int cg;   // channel group
};

__device__ __forceinline__ ThreadTile thread_tile() {
  ThreadTile t;
  t.lc = threadIdx.x % TW;
  t.rg = (threadIdx.x / TW) % RG;
  t.cg = threadIdx.x / (TW * RG);
  return t;
}

// ---------------------------------------------------------------------------
// CUDA-core bodies (f32 multiply-add)
// ---------------------------------------------------------------------------

// x: (H, W, c_in); w: (9*c_in, c_out); bias: (c_out,) f32; y: (H, W, c_out).
// One block per (tile column, tile row, block of CO_B output channels).
template <typename TI, typename TO>
__device__ __forceinline__ void nhwc_simt_body(
    float* smem, const TI* __restrict__ x, const TI* __restrict__ w,
    const float* __restrict__ bias, TO* __restrict__ y, int H, int W, int c_in,
    int c_out, int ci_blk, int relu) {
  float* ws = smem;                       // 9 * ci_blk * CO_B words
  float* xs = smem + 9 * ci_blk * CO_B;   // ci_blk * PLANE words

  const ThreadTile t = thread_tile();
  const int col0 = blockIdx.x * TW;
  const int row0 = blockIdx.y * TH;
  const int co0 = blockIdx.z * CO_B;

  float acc[ROWS][CO_T] = {};

  for (int c0 = 0; c0 < c_in; c0 += ci_blk) {
    const int cb = min(ci_blk, c_in - c0);
    __syncthreads();  // the previous chunk's reads are done
    stage_weights(ws, w, c_in, c_out, c0, cb, co0);
    const int n = (TH + 2) * PITCH * cb;
    for (int i = threadIdx.x; i < n; i += THREADS) {
      const int ci = i % cb;
      const int p = i / cb;
      const int tc = p % PITCH;
      const int tr = p / PITCH;
      const int r = row0 - 1 + tr;
      const int c = col0 - 1 + tc;
      float v = 0.0f;
      if (r >= 0 && r < H && c >= 0 && c < W) {
        v = to_float(x[(static_cast<long long>(r) * W + c) * c_in + c0 + ci]);
      }
      xs[ci * PLANE + tr * PITCH + tc] = v;
    }
    __syncthreads();
    compute_chunk(xs + (t.rg * ROWS) * PITCH + t.lc, ws + t.cg * CO_T, cb, acc);
  }

  const int c = col0 + t.lc;
  if (c >= W) return;
  const int cob = co0 + t.cg * CO_T;
#pragma unroll
  for (int j = 0; j < ROWS; ++j) {
    const int r = row0 + t.rg * ROWS + j;
    if (r >= H) break;
    TO* yp = y + (static_cast<long long>(r) * W + c) * c_out;
#pragma unroll
    for (int u = 0; u < CO_T; ++u) {
      const int co = cob + u;
      if (co < c_out) {
        float v = acc[j][u] + bias[co];
        if (relu) v = fmaxf(v, 0.0f);
        yp[co] = from_float<TO>(v);
      }
    }
  }
}

// x: (c_in, len), len = margin + (H+16)*wb, zero ring; w: (9*c_in, c_out);
// bias: (c_out,) f32; y: (c_out, H*wb). Output n = r*wb + c reads
// x[ci, margin + wb + n + dy*wb + dx]; columns 0 and > W are written as zero.
template <typename TI, typename TO>
__device__ __forceinline__ void flat_simt_body(
    float* smem, const TI* __restrict__ x, const TI* __restrict__ w,
    const float* __restrict__ bias, TO* __restrict__ y, int H, int W, int wb,
    int margin, long long len, int c_in, int c_out, int ci_blk, int relu) {
  float* ws = smem;
  float* xs = smem + 9 * ci_blk * CO_B;

  const ThreadTile t = thread_tile();
  const int col0 = blockIdx.x * TW;
  const int row0 = blockIdx.y * TH;
  const int co0 = blockIdx.z * CO_B;

  float acc[ROWS][CO_T] = {};

  for (int c0 = 0; c0 < c_in; c0 += ci_blk) {
    const int cb = min(ci_blk, c_in - c0);
    __syncthreads();
    stage_weights(ws, w, c_in, c_out, c0, cb, co0);
    const int n = cb * (TH + 2) * PITCH;
    for (int i = threadIdx.x; i < n; i += THREADS) {
      const int tc = i % PITCH;
      const int q = i / PITCH;
      const int tr = q % (TH + 2);
      const int ci = q / (TH + 2);
      // halo row tr of the tile is padded row row0 + tr: the dy = -1 tap of
      // output row row0, at flat offset margin + wb + (row0 - 1) * wb
      const long long idx = margin + static_cast<long long>(row0 + tr) * wb +
                            (col0 - 1 + tc);
      float v = 0.0f;
      if (idx >= 0 && idx < len) {
        v = to_float(x[static_cast<long long>(c0 + ci) * len + idx]);
      }
      xs[ci * PLANE + tr * PITCH + tc] = v;
    }
    __syncthreads();
    compute_chunk(xs + (t.rg * ROWS) * PITCH + t.lc, ws + t.cg * CO_T, cb, acc);
  }

  const int c = col0 + t.lc;
  if (c >= wb) return;
  const bool pixel = c >= 1 && c <= W;
  const int cob = co0 + t.cg * CO_T;
  const long long plane = static_cast<long long>(H) * wb;
#pragma unroll
  for (int j = 0; j < ROWS; ++j) {
    const int r = row0 + t.rg * ROWS + j;
    if (r >= H) break;
    const long long n = static_cast<long long>(r) * wb + c;
#pragma unroll
    for (int u = 0; u < CO_T; ++u) {
      const int co = cob + u;
      if (co < c_out) {
        float v = acc[j][u] + bias[co];
        if (relu) v = fmaxf(v, 0.0f);
        y[co * plane + n] = from_float<TO>(pixel ? v : 0.0f);
      }
    }
  }
}


// ---------------------------------------------------------------------------
// tensor-core bodies (bf16 operands, f32 accumulators)
// ---------------------------------------------------------------------------

constexpr int MMA_WARPS = 4;               // warps of a tensor-core block
constexpr int MMA_THREADS = 32 * MMA_WARPS;
constexpr int WR = TH / MMA_WARPS;         // tile rows per warp
constexpr int NPIX = (TH + 2) * PITCH;     // pixels of a halo'd tile
constexpr int KPAD = 8;                    // bf16 of padding per shared-memory row
constexpr int MF = TW / 16;                // 16-pixel fragments per tile row
constexpr int NF = CO_B / 8;               // 8-channel fragments per block
constexpr int OB_PITCH = TW + KPAD;        // elements per row of an epilogue buffer
constexpr int OB_ELEMS = TW * OB_PITCH;    // one output row: 32 x 32, padded
constexpr int WIN = TW + 16;               // flat layout: aligned window of a halo row
constexpr int DUMP_BYTES = 32 * 16;        // where stmatrix rows outside the tile go
constexpr int MAX_STAGES = 3;
constexpr int BARRIER_BYTES = 64;           // 2 * MAX_STAGES mbarriers, 16-byte aligned
constexpr int TMA_ALIGN = 1024;            // where a swizzled stage may start
static_assert(2 * MAX_STAGES * 8 <= BARRIER_BYTES, "the mbarriers fit their room");
static_assert(WR * MMA_WARPS == TH && TW == 32 && CO_B == 32 && NF % 2 == 0 && TW == CO_B,
              "a warp owns WR whole tile rows of 32 pixels by 32 channels");
static_assert(((TH + 2) * (WIN / 8)) % 4 == 0, "transpose_tile takes 8x8 blocks four at a time");

// --- PTX operations, each in a function of its own ---

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from device memory to shared memory, asynchronously; zeros when
// `valid` is false (src is then not read, but must be an address).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `pending` (0 or 1) of this thread's groups are in flight.
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending >= 1) {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  } else {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }
}

// An mbarrier: a phase completes when `count` arrivals have been made and
// all the bytes it was told to expect have landed.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the copy engine.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n"
      ".reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n"
      "}\n" ::"r"(smem_addr(bar))
      : "memory");
}

// One arrival that also tells the barrier to expect `bytes` of tensor copies.
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar, int bytes) {
  asm volatile(
      "{\n"
      ".reg .b64 state;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Has the phase of this parity (0 for the first) completed?
__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// The box of tensor map `map` at coordinates (c0, c1, c2), innermost first,
// from device memory to shared memory by the copy engine (TMA). What lies
// outside the tensor arrives as zeros; the bytes are counted off `bar`.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// The box of `map` at (c0, c1, c2) from shared memory to device memory by the
// copy engine; what lies outside the tensor is not written. Joins this
// thread's current group of bulk stores.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// All of this thread's bulk stores have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Orders this thread's writes to shared memory before the copy engine's reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Four 8x8 blocks of 16-bit values. Lanes 8i .. 8i+7 give the addresses of
// the 8 rows (16 bytes each) of block i; lane 4g + t receives (ldmatrix) or
// provides (stmatrix) in r[i] the pair [g][2t], [g][2t+1] of block i, or
// with .trans the pair [2t][g], [2t+1][g].
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

__device__ __forceinline__ void stmatrix_x4(void* row, const uint32_t (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   smem_addr(row)),
               "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}

__device__ __forceinline__ void stmatrix_x4_trans(void* row, const uint32_t (&r)[4]) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(
          smem_addr(row)),
      "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
      : "memory");
}

// D = A (16 x 16, row-major) * B (16 x 8, column-major) + D, bf16 into f32.
// Lane = 4*g + t holds A[g][2t..2t+1], A[g+8][2t..], A[g][2t+8..], A[g+8][2t+8..];
// B[2t..2t+1][g], B[2t+8..2t+9][g]; D[g][2t..2t+1], D[g+8][2t..2t+1].
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
#ifdef CONV3X3_WITHOUT_PRODUCTS  // studies/conv3x3_parts.py: the operands stay in use
  d[0] += __uint_as_float(a[0] ^ b[0]);
  return;
#endif
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// --- end of the PTX operations ---

__device__ __forceinline__ uint32_t pack_pair(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// Two f32 values rounded to bf16 (nearest even), lo in the low half.
__device__ __forceinline__ uint32_t round_pair(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return pack_pair(v.x, v.y);
}

// Where the 16-byte chunk `chunk` of row `row` lies (in elements) in a dense
// tile of rows of n = 16, 32 or 64 bf16 that TMA's 32-, 64- or 128-byte
// swizzle laid down, or will pick up, from a 1024-byte-aligned base: the
// chunk index is XORed with bits 7.. of the row's byte address, which keeps
// the chunks of 8 neighbouring rows in 8 distinct groups of 4 banks.
__device__ __forceinline__ int swizzled(int row, int chunk, int n) {
  const int shift = n >= 64 ? 0 : (n >= 32 ? 1 : 2);  // log2(128 / row bytes)
  return row * n + ((chunk ^ ((row >> shift) & (n / 8 - 1))) << 3);
}

// bf16 per shared-memory row: the padding makes the row stride an odd
// multiple of 16 bytes, so the 8 rows of an 8x8 block fall in 8 distinct
// groups of 4 banks.
__device__ __host__ __forceinline__ int pixel_stride(int c_in) { return c_in + KPAD; }
__device__ __host__ __forceinline__ int weight_stride(int c_in) { return 9 * c_in + KPAD; }
// flat layout: bf16 per channel of a raw stage, (TH+2) windows and 8 of padding
constexpr int RAW_STRIDE = (TH + 2) * WIN + KPAD;

// wt[co][k], k = tap*c_in + ci contiguous: the block's CO_B output channels
// of w (9*c_in, c_out), transposed, zero past c_out. Read 8 channels (16
// bytes) at a time where w's rows allow it: the loads of one thread do not
// depend on each other, so they are all in flight at once.
__device__ __forceinline__ void stage_weights_mma(__nv_bfloat16* wt,
                                                  const __nv_bfloat16* __restrict__ w,
                                                  int c_in, int c_out, int co0) {
  const int ws = weight_stride(c_in);
  const bool vectors = c_out % 8 == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  const int n = 9 * c_in * (CO_B / 8);
  for (int i = threadIdx.x; i < n; i += MMA_THREADS) {
    const int co = (i % (CO_B / 8)) * 8;
    const int k = i / (CO_B / 8);
    const __nv_bfloat16* src = w + static_cast<long long>(k) * c_out + co0 + co;
    __align__(16) __nv_bfloat16 v[8];
    if (vectors && co0 + co + 8 <= c_out) {
      *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(src);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[e] = co0 + co + e < c_out ? src[e] : __float2bfloat16_rn(0.0f);
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) wt[(co + e) * ws + k] = v[e];
  }
}

// This warp's WR tile rows times the block's CO_B channels, from the staged
// tile xs[pixel][ci] and the weights wt[co][k]. A step is one dx and 16 input
// channels: the weight fragments of the three dy, and each of the WR + 2 input
// rows once, multiplied into every output row it is a tap of. The PTX
// operations keep their program order, so the fragments are fetched one
// group of mma ahead by hand: input row ir + 1 (or row 0 of the next step)
// before the products of row ir, and the weights of dy into their registers
// as soon as the last row that uses them (ir = dy + WR - 1) is done.
//
// SWZ says how the tile lies in shared memory. false: rows of c_in + KPAD
// (padded, as the cp.async copies place it). true: dense rows of c_in = 16,
// 32 or 64 channels, swizzled as TMA lays them down (`swizzled`).
template <bool SWZ>
__device__ __forceinline__ void mma_tile(const __nv_bfloat16* xs, const __nv_bfloat16* wt,
                                         int c_in, int warp, int lane,
                                         float (&acc)[WR][MF][NF][4]) {
  static_assert(WR % 2 == 0, "the input rows of a step alternate between two buffers");
  const int ps = pixel_stride(c_in);
  const int ws = weight_stride(c_in);
  const int m = lane >> 3;
  const int row = lane & 7;
  // A blocks of an x4: (pixels 0-7, k 0-7), (pixels 8-15, k 0-7),
  // (pixels 0-7, k 8-15), (pixels 8-15, k 8-15): this lane's row of them, for
  // fragment 0 of input row 0 at dx = 0, and its 8-channel chunk of a step
  const int pixel0 = (WR * warp) * PITCH + (m & 1) * 8 + row;
  const int chunk0 = m >> 1;
  // B blocks of an x4: (co 0-7, k 0-7), (co 0-7, k 8-15), (co 8-15, k 0-7),
  // (co 8-15, k 8-15)
  const __nv_bfloat16* wk = wt + ((m >> 1) * 8 + row) * ws + (m & 1) * 8;
  uint32_t a[2][MF][4];
  uint32_t b[3][NF][2];
  // output (tile row o, column c) reads halo'd pixel (o + dy, c + dx)
  auto load_a = [&](uint32_t(&dst)[MF][4], int ir, int dx, int kc) {
#pragma unroll
    for (int mf = 0; mf < MF; ++mf) {
      const int pixel = pixel0 + ir * PITCH + mf * 16 + dx;
      const int chunk = chunk0 + 2 * kc;
      if constexpr (SWZ) {
        ldmatrix_x4(dst[mf], xs + swizzled(pixel, chunk, c_in));
      } else {
        ldmatrix_x4(dst[mf], xs + pixel * ps + chunk * 8);
      }
    }
  };
  auto load_b = [&](int dy, int dx, int kc) {
#pragma unroll
    for (int nfp = 0; nfp < NF / 2; ++nfp) {
      uint32_t q[4];
      ldmatrix_x4(q, wk + nfp * 16 * ws + (dy * 3 + dx) * c_in + kc * 16);
      b[dy][2 * nfp][0] = q[0];
      b[dy][2 * nfp][1] = q[1];
      b[dy][2 * nfp + 1][0] = q[2];
      b[dy][2 * nfp + 1][1] = q[3];
    }
  };
  // step s is dx = s % 3 and channels 16 * (s / 3) ..
  const int steps = 3 * (c_in / 16);
  int dx = 0, kc = 0;
  load_b(0, dx, kc);
  load_b(1, dx, kc);
  load_a(a[0], 0, dx, kc);
  for (int s = 0; s < steps; ++s) {
    const int dx1 = dx == 2 ? 0 : dx + 1;
    const int kc1 = dx == 2 ? kc + 1 : kc;
    const bool more = s + 1 < steps;
#pragma unroll
    for (int ir = 0; ir < WR + 2; ++ir) {
      if (ir == 0) load_b(2, dx, kc);
      if (ir >= WR && more) load_b(ir - WR, dx1, kc1);
      if (ir + 1 < WR + 2) {
        load_a(a[(ir + 1) & 1], ir + 1, dx, kc);
      } else if (more) {
        load_a(a[(ir + 1) & 1], 0, dx1, kc1);
      }
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const int o = ir - dy;
        if (o < 0 || o >= WR) continue;
#pragma unroll
        for (int mf = 0; mf < MF; ++mf)
#pragma unroll
          for (int nf = 0; nf < NF; ++nf) mma_bf16_16816(acc[o][mf][nf], a[ir & 1][mf], b[dy][nf]);
      }
    }
    dx = dx1;
    kc = kc1;
  }
}

// bv[nf][e] = bias of channel first + nf*8 + e: the channels of a thread's
// accumulator columns, zero past c_out.
__device__ __forceinline__ void thread_bias(float (&bv)[NF][2],
                                            const float* __restrict__ bias,
                                            int first, int c_out) {
#pragma unroll
  for (int nf = 0; nf < NF; ++nf)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int co = first + nf * 8 + e;
      bv[nf][e] = co < c_out ? bias[co] : 0.0f;
    }
}

// One output row of this warp (32 pixels x CO_B channels): bias, activation,
// the flat layout's column mask, one rounding to TO, into the warp's buffer
// ob: pixel-major ob[pixel][co] (NHWC) or channel-major ob[co][pixel] (FLAT),
// rows of OB_PITCH elements; or, `dense` (bf16 only, for a TMA store): rows of
// 32 elements, swizzled as TMA will pick them up (`swizzled`).
template <typename TO, bool FLAT>
__device__ __forceinline__ void place_row(TO* ob, const float (&acc)[MF][NF][4],
                                          const float (&bv)[NF][2], int relu, int lane,
                                          int col0, int W, bool dense) {
  const int g = lane >> 2;
  const int t = lane & 3;
  float v[MF][NF][4];
#pragma unroll
  for (int mf = 0; mf < MF; ++mf)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = col0 + mf * 16 + half * 8 + g;
      const bool keep = !FLAT || (c >= 1 && c <= W);
#pragma unroll
      for (int nf = 0; nf < NF; ++nf)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float s = acc[mf][nf][half * 2 + e] + bv[nf][e];
          if (relu) s = fmaxf(s, 0.0f);
          v[mf][nf][half * 2 + e] = keep ? s : 0.0f;
        }
    }
  if constexpr (sizeof(TO) == 2) {
    // x4 blocks: (pixels 0-7, co 0-7), (pixels 8-15, co 0-7), (pixels 0-7,
    // co 8-15), (pixels 8-15, co 8-15) of fragment mf, channel pair nfp
    const int m = lane >> 3;
    const int row = lane & 7;
#pragma unroll
    for (int mf = 0; mf < MF; ++mf)
#pragma unroll
      for (int nfp = 0; nfp < NF / 2; ++nfp) {
        uint32_t r[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int nf = 2 * nfp + (i >> 1);
          const int half = i & 1;
          r[i] = round_pair(v[mf][nf][half * 2], v[mf][nf][half * 2 + 1]);
        }
        const int pix = mf * 16 + (m & 1) * 8;
        const int co = (2 * nfp + (m >> 1)) * 8;
        // this lane's row of the buffer and the first element of its block there
        const int line = (FLAT ? co : pix) + row;
        const int first = FLAT ? pix : co;
        TO* dst = dense ? ob + swizzled(line, first >> 3, TW) : ob + line * OB_PITCH + first;
        if constexpr (FLAT) {
          stmatrix_x4_trans(dst, r);
        } else {
          stmatrix_x4(dst, r);
        }
      }
  } else {
#pragma unroll
    for (int mf = 0; mf < MF; ++mf)
#pragma unroll
      for (int nf = 0; nf < NF; ++nf)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int pix = mf * 16 + (i >> 1) * 8 + g;
          const int co = nf * 8 + 2 * t + (i & 1);
          ob[FLAT ? co * OB_PITCH + pix : pix * OB_PITCH + co] = v[mf][nf][i];
        }
  }
}

// The warp's buffer ob[pixel][co] to y (H, W, c_out), row r: 16-byte vectors
// of each pixel's channel run when `vectors` says they are aligned.
template <typename TO>
__device__ __forceinline__ void write_row_nhwc(TO* __restrict__ y, const TO* ob, int lane,
                                               int r, int col0, int W, int co0, int c_out,
                                               bool vectors) {
  constexpr int VEC = 16 / sizeof(TO);  // elements per vector
  constexpr int VPP = CO_B / VEC;       // vectors per pixel
  TO* yr = y + static_cast<long long>(r) * W * c_out;
  if (vectors) {
#pragma unroll
    for (int it = 0; it < VPP; ++it) {
      const int i = it * 32 + lane;
      const int pix = i / VPP;
      const int part = i % VPP;
      const int c = col0 + pix;
      const int co = co0 + part * VEC;
      if (c >= W || co >= c_out) continue;
      const TO* src = ob + pix * OB_PITCH + part * VEC;
      TO* dst = yr + static_cast<long long>(c) * c_out + co;
      if (co + VEC <= c_out) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int e = 0; co + e < c_out; ++e) dst[e] = src[e];
      }
    }
  } else {
    for (int i = lane; i < TW * CO_B; i += 32) {
      const int pix = i / CO_B;
      const int co = co0 + i % CO_B;
      const int c = col0 + pix;
      if (c < W && co < c_out) {
        yr[static_cast<long long>(c) * c_out + co] = ob[pix * OB_PITCH + i % CO_B];
      }
    }
  }
}

// The warp's buffer ob[co][pixel] to y (c_out, H*wb), row r: 16-byte vectors
// along each plane row when `vectors` says they are aligned (wb is then a
// multiple of 8, so a vector lies wholly inside the row or wholly outside).
template <typename TO>
__device__ __forceinline__ void write_row_flat(TO* __restrict__ y, const TO* ob, int lane,
                                               int r, int col0, int wb, long long plane,
                                               int co0, int c_out, bool vectors) {
  constexpr int VEC = 16 / sizeof(TO);
  constexpr int VPR = TW / VEC;  // vectors per channel row
  TO* yr = y + static_cast<long long>(r) * wb;
  if (vectors) {
#pragma unroll
    for (int it = 0; it < VPR; ++it) {
      const int i = it * 32 + lane;
      const int co = i / VPR;
      const int c = col0 + (i % VPR) * VEC;
      if (c < wb && co0 + co < c_out) {
        *reinterpret_cast<uint4*>(yr + (co0 + co) * plane + c) =
            *reinterpret_cast<const uint4*>(ob + co * OB_PITCH + (i % VPR) * VEC);
      }
    }
  } else {
    for (int i = lane; i < TW * CO_B; i += 32) {
      const int co = i / TW;
      const int c = col0 + i % TW;
      if (c < wb && co0 + co < c_out) {
        yr[(co0 + co) * plane + c] = ob[co * OB_PITCH + i % TW];
      }
    }
  }
}

// Where a tile lies in the image.
struct TileAt {
  int row0, col0;
};

__device__ __forceinline__ TileAt tile_at(int tile, int tiles_x) {
  const int ty = tile / tiles_x;
  return {ty * TH, (tile - ty * tiles_x) * TW};
}

// This warp's WR output rows of a tile, from the accumulators to y, one row
// at a time through the warp's buffer ob. y_map != nullptr (bf16 output): the
// row leaves as one TMA store of a 32 x 32 box (y as (C, W, H), or for the
// flat layout (column, row, C)), which clips what lies outside y and is not
// waited for until the buffer is needed again. Else 16-byte (`vectors`) or
// single stores by the lanes.
template <typename TO, bool FLAT>
__device__ __forceinline__ void store_tile(TO* __restrict__ y, const CUtensorMap* y_map, TO* ob,
                                           const float (&acc)[WR][MF][NF][4],
                                           const float (&bv)[NF][2], int relu, int warp,
                                           int lane, TileAt at, int H, int W, int wb,
                                           long long plane, int co0, int c_out,
                                           bool vectors) {
#pragma unroll
  for (int o = 0; o < WR; ++o) {
#ifdef CONV3X3_WITHOUT_STORES  // studies/conv3x3_parts.py: every row counts as outside
    const int r = H;
#else
    const int r = at.row0 + WR * warp + o;
#endif
    if (r >= H) continue;
    if (y_map != nullptr) {
      if (lane == 0) bulk_wait_read();  // the store before this one has read ob
      __syncwarp();
      place_row<TO, FLAT>(ob, acc[o], bv, relu, lane, at.col0, W, true);
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) {
        if constexpr (FLAT) {
          tma_store_3d(y_map, ob, at.col0, r, co0);
        } else {
          tma_store_3d(y_map, ob, co0, at.col0, r);
        }
        bulk_commit();
      }
    } else {
      place_row<TO, FLAT>(ob, acc[o], bv, relu, lane, at.col0, W, false);
      __syncwarp();
      if constexpr (FLAT) {
        write_row_flat<TO>(y, ob, lane, r, at.col0, wb, plane, co0, c_out, vectors);
      } else {
        write_row_nhwc<TO>(y, ob, lane, r, at.col0, W, co0, c_out, vectors);
      }
      __syncwarp();
    }
  }
}

// Asynchronous copies of one halo'd NHWC tile into a ring stage
// xs[pixel][ci]; pixels outside the image are filled with zeros.
__device__ __forceinline__ void copy_tile_nhwc(__nv_bfloat16* xs,
                                               const __nv_bfloat16* __restrict__ x, int H,
                                               int W, int c_in, int row0, int col0) {
  const int vpp = c_in / 8;  // 16-byte vectors per pixel
  const int ps = pixel_stride(c_in);
  // vector v of pixel p, walked MMA_THREADS vectors at a time without a
  // division by vpp in the loop
  const int dp = MMA_THREADS / vpp;
  const int dv = MMA_THREADS % vpp;
  int p = threadIdx.x / vpp;
  int v = threadIdx.x % vpp;
  while (p < NPIX) {
    const int r = row0 - 1 + p / PITCH;
    const int c = col0 - 1 + p % PITCH;
    const bool inside = r >= 0 && r < H && c >= 0 && c < W;
    const __nv_bfloat16* src =
        inside ? x + (static_cast<long long>(r) * W + c) * c_in + v * 8 : x;
    cp_async_16(xs + p * ps + v * 8, src, inside);
    p += dp;
    v += dv;
    if (v >= vpp) {
      v -= vpp;
      ++p;
    }
  }
}

// Asynchronous copies of one tile's windows of the flat layout into a raw
// stage raw[ci][halo row][WIN], as they lie in memory: the window of a halo
// row starts 8 columns left of the tile, where 16-byte pieces are aligned.
__device__ __forceinline__ void copy_tile_flat(__nv_bfloat16* raw,
                                               const __nv_bfloat16* __restrict__ x, int wb,
                                               int margin, long long len, int c_in,
                                               int row0, int col0) {
  constexpr int VW = WIN / 8;  // vectors per window
  for (int i = threadIdx.x; i < c_in * (TH + 2) * VW; i += MMA_THREADS) {
    const int v = i % VW;
    const int q = i / VW;
    const int tr = q % (TH + 2);
    const int ci = q / (TH + 2);
    // halo row tr of the tile is padded row row0 + tr of the layout
    const long long idx =
        margin + static_cast<long long>(row0 + tr) * wb + (col0 - 8 + v * 8);
    const bool inside = idx >= 0 && idx + 8 <= len;
    const __nv_bfloat16* src = inside ? x + static_cast<long long>(ci) * len + idx : x;
    cp_async_16(raw + ci * RAW_STRIDE + tr * WIN + v * 8, src, inside);
  }
}

// raw[ci][halo row][WIN] -> xs[pixel][ci], in 8x8 blocks: ldmatrix.trans
// reads 8 channels x 8 pixels and leaves each lane the channel pairs of a
// pixel, which is what stmatrix stores as rows of xs. Window column j is tile
// column j - 7; the rows of pixels outside the tile go to `dump`.
__device__ __forceinline__ void transpose_tile(__nv_bfloat16* xs, const __nv_bfloat16* raw,
                                               __nv_bfloat16* dump, int c_in, int warp,
                                               int lane) {
  constexpr int VW = WIN / 8;
  const int ps = pixel_stride(c_in);
  const int blocks = (c_in / 8) * (TH + 2) * VW;  // a multiple of 4
  const int m = lane >> 3;
  const int row = lane & 7;
  for (int u = warp; u < blocks / 4; u += MMA_WARPS) {
    const int blk = 4 * u + m;
    const int c8 = blk / ((TH + 2) * VW);
    const int q = blk % ((TH + 2) * VW);
    const int v = q % VW;
    const int tr = q / VW;
    uint32_t r[4];
    ldmatrix_x4_trans(r, raw + (c8 * 8 + row) * RAW_STRIDE + tr * WIN + v * 8);
    const int tc = v * 8 + row - 7;
    __nv_bfloat16* dst = tc >= 0 && tc < PITCH ? xs + (tr * PITCH + tc) * ps + c8 * 8
                                                : dump + lane * 8;
    stmatrix_x4(dst, r);
  }
}

// One halo'd tile of the flat layout gathered through registers, for strides
// and bases that are not 16-byte aligned: a thread gathers 8 channels of one
// pixel from 8 planes (lanes walk neighbouring pixels) and stores them as one
// 16-byte vector of xs[pixel][ci].
__device__ __forceinline__ void gather_tile_flat(__nv_bfloat16* xs,
                                                 const __nv_bfloat16* __restrict__ x, int wb,
                                                 int margin, long long len, int c_in,
                                                 int row0, int col0) {
  const int ps = pixel_stride(c_in);
  for (int i = threadIdx.x; i < NPIX * (c_in / 8); i += MMA_THREADS) {
    const int p = i % NPIX;
    const int c8 = i / NPIX;
    const long long idx =
        margin + static_cast<long long>(row0 + p / PITCH) * wb + (col0 - 1 + p % PITCH);
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (idx >= 0 && idx < len) {
      const __nv_bfloat16* xp = x + static_cast<long long>(8 * c8) * len + idx;
      val.x = pack_pair(xp[0], xp[len]);
      val.y = pack_pair(xp[2 * len], xp[3 * len]);
      val.z = pack_pair(xp[4 * len], xp[5 * len]);
      val.w = pack_pair(xp[6 * len], xp[7 * len]);
    }
    *reinterpret_cast<uint4*>(xs + p * ps + c8 * 8) = val;
  }
}

// Shared memory of a tensor-core block, in this order: the weights, the
// epilogue buffers (one output row a warp), then the tiles.
template <typename TO>
__device__ __host__ __forceinline__ size_t head_bytes(int c_in) {
  return sizeof(__nv_bfloat16) * static_cast<size_t>(CO_B) * weight_stride(c_in) +
         sizeof(TO) * static_cast<size_t>(MMA_WARPS) * OB_ELEMS;
}
__device__ __host__ __forceinline__ size_t tile_bytes(int c_in) {
  return sizeof(__nv_bfloat16) * static_cast<size_t>(NPIX) * pixel_stride(c_in);
}
__device__ __host__ __forceinline__ size_t raw_bytes(int c_in) {
  return sizeof(__nv_bfloat16) * static_cast<size_t>(c_in) * RAW_STRIDE;
}

// A block stages its weights once, then walks tiles blockIdx.x, blockIdx.x +
// gridDim.x, ... through a ring of `stages` tiles; blockIdx.y is the block of
// CO_B output channels.
template <typename TO>
__device__ __forceinline__ void nhwc_mma_body(
    unsigned char* smem, const __nv_bfloat16* __restrict__ x,
    const __nv_bfloat16* __restrict__ w, const float* __restrict__ bias,
    TO* __restrict__ y, int H, int W, int c_in, int c_out, int relu, int stages,
    int tiles_x, int tiles) {
  __nv_bfloat16* wt = reinterpret_cast<__nv_bfloat16*>(smem);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  TO* ob = reinterpret_cast<TO*>(wt + CO_B * weight_stride(c_in)) + warp * OB_ELEMS;
  unsigned char* ring = smem + head_bytes<TO>(c_in);
  const size_t stage_bytes = tile_bytes(c_in);
  const int co0 = blockIdx.y * CO_B;
  const bool vectors = (reinterpret_cast<uintptr_t>(y) & 15) == 0 &&
                       (c_out * sizeof(TO)) % 16 == 0;

  // the first stages - 1 tiles set off before anything else
  for (int s = 0; s < stages - 1; ++s) {
    const int tile = blockIdx.x + s * gridDim.x;
    if (tile < tiles) {
      const TileAt at = tile_at(tile, tiles_x);
      copy_tile_nhwc(reinterpret_cast<__nv_bfloat16*>(ring + s * stage_bytes), x, H, W,
                     c_in, at.row0, at.col0);
    }
    cp_async_commit();
  }
  stage_weights_mma(wt, w, c_in, c_out, co0);
  float bv[NF][2];
  thread_bias(bv, bias, co0 + 2 * (lane & 3), c_out);

  int n = 0;  // tiles this block has taken: tile n lives in stage n % stages
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++n) {
    // groups in flight: tiles n .. n + stages - 2; all but this tile's may stay
    cp_async_wait(stages - 2);
    // every thread's copies of this tile (and, the first time, the weights)
    // are visible, and every warp is done with the tile before this one
    __syncthreads();
    {
      const int ahead = tile + (stages - 1) * gridDim.x;
      if (ahead < tiles) {
        const TileAt at = tile_at(ahead, tiles_x);
        copy_tile_nhwc(
            reinterpret_cast<__nv_bfloat16*>(ring + ((n + stages - 1) % stages) * stage_bytes),
            x, H, W, c_in, at.row0, at.col0);
      }
      cp_async_commit();
    }
    const TileAt at = tile_at(tile, tiles_x);
    float acc[WR][MF][NF][4] = {};
    mma_tile<false>(reinterpret_cast<const __nv_bfloat16*>(ring + (n % stages) * stage_bytes),
                    wt, c_in, warp, lane, acc);
    store_tile<TO, false>(y, nullptr, ob, acc, bv, relu, warp, lane, at, H, W, 0, 0, co0, c_out,
                          vectors);
  }
  cp_async_wait(0);
}

// The flat layout's body. stages >= 2: the ring is stages - 1 raw stages plus
// the pixel-major tile xs, which each raw stage is transposed into. stages ==
// 1: tiles are gathered into xs synchronously (no alignment asked).
template <typename TO>
__device__ __forceinline__ void flat_mma_body(
    unsigned char* smem, const __nv_bfloat16* __restrict__ x,
    const __nv_bfloat16* __restrict__ w, const float* __restrict__ bias,
    TO* __restrict__ y, int H, int W, int wb, int margin, long long len,
    int c_in, int c_out, int relu, int stages, int tiles_x, int tiles) {
  __nv_bfloat16* wt = reinterpret_cast<__nv_bfloat16*>(smem);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  TO* ob = reinterpret_cast<TO*>(wt + CO_B * weight_stride(c_in)) + warp * OB_ELEMS;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + head_bytes<TO>(c_in));
  __nv_bfloat16* dump = xs + NPIX * pixel_stride(c_in);
  unsigned char* ring = reinterpret_cast<unsigned char*>(dump) + DUMP_BYTES;
  const size_t stage_bytes = raw_bytes(c_in);
  const int raws = stages - 1;
  const int co0 = blockIdx.y * CO_B;
  const long long plane = static_cast<long long>(H) * wb;
  const bool vectors = stages >= 2;

  for (int s = 0; s < raws; ++s) {
    const int tile = blockIdx.x + s * gridDim.x;
    if (tile < tiles) {
      const TileAt at = tile_at(tile, tiles_x);
      copy_tile_flat(reinterpret_cast<__nv_bfloat16*>(ring + s * stage_bytes), x, wb, margin,
                     len, c_in, at.row0, at.col0);
    }
    cp_async_commit();
  }
  stage_weights_mma(wt, w, c_in, c_out, co0);
  float bv[NF][2];
  thread_bias(bv, bias, co0 + 2 * (lane & 3), c_out);

  int n = 0;  // tiles this block has taken: tile n arrives in raw stage n % raws
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++n) {
    const TileAt at = tile_at(tile, tiles_x);
    if (raws == 0) {
      __syncthreads();  // every warp is done with the tile before this one
      gather_tile_flat(xs, x, wb, margin, len, c_in, at.row0, at.col0);
      __syncthreads();  // the tile (and, the first time, the weights) is staged
    } else {
      __nv_bfloat16* raw = reinterpret_cast<__nv_bfloat16*>(ring + (n % raws) * stage_bytes);
      // groups in flight: tiles n .. n + raws - 1; all but this tile's may stay
      cp_async_wait(raws - 1);
      // this tile's raw stage is visible to every thread, and every warp is
      // done with xs (the tile before this one)
      __syncthreads();
      transpose_tile(xs, raw, dump, c_in, warp, lane);
      // xs (and, the first time, the weights) is staged; the raw stage is free
      __syncthreads();
      const int ahead = tile + raws * gridDim.x;
      if (ahead < tiles) {
        const TileAt next = tile_at(ahead, tiles_x);
        copy_tile_flat(raw, x, wb, margin, len, c_in, next.row0, next.col0);
      }
      cp_async_commit();
    }
    float acc[WR][MF][NF][4] = {};
    mma_tile<false>(xs, wt, c_in, warp, lane, acc);
    store_tile<TO, true>(y, nullptr, ob, acc, bv, relu, warp, lane, at, H, W, wb, plane, co0,
                         c_out, vectors);
  }
  cp_async_wait(0);
}

// --- tiles brought by the copy engine (TMA) ---

// Elements of a warp's epilogue buffer: dense for a TMA store, else padded.
__device__ __host__ __forceinline__ int ob_elems(bool tma_out) {
  return tma_out ? TW * CO_B : OB_ELEMS;
}

__device__ __host__ __forceinline__ size_t align_up(size_t n, size_t a) {
  return (n + a - 1) / a * a;
}
// a dense halo'd tile xs[pixel][ci], swizzled, up to the next stage's start
__device__ __host__ __forceinline__ size_t tma_tile_bytes(int c_in) {
  return align_up(sizeof(__nv_bfloat16) * static_cast<size_t>(NPIX) * c_in, TMA_ALIGN);
}

// Wait until the phase of this parity has completed. A copy that never lands
// is a fault of the program: it ends the kernel with an error, not a hang.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  for (unsigned spins = 0; !mbar_try_wait(bar, parity); ++spins) {
    if (spins > (1u << 24)) __trap();
  }
}

// The NHWC body with its tiles brought by TMA: one thread asks for a whole
// halo'd tile with one instruction (tensor map over x as (C, W, H), box
// c_in x 34 x 10; pixels outside the image arrive as zeros), so no warp
// spends instructions or waits at the load-store unit for its input. Stage s
// is full when its bytes have landed (full[s]) and free again when the
// MMA_WARPS warps have each let go of it (empty[s]); no barrier of the whole
// block is left in the loop.
template <typename TO>
__device__ __forceinline__ void nhwc_tma_body(
    unsigned char* smem, const CUtensorMap* x_map, const CUtensorMap* y_map,
    const __nv_bfloat16* __restrict__ w, const float* __restrict__ bias, TO* __restrict__ y,
    int H, int W, int c_in, int c_out, int relu, int stages, int tiles_x, int tiles) {
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + MAX_STAGES;
  __nv_bfloat16* wt = reinterpret_cast<__nv_bfloat16*>(smem + BARRIER_BYTES);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // the epilogue buffers and, behind them, the stages start at the first
  // 1024-byte boundary behind the weights (what TMA's swizzles ask for)
  unsigned char* wt_end = reinterpret_cast<unsigned char*>(wt + CO_B * weight_stride(c_in));
  unsigned char* aligned =
      wt_end + ((TMA_ALIGN - (smem_addr(wt_end) & (TMA_ALIGN - 1))) & (TMA_ALIGN - 1));
  const int ob_size = ob_elems(y_map != nullptr);
  TO* ob = reinterpret_cast<TO*>(aligned) + warp * ob_size;
  unsigned char* stage0 = aligned + align_up(sizeof(TO) * MMA_WARPS * ob_size, TMA_ALIGN);
  const size_t stage_bytes = tma_tile_bytes(c_in);
  const int box_bytes = NPIX * c_in * static_cast<int>(sizeof(__nv_bfloat16));
  const int co0 = blockIdx.y * CO_B;
  const bool vectors = (reinterpret_cast<uintptr_t>(y) & 15) == 0 &&
                       (c_out * sizeof(TO)) % 16 == 0;

  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, MMA_WARPS);
    }
    fence_barrier_init();
  }
  stage_weights_mma(wt, w, c_in, c_out, co0);
  __syncthreads();  // the barriers and the weights are there

  // thread 0: this block's tile number u into stage u % stages, once the
  // warps have let go of what was there (the first time round nothing was:
  // the phase before a barrier's first counts as completed)
  auto request = [&](int u) {
    const int tile = blockIdx.x + u * gridDim.x;
    if (tile >= tiles) return;
    const int s = u % stages;
    mbar_wait(empty + s, ((u / stages) & 1) ^ 1);
    mbar_arrive_expect(full + s, box_bytes);
    const TileAt at = tile_at(tile, tiles_x);
    tma_load_3d(stage0 + s * stage_bytes, x_map, 0, at.col0 - 1, at.row0 - 1, full + s);
  };
  if (threadIdx.x == 0) {
    for (int u = 0; u < stages - 1; ++u) request(u);
  }
  float bv[NF][2];
  thread_bias(bv, bias, co0 + 2 * (lane & 3), c_out);

  int n = 0;  // tiles this block has taken: tile n lives in stage n % stages
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++n) {
    if (threadIdx.x == 0) request(n + stages - 1);
    __syncwarp();
    const int s = n % stages;
    mbar_wait(full + s, (n / stages) & 1);
    float acc[WR][MF][NF][4] = {};
    mma_tile<true>(reinterpret_cast<const __nv_bfloat16*>(stage0 + s * stage_bytes), wt, c_in,
                   warp, lane, acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);
    store_tile<TO, false>(y, y_map, ob, acc, bv, relu, warp, lane, tile_at(tile, tiles_x), H, W,
                          0, 0, co0, c_out, vectors);
  }
  // shared memory stays until the last store has read it
  if (lane == 0 && y_map != nullptr) bulk_wait_read();
}

// The flat layout's windows as TMA brings them: raw[halo row][ci][WIN], dense
// rows of 96 bytes from 8 columns left of the tile. 96 bytes take no swizzle:
// the 8 channels of an ldmatrix.trans block fall on 4 groups of banks, two
// each, which this short pass can afford; rows of 128 bytes would cost a
// third more shared memory, and with it the second raw stage.
__device__ __host__ __forceinline__ size_t tma_raw_bytes(int c_in) {
  return sizeof(__nv_bfloat16) * static_cast<size_t>(TH + 2) * c_in * WIN;
}

// raw[halo row][ci][WIN] -> xs[pixel][ci] (dense, swizzled as mma_tile<true>
// reads it), in 8x8 blocks like transpose_tile.
__device__ __forceinline__ void transpose_tile_tma(__nv_bfloat16* xs, const __nv_bfloat16* raw,
                                                   __nv_bfloat16* dump, int c_in, int warp,
                                                   int lane) {
  constexpr int VW = WIN / 8;
  const int blocks = (c_in / 8) * (TH + 2) * VW;  // a multiple of 4
  const int m = lane >> 3;
  const int row = lane & 7;
  for (int u = warp; u < blocks / 4; u += MMA_WARPS) {
    const int blk = 4 * u + m;
    const int c8 = blk / ((TH + 2) * VW);
    const int q = blk % ((TH + 2) * VW);
    const int v = q % VW;
    const int tr = q / VW;
    uint32_t r[4];
    ldmatrix_x4_trans(r, raw + (tr * c_in + c8 * 8 + row) * WIN + v * 8);
    const int tc = v * 8 + row - 7;
    __nv_bfloat16* dst =
        tc >= 0 && tc < PITCH ? xs + swizzled(tr * PITCH + tc, c8, c_in) : dump + lane * 8;
    stmatrix_x4(dst, r);
  }
}

// The flat body with TMA on both sides: x as a tensor (column, C, row) based
// at the layout's row 0, box 48 x c_in x 10 from (col0 - 8, 0, row0); columns
// left of 0 or right of wb arrive as zeros where the flat shift would have
// read the neighbouring row, which only ever feeds the masked pad columns.
// The ring is stages - 1 raw stages plus the pixel-major tile xs.
template <typename TO>
__device__ __forceinline__ void flat_tma_body(
    unsigned char* smem, const CUtensorMap* x_map, const CUtensorMap* y_map,
    const __nv_bfloat16* __restrict__ w, const float* __restrict__ bias, TO* __restrict__ y,
    int H, int W, int wb, int c_in, int c_out, int relu, int stages, int tiles_x, int tiles) {
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + MAX_STAGES;
  __nv_bfloat16* wt = reinterpret_cast<__nv_bfloat16*>(smem + BARRIER_BYTES);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  unsigned char* wt_end = reinterpret_cast<unsigned char*>(wt + CO_B * weight_stride(c_in));
  unsigned char* aligned =
      wt_end + ((TMA_ALIGN - (smem_addr(wt_end) & (TMA_ALIGN - 1))) & (TMA_ALIGN - 1));
  const int ob_size = ob_elems(y_map != nullptr);
  TO* ob = reinterpret_cast<TO*>(aligned) + warp * ob_size;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(
      aligned + align_up(sizeof(TO) * MMA_WARPS * ob_size, TMA_ALIGN));
  unsigned char* xs_end = reinterpret_cast<unsigned char*>(xs) + tma_tile_bytes(c_in);
  __nv_bfloat16* dump = reinterpret_cast<__nv_bfloat16*>(xs_end);
  unsigned char* stage0 = xs_end + TMA_ALIGN;
  const size_t stage_bytes = tma_raw_bytes(c_in);
  const int raws = stages - 1;
  const int co0 = blockIdx.y * CO_B;
  const long long plane = static_cast<long long>(H) * wb;
  // without a TMA store: wb is a multiple of 8, so y's base decides
  const bool vectors = (reinterpret_cast<uintptr_t>(y) & 15) == 0;

  if (threadIdx.x == 0) {
    for (int i = 0; i < raws; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, MMA_WARPS);
    }
    fence_barrier_init();
  }
  stage_weights_mma(wt, w, c_in, c_out, co0);
  __syncthreads();  // the barriers and the weights are there

  // thread 0: this block's tile number u into raw stage u % raws
  auto request = [&](int u) {
    const int tile = blockIdx.x + u * gridDim.x;
    if (tile >= tiles) return;
    const int s = u % raws;
    mbar_wait(empty + s, ((u / raws) & 1) ^ 1);
    mbar_arrive_expect(full + s, static_cast<int>(stage_bytes));
    const TileAt at = tile_at(tile, tiles_x);
    tma_load_3d(stage0 + s * stage_bytes, x_map, at.col0 - 8, 0, at.row0, full + s);
  };
  if (threadIdx.x == 0) {
    for (int u = 0; u < raws; ++u) request(u);
  }
  float bv[NF][2];
  thread_bias(bv, bias, co0 + 2 * (lane & 3), c_out);

  int n = 0;  // tiles this block has taken: tile n arrives in raw stage n % raws
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++n) {
    const int s = n % raws;
    mbar_wait(full + s, (n / raws) & 1);
    __syncthreads();  // every warp is done with xs (the tile before this one)
#ifndef CONV3X3_WITHOUT_TRANSPOSE  // studies/conv3x3_parts.py
    transpose_tile_tma(xs, reinterpret_cast<const __nv_bfloat16*>(stage0 + s * stage_bytes), dump,
                       c_in, warp, lane);
#endif
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);
    __syncthreads();  // xs is whole, and every warp has let go of the raw stage
    if (threadIdx.x == 0) request(n + raws);
    __syncwarp();
    float acc[WR][MF][NF][4] = {};
    mma_tile<true>(xs, wt, c_in, warp, lane, acc);
    store_tile<TO, true>(y, y_map, ob, acc, bv, relu, warp, lane, tile_at(tile, tiles_x), H, W, wb,
                         plane, co0, c_out, vectors);
  }
  if (lane == 0 && y_map != nullptr) bulk_wait_read();
}

// ---------------------------------------------------------------------------
// the two kernels
// ---------------------------------------------------------------------------

template <typename TI, typename TO, bool MMA>
__global__ void __launch_bounds__(MMA ? MMA_THREADS : THREADS)
    conv3x3_nhwc_kernel(const TI* __restrict__ x, const TI* __restrict__ w,
                        const float* __restrict__ bias, TO* __restrict__ y,
                        int H, int W, int c_in, int c_out, int ci_blk, int relu,
                        int stages, int tiles_x, int tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  if constexpr (MMA) {
    nhwc_mma_body<TO>(smem, x, w, bias, y, H, W, c_in, c_out, relu, stages, tiles_x,
                      tiles);
  } else {
    nhwc_simt_body<TI, TO>(reinterpret_cast<float*>(smem), x, w, bias, y, H, W, c_in,
                           c_out, ci_blk, relu);
  }
}

template <typename TI, typename TO, bool MMA>
__global__ void __launch_bounds__(MMA ? MMA_THREADS : THREADS)
    conv3x3_flat_chw_kernel(const TI* __restrict__ x, const TI* __restrict__ w,
                            const float* __restrict__ bias, TO* __restrict__ y,
                            int H, int W, int wb, int margin, long long len,
                            int c_in, int c_out, int ci_blk, int relu, int stages,
                            int tiles_x, int tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  if constexpr (MMA) {
    flat_mma_body<TO>(smem, x, w, bias, y, H, W, wb, margin, len, c_in, c_out, relu,
                      stages, tiles_x, tiles);
  } else {
    flat_simt_body<TI, TO>(reinterpret_cast<float*>(smem), x, w, bias, y, H, W, wb,
                           margin, len, c_in, c_out, ci_blk, relu);
  }
}

template <typename TO>
__global__ void __launch_bounds__(MMA_THREADS)
    conv3x3_nhwc_tma_kernel(const __grid_constant__ CUtensorMap x_map,
                            const __grid_constant__ CUtensorMap y_map, int tma_out,
                            const __nv_bfloat16* __restrict__ w,
                            const float* __restrict__ bias, TO* __restrict__ y, int H, int W,
                            int c_in, int c_out, int relu, int stages, int tiles_x,
                            int tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  nhwc_tma_body<TO>(smem, &x_map, tma_out ? &y_map : nullptr, w, bias, y, H, W, c_in, c_out,
                    relu, stages, tiles_x, tiles);
}

template <typename TO>
__global__ void __launch_bounds__(MMA_THREADS)
    conv3x3_flat_tma_kernel(const __grid_constant__ CUtensorMap x_map,
                            const __grid_constant__ CUtensorMap y_map, int tma_out,
                            const __nv_bfloat16* __restrict__ w,
                            const float* __restrict__ bias, TO* __restrict__ y, int H, int W,
                            int wb, int c_in, int c_out, int relu, int stages, int tiles_x,
                            int tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  flat_tma_body<TO>(smem, &x_map, tma_out ? &y_map : nullptr, w, bias, y, H, W, wb, c_in, c_out,
                    relu, stages, tiles_x, tiles);
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

// Which body runs: the values seq_conv3x3_body returns.
constexpr int BODY_CUDA_CORES = 0;
constexpr int BODY_MMA_SYNCHRONOUS = 1;
constexpr int BODY_MMA_PIPELINED = 2;

// What a launcher decided. `launch` false: decide and report only.
struct Plan {
  bool launch;
  int body;
  int stages;         // tiles in flight in a block, the one multiplied included
  int blocks_per_sm;  // resident blocks the persistent grid counts on
  int smem_bytes;
  int tma;            // 1: the tiles are brought by the copy engine, 0: by cp.async
};

inline int chunk_of(int c_in) { return c_in < CI_MAX ? c_in : CI_MAX; }

inline size_t simt_bytes(int ci_blk) {
  return sizeof(float) * (static_cast<size_t>(9) * ci_blk * CO_B +
                          static_cast<size_t>(ci_blk) * PLANE);
}

template <typename TO>
size_t nhwc_mma_bytes(int c_in, int stages) {
  return head_bytes<TO>(c_in) + stages * tile_bytes(c_in);
}

template <typename TO>
size_t flat_mma_bytes(int c_in, int stages) {
  return head_bytes<TO>(c_in) + tile_bytes(c_in) + DUMP_BYTES + (stages - 1) * raw_bytes(c_in);
}

// barriers, weights, up to a 1024-byte boundary, epilogue buffers, stages
template <typename TO>
size_t nhwc_tma_bytes(int c_in, int stages, bool tma_out) {
  return BARRIER_BYTES + sizeof(__nv_bfloat16) * CO_B * weight_stride(c_in) + TMA_ALIGN +
         align_up(sizeof(TO) * MMA_WARPS * ob_elems(tma_out), TMA_ALIGN) +
         stages * tma_tile_bytes(c_in);
}

// ... and the pixel-major tile, the dump for rows outside it, the raw stages
template <typename TO>
size_t flat_tma_bytes(int c_in, int stages, bool tma_out) {
  return nhwc_tma_bytes<TO>(c_in, 1, tma_out) + TMA_ALIGN + (stages - 1) * tma_raw_bytes(c_in);
}

// cuTensorMapEncodeTiled, looked up in libcuda through the runtime (this
// library is not linked against it); null if it is not there.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess) {
      p = nullptr;
    }
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A tensor map over a bf16 tensor of three dimensions (innermost first, the
// innermost contiguous); what a box holds beyond the tensor reads as zeros.
// `swizzled`: with the swizzle that fits the box's rows of 32, 64 or 128
// bytes; else the box lies in shared memory as it is.
inline int tensor_map_3d(CUtensorMap* map, const void* base, const cuuint64_t (&dims)[3],
                         const cuuint64_t (&strides)[2], const cuuint32_t (&box)[3],
                         bool swizzled) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint32_t row_bytes = box[0] * 2;
  const CUtensorMapSwizzle swizzle = !swizzled        ? CU_TENSOR_MAP_SWIZZLE_NONE
                                     : row_bytes == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                                     : row_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                       : CU_TENSOR_MAP_SWIZZLE_128B;
  const cuuint32_t ones[3] = {1, 1, 1};
  const CUresult rc = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
                             dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// The most dynamic shared memory a block may ask for on this device.
inline int smem_limit(size_t* limit) {
  int dev = 0, bytes = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  *limit = static_cast<size_t>(bytes);
  return static_cast<int>(e);
}

// More than 48 KB of dynamic shared memory needs the opt-in attribute; its
// refusal is returned, never swallowed.
template <typename K>
int allow_smem(K kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

// Blocks of this kernel an SM holds at once with `bytes` of shared memory.
template <typename K>
int blocks_per_sm(K kernel, int threads, size_t bytes, int* per_sm) {
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, threads, bytes));
}

// The ring's depth and the persistent grid for a tensor-core kernel whose
// shared memory is bytes_of(stages): from `lo` stages, one more (up to
// MAX_STAGES) whenever that costs no resident block. Fills plan and *blocks
// (as many as the card holds at once, at most one per tile); returns a
// cudaError_t.
template <typename K, typename F>
int plan_ring(K kernel, F bytes_of, int lo, size_t limit, int tiles, Plan* plan,
              int* blocks) {
  int hi = lo;
  while (hi < MAX_STAGES && bytes_of(hi + 1) <= limit) ++hi;
  int rc = allow_smem(kernel, bytes_of(hi));
  if (rc != 0) return rc;
  int stages = lo, per_sm = 0;
  rc = blocks_per_sm(kernel, MMA_THREADS, bytes_of(lo), &per_sm);
  if (rc != 0) return rc;
  for (int s = lo + 1; s <= hi; ++s) {
    int deeper = 0;
    rc = blocks_per_sm(kernel, MMA_THREADS, bytes_of(s), &deeper);
    if (rc != 0) return rc;
    if (deeper < per_sm) break;
    stages = s;
  }
  if (per_sm < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long resident = static_cast<long long>(sms) * per_sm;
  *blocks = static_cast<int>(resident < tiles ? resident : tiles);
  plan->stages = stages;
  plan->blocks_per_sm = per_sm;
  plan->smem_bytes = static_cast<int>(bytes_of(stages));
  return 0;
}

template <typename TI, typename TO>
int launch_nhwc(const void* x, const void* w, const float* bias, void* y, int H,
                int W, int c_in, int c_out, int relu, cudaStream_t stream, Plan* plan) {
  const int tiles_x = (W + TW - 1) / TW;
  const int tiles_y = (H + TH - 1) / TH;
  const int co_blocks = (c_out + CO_B - 1) / CO_B;
  if constexpr (sizeof(TI) == 2) {
    size_t limit = 0;
    int rc = smem_limit(&limit);
    if (rc != 0) return rc;
    // 16-byte copies: every pixel's channels start on a 16-byte boundary
    const long long all_tiles = static_cast<long long>(tiles_x) * tiles_y;
    // TMA's swizzles take rows of 32, 64 or 128 bytes: the tile's pixels are
    // such rows at 16, 32 or 64 channels
    // a TMA store takes bf16 rows of y that start on 16-byte boundaries
    const bool tma_out = sizeof(TO) == 2 && c_out % 8 == 0 && aligned16(y);
    if ((c_in == 16 || c_in == 32 || c_in == 64) && aligned16(x) &&
        nhwc_tma_bytes<TO>(c_in, 2, tma_out) <= limit && all_tiles <= 0x7fffffff) {
      auto kernel = conv3x3_nhwc_tma_kernel<TO>;
      int blocks = 0;
      plan->body = BODY_MMA_PIPELINED;
      plan->tma = 1;
      rc = plan_ring(
          kernel, [=](int s) { return nhwc_tma_bytes<TO>(c_in, s, tma_out); }, 2, limit,
          static_cast<int>(all_tiles), plan, &blocks);
      if (rc != 0 || !plan->launch) return rc;
      CUtensorMap x_map;
      const cuuint64_t row = static_cast<cuuint64_t>(c_in) * sizeof(__nv_bfloat16);
      rc = tensor_map_3d(&x_map, x,
                         {static_cast<cuuint64_t>(c_in), static_cast<cuuint64_t>(W),
                          static_cast<cuuint64_t>(H)},
                         {row, row * W},
                         {static_cast<cuuint32_t>(c_in), PITCH, TH + 2}, true);
      if (rc != 0) return rc;
      CUtensorMap y_map = {};
      if (tma_out) {
        const cuuint64_t run = static_cast<cuuint64_t>(c_out) * sizeof(TO);
        rc = tensor_map_3d(&y_map, y,
                           {static_cast<cuuint64_t>(c_out), static_cast<cuuint64_t>(W),
                            static_cast<cuuint64_t>(H)},
                           {run, run * W}, {CO_B, TW, 1}, true);
        if (rc != 0) return rc;
      }
      kernel<<<dim3(blocks, co_blocks), MMA_THREADS, plan->smem_bytes, stream>>>(
          x_map, y_map, tma_out, static_cast<const TI*>(w), bias, static_cast<TO*>(y), H, W, c_in,
          c_out, relu, plan->stages, tiles_x, static_cast<int>(all_tiles));
      return static_cast<int>(cudaGetLastError());
    }
    if (c_in % 16 == 0 && aligned16(x) && nhwc_mma_bytes<TO>(c_in, 2) <= limit) {
      auto kernel = conv3x3_nhwc_kernel<TI, TO, true>;
      const long long tiles = static_cast<long long>(tiles_x) * tiles_y;
      if (tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
      int blocks = 0;
      plan->body = BODY_MMA_PIPELINED;
      rc = plan_ring(
          kernel, [c_in](int s) { return nhwc_mma_bytes<TO>(c_in, s); }, 2, limit,
          static_cast<int>(tiles), plan, &blocks);
      if (rc != 0 || !plan->launch) return rc;
      kernel<<<dim3(blocks, co_blocks), MMA_THREADS, plan->smem_bytes, stream>>>(
          static_cast<const TI*>(x), static_cast<const TI*>(w), bias,
          static_cast<TO*>(y), H, W, c_in, c_out, 0, relu, plan->stages, tiles_x,
          static_cast<int>(tiles));
      return static_cast<int>(cudaGetLastError());
    }
  }
  const int ci_blk = chunk_of(c_in);
  const size_t bytes = simt_bytes(ci_blk);
  plan->body = BODY_CUDA_CORES;
  plan->stages = 1;
  plan->blocks_per_sm = 0;
  plan->smem_bytes = static_cast<int>(bytes);
  if (!plan->launch) return 0;
  auto kernel = conv3x3_nhwc_kernel<TI, TO, false>;
  const int rc = allow_smem(kernel, bytes);
  if (rc != 0) return rc;
  kernel<<<dim3(tiles_x, tiles_y, co_blocks), THREADS, bytes, stream>>>(
      static_cast<const TI*>(x), static_cast<const TI*>(w), bias,
      static_cast<TO*>(y), H, W, c_in, c_out, ci_blk, relu, 0, 0, 0);
  return static_cast<int>(cudaGetLastError());
}

template <typename TI, typename TO>
int launch_flat(const void* x, const void* w, const float* bias, void* y, int H,
                int W, int wb, int margin, int c_in, int c_out, int relu,
                cudaStream_t stream, Plan* plan) {
  const int tiles_x = (wb + TW - 1) / TW;
  const int tiles_y = (H + TH - 1) / TH;
  const int co_blocks = (c_out + CO_B - 1) / CO_B;
  const long long len = margin + static_cast<long long>(H + 16) * wb;
  if constexpr (sizeof(TI) == 2) {
    size_t limit = 0;
    int rc = smem_limit(&limit);
    if (rc != 0) return rc;
    const long long all_tiles = static_cast<long long>(tiles_x) * tiles_y;
    // TMA: every plane row of x starts on a 16-byte boundary, and the tile's
    // pixels are rows of 32, 64 or 128 bytes (the swizzles there are)
    const bool tma_out = sizeof(TO) == 2 && aligned16(y);
    if ((c_in == 16 || c_in == 32 || c_in == 64) && aligned16(x) && wb % 8 == 0 &&
        margin % 8 == 0 && flat_tma_bytes<TO>(c_in, 2, tma_out) <= limit &&
        all_tiles <= 0x7fffffff) {
      auto kernel = conv3x3_flat_tma_kernel<TO>;
      int blocks = 0;
      plan->body = BODY_MMA_PIPELINED;
      plan->tma = 1;
      rc = plan_ring(
          kernel, [=](int s) { return flat_tma_bytes<TO>(c_in, s, tma_out); }, 2, limit,
          static_cast<int>(all_tiles), plan, &blocks);
      if (rc != 0 || !plan->launch) return rc;
      CUtensorMap x_map;
      const cuuint64_t row = static_cast<cuuint64_t>(wb) * sizeof(__nv_bfloat16);
      rc = tensor_map_3d(&x_map, static_cast<const __nv_bfloat16*>(x) + margin,
                         {static_cast<cuuint64_t>(wb), static_cast<cuuint64_t>(c_in),
                          static_cast<cuuint64_t>(H + 16)},
                         {static_cast<cuuint64_t>(len) * sizeof(__nv_bfloat16), row},
                         {WIN, static_cast<cuuint32_t>(c_in), TH + 2}, false);
      if (rc != 0) return rc;
      CUtensorMap y_map = {};
      if (tma_out) {
        rc = tensor_map_3d(&y_map, y,
                           {static_cast<cuuint64_t>(wb), static_cast<cuuint64_t>(H),
                            static_cast<cuuint64_t>(c_out)},
                           {row, row * H}, {TW, 1, CO_B}, true);
        if (rc != 0) return rc;
      }
      kernel<<<dim3(blocks, co_blocks), MMA_THREADS, plan->smem_bytes, stream>>>(
          x_map, y_map, tma_out, static_cast<const TI*>(w), bias, static_cast<TO*>(y), H, W, wb,
          c_in, c_out, relu, plan->stages, tiles_x, static_cast<int>(all_tiles));
      return static_cast<int>(cudaGetLastError());
    }
    if (c_in % 16 == 0 && flat_mma_bytes<TO>(c_in, 1) <= limit) {
      auto kernel = conv3x3_flat_chw_kernel<TI, TO, true>;
      const long long tiles = static_cast<long long>(tiles_x) * tiles_y;
      if (tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
      // 16-byte copies and stores: every plane row of x and y starts on a
      // 16-byte boundary, and so does the window 8 columns left of a tile
      const bool aligned = aligned16(x) && aligned16(y) && wb % 8 == 0 && margin % 8 == 0 &&
                           flat_mma_bytes<TO>(c_in, 2) <= limit;
      const int lo = aligned ? 2 : 1;
      int blocks = 0;
      plan->body = aligned ? BODY_MMA_PIPELINED : BODY_MMA_SYNCHRONOUS;
      rc = plan_ring(
          kernel, [c_in](int s) { return flat_mma_bytes<TO>(c_in, s); }, lo,
          aligned ? limit : flat_mma_bytes<TO>(c_in, 1), static_cast<int>(tiles), plan,
          &blocks);
      if (rc != 0 || !plan->launch) return rc;
      kernel<<<dim3(blocks, co_blocks), MMA_THREADS, plan->smem_bytes, stream>>>(
          static_cast<const TI*>(x), static_cast<const TI*>(w), bias,
          static_cast<TO*>(y), H, W, wb, margin, len, c_in, c_out, 0, relu,
          plan->stages, tiles_x, static_cast<int>(tiles));
      return static_cast<int>(cudaGetLastError());
    }
  }
  const int ci_blk = chunk_of(c_in);
  const size_t bytes = simt_bytes(ci_blk);
  plan->body = BODY_CUDA_CORES;
  plan->stages = 1;
  plan->blocks_per_sm = 0;
  plan->smem_bytes = static_cast<int>(bytes);
  if (!plan->launch) return 0;
  auto kernel = conv3x3_flat_chw_kernel<TI, TO, false>;
  const int rc = allow_smem(kernel, bytes);
  if (rc != 0) return rc;
  kernel<<<dim3(tiles_x, tiles_y, co_blocks), THREADS, bytes, stream>>>(
      static_cast<const TI*>(x), static_cast<const TI*>(w), bias,
      static_cast<TO*>(y), H, W, wb, margin, len, c_in, c_out, ci_blk, relu, 0, 0, 0);
  return static_cast<int>(cudaGetLastError());
}

inline bool sizes_ok(int H, int W, int c_in, int c_out) {
  return H > 0 && W > 0 && c_in > 0 && c_out > 0 &&
         (H + TH - 1) / TH <= 65535 && (c_out + CO_B - 1) / CO_B <= 65535;
}

int run_nhwc(const void* x, const void* w, const float* bias, void* y, int H, int W,
             int c_in, int c_out, int relu, int in_type, int out_type,
             cudaStream_t s, Plan* plan) {
  if (!sizes_ok(H, W, c_in, c_out)) return static_cast<int>(cudaErrorInvalidValue);
  if (in_type == 0 && out_type == 0)
    return launch_nhwc<float, float>(x, w, bias, y, H, W, c_in, c_out, relu, s, plan);
  if (in_type == 0 && out_type == 1)
    return launch_nhwc<float, __nv_bfloat16>(x, w, bias, y, H, W, c_in, c_out, relu, s, plan);
  if (in_type == 1 && out_type == 0)
    return launch_nhwc<__nv_bfloat16, float>(x, w, bias, y, H, W, c_in, c_out, relu, s, plan);
  if (in_type == 1 && out_type == 1)
    return launch_nhwc<__nv_bfloat16, __nv_bfloat16>(x, w, bias, y, H, W, c_in, c_out, relu, s, plan);
  return static_cast<int>(cudaErrorInvalidValue);
}

int run_flat(const void* x, const void* w, const float* bias, void* y, int H, int W,
             int wb, int margin, int c_in, int c_out, int relu, int in_type,
             int out_type, cudaStream_t s, Plan* plan) {
  if (!sizes_ok(H, W, c_in, c_out) || wb < W + 2 || margin < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (in_type == 0 && out_type == 0)
    return launch_flat<float, float>(x, w, bias, y, H, W, wb, margin, c_in, c_out, relu, s, plan);
  if (in_type == 0 && out_type == 1)
    return launch_flat<float, __nv_bfloat16>(x, w, bias, y, H, W, wb, margin, c_in, c_out, relu, s, plan);
  if (in_type == 1 && out_type == 0)
    return launch_flat<__nv_bfloat16, float>(x, w, bias, y, H, W, wb, margin, c_in, c_out, relu, s, plan);
  if (in_type == 1 && out_type == 1)
    return launch_flat<__nv_bfloat16, __nv_bfloat16>(x, w, bias, y, H, W, wb, margin, c_in, c_out, relu, s, plan);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Element types: 0 = float32, 1 = bfloat16. x and w share in_type; bias is
// f32. Each function launches on `stream` and returns a cudaError_t
// (0 = launched): cudaErrorInvalidValue for sizes or types it does not take.

extern "C" int seq_conv3x3_nhwc(const void* x, const void* w, const float* bias,
                                void* y, int H, int W, int c_in, int c_out,
                                int relu, int in_type, int out_type,
                                void* stream) {
  Plan plan = {true, 0, 0, 0, 0, 0};
  return run_nhwc(x, w, bias, y, H, W, c_in, c_out, relu, in_type, out_type,
                  static_cast<cudaStream_t>(stream), &plan);
}

extern "C" int seq_conv3x3_flat_chw(const void* x, const void* w,
                                    const float* bias, void* y, int H, int W,
                                    int wb, int margin, int c_in, int c_out,
                                    int relu, int in_type, int out_type,
                                    void* stream) {
  Plan plan = {true, 0, 0, 0, 0, 0};
  return run_flat(x, w, bias, y, H, W, wb, margin, c_in, c_out, relu, in_type,
                  out_type, static_cast<cudaStream_t>(stream), &plan);
}

// Which body the launcher picks for these arguments, without launching:
// flat = 0 asks seq_conv3x3_nhwc's launcher (wb and margin unused), flat = 1
// seq_conv3x3_flat_chw's. x and y are read as addresses only. Fills info[0..4]
// with the body (0 CUDA cores, 1 tensor cores with synchronous staging, 2
// tensor cores pipelined), the tiles in flight in a block, the resident
// blocks an SM that the grid counts on (0 for the CUDA-core grid, one block a
// tile) the bytes of shared memory a block, and whether the tiles come by TMA (1)
// or by cp.async (0). Returns a cudaError_t.
extern "C" int seq_conv3x3_body(int flat, const void* x, const void* y, int H, int W,
                                int wb, int margin, int c_in, int c_out, int in_type,
                                int out_type, int* info) {
  Plan plan = {false, 0, 0, 0, 0, 0};
  void* out = const_cast<void*>(y);
  const int rc = flat ? run_flat(x, nullptr, nullptr, out, H, W, wb, margin, c_in, c_out, 0,
                                 in_type, out_type, nullptr, &plan)
                      : run_nhwc(x, nullptr, nullptr, out, H, W, c_in, c_out, 0, in_type,
                                 out_type, nullptr, &plan);
  info[0] = plan.body;
  info[1] = plan.stages;
  info[2] = plan.blocks_per_sm;
  info[3] = plan.smem_bytes;
  info[4] = plan.tma;
  return rc;
}
