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
// its floor is bytes.
//
// Each kernel has two bodies, chosen by the launcher from what it can see:
//   * bf16 input with C_in a multiple of 16 (and the weights of one block of
//     32 output channels fitting shared memory): the tensor cores, through
//     mma.sync.m16n8k16 with f32 accumulators (mma_body).
//   * anything else (f32 input, which must multiply in f32; C_in = 1 or 3):
//     the CUDA cores, in f32 (simt_body). At 67 TFLOP/s peak that body is
//     bound by its own arithmetic, 0.29 ms for the work above.
//
// Design, against the TPU kernels:
//   * The TPU grid walks row bands in order, one band in VMEM at a time, and
//     builds an im2col matrix there for one big matmul. Here blocks run in
//     parallel and shared memory is small: a block owns an 8 x 32 tile of
//     output pixels and 32 output channels and stages the tile's halo'd input
//     (10 x 34 pixels) and the weights in shared memory. No im2col matrix is
//     ever made: the nine taps are nine offsets into the staged tile.
//   * mma_body keeps the tile pixel-major with channels contiguous, as bf16,
//     and the weights channel-major with the 9*C_in contraction contiguous,
//     so every mma fragment register is one 32-bit shared-memory load. Rows
//     are padded by 8 bf16 so that the eight pixels (or output channels) a
//     fragment load touches fall in distinct banks. A warp owns one tile row:
//     two 16-pixel fragments by four 8-channel fragments, 32 f32 accumulators
//     a thread. The whole contraction's weights stay in shared memory, and a
//     block walks several tiles (a persistent grid), so they are staged once.
//   * simt_body keeps the tile as f32 channel planes and walks the input
//     channels in chunks of at most 32. A thread owns 4 rows x 1 column x 8
//     channels (32 accumulators). For one input channel and one dx it loads
//     the 6 rows its 4 outputs touch once and uses them for all three dy. A
//     warp spans the 32 columns of a tile row, so its plane reads are
//     consecutive words and its weight reads are one broadcast address.
//   * The image border is a predicated load that yields zero: the NHWC kernel
//     reads the unpadded input, where the TPU wrapper wrote a padded copy to
//     HBM to satisfy its DMA alignment rules.
//   * The flat kernel keeps the layout contract of the TPU kernels: input
//     (C_in, margin + (H+16)*Wb) with a zero ring, output (C_out, H*Wb) whose
//     columns 0 and > W are written as zero so that the output can be re-padded
//     for a following layer. Taps are flat shifts dy*Wb + dx; column 0 of a row
//     reads the last element of the row before it, which only the zero ring
//     and the output mask make harmless. Its mma_body transposes the tile to
//     pixel-major while staging it (8 plane reads for one 16-byte store),
//     which the NHWC kernel gets for free.
//   * Operands multiply into f32; the f32 accumulator gets the f32 bias and
//     the activation and is rounded once, to the output type.
//   * Index arithmetic that multiplies three sizes is 64-bit.

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

constexpr int NPIX = (TH + 2) * PITCH;  // pixels of a halo'd tile
constexpr int KPAD = 8;                 // bf16 of padding per shared-memory row
constexpr int MF = TW / 16;             // 16-pixel fragments per warp (a tile row)
constexpr int NF = CO_B / 8;            // 8-channel fragments per warp
static_assert(THREADS / 32 == TH, "one warp per tile row");

// D = A (16 x 16, row-major) * B (16 x 8, column-major) + D, bf16 into f32.
// Lane = 4*g + t holds A[g][2t..2t+1], A[g+8][2t..], A[g][2t+8..], A[g+8][2t+8..];
// B[2t..2t+1][g], B[2t+8..2t+9][g]; D[g][2t..2t+1], D[g+8][2t..2t+1].
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_pair(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// yp[co], yp[co + 1] = v0, v1 (channels past c_out dropped); as one 32-bit
// store when `pairs` says the address is word-aligned and TO is bf16.
template <typename TO>
__device__ __forceinline__ void store_pair(TO* yp, int co, int c_out, float v0,
                                           float v1, bool pairs) {
  if constexpr (sizeof(TO) == 2) {
    if (pairs && co + 1 < c_out) {
      *reinterpret_cast<uint32_t*>(yp + co) =
          pack_pair(from_float<TO>(v0), from_float<TO>(v1));
      return;
    }
  }
  if (co < c_out) yp[co] = from_float<TO>(v0);
  if (co + 1 < c_out) yp[co + 1] = from_float<TO>(v1);
}

// Words per shared-memory row: the padding makes the row stride 4 mod 8
// words, so the 8 rows x 4 words of a fragment load fall in 32 distinct banks.
__device__ __host__ __forceinline__ int pixel_words(int c_in) { return (c_in + KPAD) / 2; }
__device__ __host__ __forceinline__ int weight_words(int c_in) { return (9 * c_in + KPAD) / 2; }

// wt[co][k], k = tap*c_in + ci contiguous, two bf16 a word: the block's
// CO_B output channels of w (9*c_in, c_out), transposed, zero past c_out.
__device__ __forceinline__ void stage_weights_mma(uint32_t* wt,
                                                  const __nv_bfloat16* __restrict__ w,
                                                  int c_in, int c_out, int co0) {
  const int kpw = weight_words(c_in);
  const int n = (9 * c_in / 2) * CO_B;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const int co = i % CO_B;
    const int kp = i / CO_B;
    const int gco = co0 + co;
    __nv_bfloat16 lo = zero, hi = zero;
    if (gco < c_out) {
      lo = w[static_cast<long long>(2 * kp) * c_out + gco];
      hi = w[static_cast<long long>(2 * kp + 1) * c_out + gco];
    }
    wt[co * kpw + kp] = pack_pair(lo, hi);
  }
}

// One tile row (this warp's) times the block's CO_B channels: for each tap
// and each 16 input channels, MF x NF mma on fragments read straight from the
// staged tile xs[pixel][ci] and the weights wt[co][k].
__device__ __forceinline__ void mma_tile(const uint32_t* xs, const uint32_t* wt,
                                         int c_in, int warp, int lane,
                                         float (&acc)[MF][NF][4]) {
  const int g = lane >> 2;
  const int t = lane & 3;
  const int cpw = pixel_words(c_in);
  const int kpw = weight_words(c_in);
  const int ksteps = c_in / 16;
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3;
    const int dx = tap - 3 * dy;
    // output (tile row `warp`, column c) reads halo'd pixel (warp + dy, c + dx)
    const uint32_t* xa = xs + ((warp + dy) * PITCH + g + dx) * cpw + t;
    const uint32_t* wk = wt + g * kpw + (tap * c_in) / 2 + t;
    for (int kc = 0; kc < ksteps; ++kc) {
      uint32_t a[MF][4];
      uint32_t b[NF][2];
#pragma unroll
      for (int mf = 0; mf < MF; ++mf) {
        const uint32_t* p = xa + mf * 16 * cpw + kc * 8;
        a[mf][0] = p[0];
        a[mf][1] = p[8 * cpw];
        a[mf][2] = p[4];
        a[mf][3] = p[8 * cpw + 4];
      }
#pragma unroll
      for (int nf = 0; nf < NF; ++nf) {
        const uint32_t* q = wk + nf * 8 * kpw + kc * 8;
        b[nf][0] = q[0];
        b[nf][1] = q[4];
      }
#pragma unroll
      for (int mf = 0; mf < MF; ++mf)
#pragma unroll
        for (int nf = 0; nf < NF; ++nf) mma_bf16_16816(acc[mf][nf], a[mf], b[nf]);
    }
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

// A block stages its weights once, then walks tiles blockIdx.x, blockIdx.x +
// gridDim.x, ...; blockIdx.y is the block of CO_B output channels.
template <typename TO>
__device__ __forceinline__ void nhwc_mma_body(
    float* smem, const __nv_bfloat16* __restrict__ x,
    const __nv_bfloat16* __restrict__ w, const float* __restrict__ bias,
    TO* __restrict__ y, int H, int W, int c_in, int c_out, int relu,
    int tiles_x, int tiles) {
  uint32_t* wt = reinterpret_cast<uint32_t*>(smem);   // CO_B * weight_words
  uint32_t* xs = wt + CO_B * weight_words(c_in);      // NPIX * pixel_words
  const int cpw = pixel_words(c_in);
  const int vpp = c_in / 8;  // 16-byte vectors per pixel
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int co0 = blockIdx.y * CO_B;
  // two neighbouring bf16 channels go out as one word when every pixel's
  // channel run starts on a word boundary
  const bool pairs = sizeof(TO) == 2 && (c_out & 1) == 0 &&
                     (reinterpret_cast<uintptr_t>(y) & 3) == 0;

  stage_weights_mma(wt, w, c_in, c_out, co0);
  float bv[NF][2];
  thread_bias(bv, bias, co0 + 2 * t, c_out);

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int ty = tile / tiles_x;
    const int row0 = ty * TH;
    const int col0 = (tile - ty * tiles_x) * TW;
    __syncthreads();  // the previous tile's reads are done
    for (int i = threadIdx.x; i < NPIX * vpp; i += THREADS) {
      const int v = i % vpp;
      const int p = i / vpp;
      const int r = row0 - 1 + p / PITCH;
      const int c = col0 - 1 + p % PITCH;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r >= 0 && r < H && c >= 0 && c < W) {
        val = *reinterpret_cast<const uint4*>(
            x + (static_cast<long long>(r) * W + c) * c_in + v * 8);
      }
      *reinterpret_cast<uint4*>(xs + p * cpw + v * 4) = val;
    }
    __syncthreads();  // the tile (and, the first time, the weights) is staged

    float acc[MF][NF][4] = {};
    mma_tile(xs, wt, c_in, warp, lane, acc);

    const int r = row0 + warp;
    if (r >= H) continue;
#pragma unroll
    for (int mf = 0; mf < MF; ++mf)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = col0 + mf * 16 + g + half * 8;
        if (c >= W) continue;
        TO* yp = y + (static_cast<long long>(r) * W + c) * c_out;
#pragma unroll
        for (int nf = 0; nf < NF; ++nf) {
          const int co = co0 + nf * 8 + 2 * t;
          float v0 = acc[mf][nf][half * 2] + bv[nf][0];
          float v1 = acc[mf][nf][half * 2 + 1] + bv[nf][1];
          if (relu) {
            v0 = fmaxf(v0, 0.0f);
            v1 = fmaxf(v1, 0.0f);
          }
          store_pair(yp, co, c_out, v0, v1, pairs);
        }
      }
  }
}

template <typename TO>
__device__ __forceinline__ void flat_mma_body(
    float* smem, const __nv_bfloat16* __restrict__ x,
    const __nv_bfloat16* __restrict__ w, const float* __restrict__ bias,
    TO* __restrict__ y, int H, int W, int wb, int margin, long long len,
    int c_in, int c_out, int relu, int tiles_x, int tiles) {
  uint32_t* wt = reinterpret_cast<uint32_t*>(smem);
  uint32_t* xs = wt + CO_B * weight_words(c_in);
  const int cpw = pixel_words(c_in);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int co0 = blockIdx.y * CO_B;
  const long long plane = static_cast<long long>(H) * wb;

  stage_weights_mma(wt, w, c_in, c_out, co0);
  float bv[NF][2];
  thread_bias(bv, bias, co0 + 2 * t, c_out);

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int ty = tile / tiles_x;
    const int row0 = ty * TH;
    const int col0 = (tile - ty * tiles_x) * TW;
    __syncthreads();
    // transpose while staging: a thread gathers 8 channels of one pixel from
    // 8 planes (lanes walk neighbouring pixels, so each plane read is
    // coalesced) and stores them as one 16-byte vector of xs[pixel][ci];
    // the padded pixel stride keeps a quarter-warp's vectors in distinct banks
    for (int i = threadIdx.x; i < NPIX * (c_in / 8); i += THREADS) {
      const int p = i % NPIX;
      const int c8 = i / NPIX;
      const long long idx = margin + static_cast<long long>(row0 + p / PITCH) * wb +
                            (col0 - 1 + p % PITCH);
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (idx >= 0 && idx < len) {
        const __nv_bfloat16* xp = x + static_cast<long long>(8 * c8) * len + idx;
        val.x = pack_pair(xp[0], xp[len]);
        val.y = pack_pair(xp[2 * len], xp[3 * len]);
        val.z = pack_pair(xp[4 * len], xp[5 * len]);
        val.w = pack_pair(xp[6 * len], xp[7 * len]);
      }
      *reinterpret_cast<uint4*>(xs + p * cpw + c8 * 4) = val;
    }
    __syncthreads();

    float acc[MF][NF][4] = {};
    mma_tile(xs, wt, c_in, warp, lane, acc);

    const int r = row0 + warp;
    if (r >= H) continue;
#pragma unroll
    for (int mf = 0; mf < MF; ++mf)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = col0 + mf * 16 + g + half * 8;
        if (c >= wb) continue;
        const bool pixel = c >= 1 && c <= W;
        const long long n = static_cast<long long>(r) * wb + c;
#pragma unroll
        for (int nf = 0; nf < NF; ++nf)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int co = co0 + nf * 8 + 2 * t + e;
            if (co < c_out) {
              float v = acc[mf][nf][half * 2 + e] + bv[nf][e];
              if (relu) v = fmaxf(v, 0.0f);
              y[co * plane + n] = from_float<TO>(pixel ? v : 0.0f);
            }
          }
      }
  }
}

// ---------------------------------------------------------------------------
// the two kernels
// ---------------------------------------------------------------------------

template <typename TI, typename TO, bool MMA>
__global__ void __launch_bounds__(THREADS)
    conv3x3_nhwc_kernel(const TI* __restrict__ x, const TI* __restrict__ w,
                        const float* __restrict__ bias, TO* __restrict__ y,
                        int H, int W, int c_in, int c_out, int ci_blk, int relu,
                        int tiles_x, int tiles) {
  extern __shared__ __align__(16) float smem[];
  if constexpr (MMA) {
    nhwc_mma_body<TO>(smem, x, w, bias, y, H, W, c_in, c_out, relu, tiles_x, tiles);
  } else {
    nhwc_simt_body<TI, TO>(smem, x, w, bias, y, H, W, c_in, c_out, ci_blk, relu);
  }
}

template <typename TI, typename TO, bool MMA>
__global__ void __launch_bounds__(THREADS)
    conv3x3_flat_chw_kernel(const TI* __restrict__ x, const TI* __restrict__ w,
                            const float* __restrict__ bias, TO* __restrict__ y,
                            int H, int W, int wb, int margin, long long len,
                            int c_in, int c_out, int ci_blk, int relu,
                            int tiles_x, int tiles) {
  extern __shared__ __align__(16) float smem[];
  if constexpr (MMA) {
    flat_mma_body<TO>(smem, x, w, bias, y, H, W, wb, margin, len, c_in, c_out,
                      relu, tiles_x, tiles);
  } else {
    flat_simt_body<TI, TO>(smem, x, w, bias, y, H, W, wb, margin, len, c_in,
                           c_out, ci_blk, relu);
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

inline int chunk_of(int c_in) { return c_in < CI_MAX ? c_in : CI_MAX; }

inline size_t simt_bytes(int ci_blk) {
  return sizeof(float) * (static_cast<size_t>(9) * ci_blk * CO_B +
                          static_cast<size_t>(ci_blk) * PLANE);
}

inline size_t mma_bytes(int c_in) {
  return sizeof(uint32_t) * (static_cast<size_t>(CO_B) * weight_words(c_in) +
                             static_cast<size_t>(NPIX) * pixel_words(c_in));
}

// The tensor-core body takes bf16 input whose channels fill whole k = 16
// steps and whose block of weights fits the shared memory a block may ask
// for; `vectors` says whether it will copy 16-byte vectors from x.
inline bool mma_applies(int c_in, const void* x, bool vectors) {
  if (c_in % 16 != 0) return false;
  if (vectors && (reinterpret_cast<uintptr_t>(x) & 15) != 0) return false;
  int dev = 0, limit = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess) {
    return false;
  }
  return mma_bytes(c_in) <= static_cast<size_t>(limit);
}

// More than 48 KB of dynamic shared memory needs the opt-in attribute; its
// refusal is returned, never swallowed.
template <typename K>
int allow_smem(K kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

// Blocks of a persistent grid: as many as the card holds at once, at most
// one per tile. Returns a cudaError_t, the count in *blocks.
template <typename K>
int resident_blocks(K kernel, size_t bytes, int tiles, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  const long long resident = static_cast<long long>(sms) * per_sm;
  *blocks = static_cast<int>(resident < tiles ? resident : tiles);
  return 0;
}

template <typename TI, typename TO>
int launch_nhwc(const void* x, const void* w, const float* bias, void* y, int H,
                int W, int c_in, int c_out, int relu, cudaStream_t stream) {
  const int tiles_x = (W + TW - 1) / TW;
  const int tiles_y = (H + TH - 1) / TH;
  const int co_blocks = (c_out + CO_B - 1) / CO_B;
  if constexpr (sizeof(TI) == 2) {
    if (mma_applies(c_in, x, true)) {
      auto kernel = conv3x3_nhwc_kernel<TI, TO, true>;
      const size_t bytes = mma_bytes(c_in);
      int rc = allow_smem(kernel, bytes);
      if (rc != 0) return rc;
      const long long tiles = static_cast<long long>(tiles_x) * tiles_y;
      if (tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
      int blocks = 0;
      rc = resident_blocks(kernel, bytes, static_cast<int>(tiles), &blocks);
      if (rc != 0) return rc;
      kernel<<<dim3(blocks, co_blocks), THREADS, bytes, stream>>>(
          static_cast<const TI*>(x), static_cast<const TI*>(w), bias,
          static_cast<TO*>(y), H, W, c_in, c_out, 0, relu, tiles_x,
          static_cast<int>(tiles));
      return static_cast<int>(cudaGetLastError());
    }
  }
  const int ci_blk = chunk_of(c_in);
  const size_t bytes = simt_bytes(ci_blk);
  auto kernel = conv3x3_nhwc_kernel<TI, TO, false>;
  const int rc = allow_smem(kernel, bytes);
  if (rc != 0) return rc;
  kernel<<<dim3(tiles_x, tiles_y, co_blocks), THREADS, bytes, stream>>>(
      static_cast<const TI*>(x), static_cast<const TI*>(w), bias,
      static_cast<TO*>(y), H, W, c_in, c_out, ci_blk, relu, 0, 0);
  return static_cast<int>(cudaGetLastError());
}

template <typename TI, typename TO>
int launch_flat(const void* x, const void* w, const float* bias, void* y, int H,
                int W, int wb, int margin, int c_in, int c_out, int relu,
                cudaStream_t stream) {
  const int tiles_x = (wb + TW - 1) / TW;
  const int tiles_y = (H + TH - 1) / TH;
  const int co_blocks = (c_out + CO_B - 1) / CO_B;
  const long long len = margin + static_cast<long long>(H + 16) * wb;
  if constexpr (sizeof(TI) == 2) {
    if (mma_applies(c_in, x, false)) {
      auto kernel = conv3x3_flat_chw_kernel<TI, TO, true>;
      const size_t bytes = mma_bytes(c_in);
      int rc = allow_smem(kernel, bytes);
      if (rc != 0) return rc;
      const long long tiles = static_cast<long long>(tiles_x) * tiles_y;
      if (tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
      int blocks = 0;
      rc = resident_blocks(kernel, bytes, static_cast<int>(tiles), &blocks);
      if (rc != 0) return rc;
      kernel<<<dim3(blocks, co_blocks), THREADS, bytes, stream>>>(
          static_cast<const TI*>(x), static_cast<const TI*>(w), bias,
          static_cast<TO*>(y), H, W, wb, margin, len, c_in, c_out, 0, relu,
          tiles_x, static_cast<int>(tiles));
      return static_cast<int>(cudaGetLastError());
    }
  }
  const int ci_blk = chunk_of(c_in);
  const size_t bytes = simt_bytes(ci_blk);
  auto kernel = conv3x3_flat_chw_kernel<TI, TO, false>;
  const int rc = allow_smem(kernel, bytes);
  if (rc != 0) return rc;
  kernel<<<dim3(tiles_x, tiles_y, co_blocks), THREADS, bytes, stream>>>(
      static_cast<const TI*>(x), static_cast<const TI*>(w), bias,
      static_cast<TO*>(y), H, W, wb, margin, len, c_in, c_out, ci_blk, relu, 0, 0);
  return static_cast<int>(cudaGetLastError());
}

inline bool sizes_ok(int H, int W, int c_in, int c_out) {
  return H > 0 && W > 0 && c_in > 0 && c_out > 0 &&
         (H + TH - 1) / TH <= 65535 && (c_out + CO_B - 1) / CO_B <= 65535;
}

}  // namespace

// Element types: 0 = float32, 1 = bfloat16. x and w share in_type; bias is
// f32. Each function launches on `stream` and returns a cudaError_t
// (0 = launched): cudaErrorInvalidValue for sizes or types it does not take.

extern "C" int seq_conv3x3_nhwc(const void* x, const void* w, const float* bias,
                                void* y, int H, int W, int c_in, int c_out,
                                int relu, int in_type, int out_type,
                                void* stream) {
  if (!sizes_ok(H, W, c_in, c_out)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_type == 0 && out_type == 0)
    return launch_nhwc<float, float>(x, w, bias, y, H, W, c_in, c_out, relu, s);
  if (in_type == 0 && out_type == 1)
    return launch_nhwc<float, __nv_bfloat16>(x, w, bias, y, H, W, c_in, c_out, relu, s);
  if (in_type == 1 && out_type == 0)
    return launch_nhwc<__nv_bfloat16, float>(x, w, bias, y, H, W, c_in, c_out, relu, s);
  if (in_type == 1 && out_type == 1)
    return launch_nhwc<__nv_bfloat16, __nv_bfloat16>(x, w, bias, y, H, W, c_in, c_out, relu, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int seq_conv3x3_flat_chw(const void* x, const void* w,
                                    const float* bias, void* y, int H, int W,
                                    int wb, int margin, int c_in, int c_out,
                                    int relu, int in_type, int out_type,
                                    void* stream) {
  if (!sizes_ok(H, W, c_in, c_out) || wb < W + 2 || margin < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_type == 0 && out_type == 0)
    return launch_flat<float, float>(x, w, bias, y, H, W, wb, margin, c_in, c_out, relu, s);
  if (in_type == 0 && out_type == 1)
    return launch_flat<float, __nv_bfloat16>(x, w, bias, y, H, W, wb, margin, c_in, c_out, relu, s);
  if (in_type == 1 && out_type == 0)
    return launch_flat<__nv_bfloat16, float>(x, w, bias, y, H, W, wb, margin, c_in, c_out, relu, s);
  if (in_type == 1 && out_type == 1)
    return launch_flat<__nv_bfloat16, __nv_bfloat16>(x, w, bias, y, H, W, wb, margin, c_in, c_out, relu, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
