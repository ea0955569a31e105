// Int8 convolution with int32 accumulation, for Hopper (sm_90a): the convs of
// the U-Net's post-training-quantized forward (studies/ptq_unet.py) and of the
// int8 conv study (studies/int8_conv.py).
//
// No TPU kernel is ported here: the JAX package runs these convs through XLA
// (jax.lax.conv_general_dilated / conv_transpose with
// preferred_element_type=int32, sequitr_tpu/studies/int8_conv.py::_conv and
// sequitr_tpu/studies/ptq_unet.py::_qconv), and PyTorch has no int8
// convolution on CUDA to map them to.
//
// What it computes. x: int8 channels-last (N, [D,] H, W, C_in); w: int8
// ([k,] k, k, C_in, C_out), the JAX package's HWIO (DHWIO) layout; dims 2 or 3.
//   mode 0: the k = 3 SAME stride-1 conv (zero padding);
//   mode 1: the k = 1 conv;
//   mode 2: the k = 2 stride-2 VALID transposed conv of the JAX call
//           conv_transpose(x, swapaxes(w, -1, -2), strides=2, "VALID",
//           transpose_kernel=True): the kernel's flip and its transposition
//           cancel, so output pixel 2i + a (on every axis) is
//           sum_c x[i, c] * w[a, c, o].
// Sums are exact int32 (|sum| <= 27 * C_in * 128^2 < 2^31 for C_in <= 4854).
// Epilogues, per output channel o:
//   0 raw:      the int32 sum;
//   1 dequant:  f32 (float(acc) * scale[o]) + bias[o], the product and the
//               sum each rounded on its own (__fmul_rn / __fadd_rn; built with
//               -fmad=false besides), then max(., 0) when relu;
//   2 requant:  the dequant value (relu as asked), times inv_next, rounded
//               half to even and clipped to [-127, 127], as int8.
// The JAX package's ptq_unet.apply rounds at the same points, so the f32
// outputs are bit-equal to its (and to the plain version in
// ops/kernels/qconv.py).
//
// Bound on an H100 SXM: the int8 rate is 1979 TOPS dense, the memory 3.35
// TB/s. At the U-Net's widths the shapes are bound by their bytes (enc0b at
// 1024^2, 32 -> 32: 33.5 MB in, 134.2 MB of int32 out, 0.050 ms; 19.3 G
// operations, 0.0098 ms), the widest (enc3, 256 -> 256 at 128^2) by its
// operations.
//
// Design: simple and right first. The reduction over C_in runs four channels
// at a time through __dp4a (a 4-way int8 dot product into int32) on the CUDA
// cores, not the tensor cores: its rate (one dp4a a lane a cycle at most) is
// far below the int8 tensor-core rate, so every layer is bound by the
// arithmetic here, far above the bound (PERF.md section 6, row 5). The
// weights come packed (ops/kernels/qconv.py::pack_weights, once a weight) in
// 32-bit words of four input channels, [tap][C_in / 4][C_out rounded up to
// 16], zero-filled; one launch gives each thread one output pixel and 16
// output channels (16 int32 sums in registers), reads the pixel's
// four-channel words (L1 serves the neighbours' reuse of a tap), reads the
// packed weights as four 16-byte loads that every lane of a warp shares, and
// writes its 16 outputs. C_in not a multiple of 4 (C_in = 1 at the U-Net's
// first conv, odd widths) assembles each word from single bytes, the missing
// channels zero.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // output pixels a block
constexpr int kOutTile = 16;   // output channels a thread

enum Mode { kSame3 = 0, kOne = 1, kUp2 = 2 };
enum Epilogue { kRaw = 0, kDequant = 1, kRequant = 2 };

int taps_of(int mode, int dims) {
  const int k = mode == kSame3 ? 3 : (mode == kOne ? 1 : 2);
  return dims == 3 ? k * k * k : k * k;
}

int round_up(int v, int m) { return (v + m - 1) / m * m; }

struct Shape {
  int n, d, h, w;        // input
  int od, oh, ow;        // output
  int c_in, c_out, groups, c_out_pad, dims;
};

struct Out {
  void* y;
  const float* scale;
  const float* bias;
  float inv_next;
  int epilogue, relu;
};

// The four input channels 4g .. 4g + 3 of the pixel at `px` (an offset in
// pixels), channel 4g in the low byte, zero beyond C_in.
template <bool kAligned>
__device__ __forceinline__ int32_t x_word(const int8_t* __restrict__ x, long long px, int g, int c_in) {
  const int8_t* p = x + px * c_in + 4 * g;
  if (kAligned) return __ldg(reinterpret_cast<const int32_t*>(p));
  uint32_t word = 0;
  for (int k = 0; k < 4; ++k) {
    if (4 * g + k < c_in) word |= static_cast<uint32_t>(static_cast<uint8_t>(__ldg(p + k))) << (8 * k);
  }
  return static_cast<int32_t>(word);
}

// Add tap t of input pixel px into acc (16 output channels from o0).
template <bool kAligned>
__device__ __forceinline__ void accumulate(int32_t (&acc)[kOutTile], const int8_t* __restrict__ x,
                                           const int32_t* __restrict__ wp, long long px, int t, int o0,
                                           const Shape& s) {
  for (int g = 0; g < s.groups; ++g) {
    const int32_t xv = x_word<kAligned>(x, px, g, s.c_in);
    const int4* wv = reinterpret_cast<const int4*>(wp + (static_cast<long long>(t) * s.groups + g) * s.c_out_pad + o0);
#pragma unroll
    for (int q = 0; q < kOutTile / 4; ++q) {
      const int4 w4 = __ldg(wv + q);
      acc[4 * q + 0] = __dp4a(xv, w4.x, acc[4 * q + 0]);
      acc[4 * q + 1] = __dp4a(xv, w4.y, acc[4 * q + 1]);
      acc[4 * q + 2] = __dp4a(xv, w4.z, acc[4 * q + 2]);
      acc[4 * q + 3] = __dp4a(xv, w4.w, acc[4 * q + 3]);
    }
  }
}

__device__ __forceinline__ float dequant(int32_t acc, float scale, float bias, int relu) {
  const float v = __fadd_rn(__fmul_rn(__int2float_rn(acc), scale), bias);
  return relu && v < 0.0f ? 0.0f : v;
}

template <int kMode, bool kAligned>
__global__ void __launch_bounds__(kThreads) qconv_kernel(const int8_t* __restrict__ x,
                                                         const int32_t* __restrict__ wp, Shape s, Out out) {
  const long long p = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long n_out = static_cast<long long>(s.n) * s.od * s.oh * s.ow;
  if (p >= n_out) return;
  const int o0 = blockIdx.y * kOutTile;
  const int ox = static_cast<int>(p % s.ow);
  const int oy = static_cast<int>((p / s.ow) % s.oh);
  const int oz = static_cast<int>((p / (static_cast<long long>(s.ow) * s.oh)) % s.od);
  const long long n = p / (static_cast<long long>(s.ow) * s.oh * s.od);
  const long long plane = static_cast<long long>(s.h) * s.w;
  int32_t acc[kOutTile];
#pragma unroll
  for (int j = 0; j < kOutTile; ++j) acc[j] = 0;

  if (kMode == kSame3) {
    const int dz_lo = s.dims == 3 ? -1 : 0, dz_hi = s.dims == 3 ? 1 : 0;
    for (int dz = dz_lo; dz <= dz_hi; ++dz) {
      const int iz = oz + dz;
      if (iz < 0 || iz >= s.d) continue;
      for (int dy = -1; dy <= 1; ++dy) {
        const int iy = oy + dy;
        if (iy < 0 || iy >= s.h) continue;
        for (int dx = -1; dx <= 1; ++dx) {
          const int ix = ox + dx;
          if (ix < 0 || ix >= s.w) continue;
          const int t = ((dz - dz_lo) * 3 + dy + 1) * 3 + dx + 1;
          const long long px = (n * s.d + iz) * plane + static_cast<long long>(iy) * s.w + ix;
          accumulate<kAligned>(acc, x, wp, px, t, o0, s);
        }
      }
    }
  } else if (kMode == kOne) {
    accumulate<kAligned>(acc, x, wp, p, 0, o0, s);
  } else {
    // transposed k = 2, stride 2: one tap, chosen by the output's parities
    const int iz = s.dims == 3 ? oz >> 1 : oz;
    const int t = ((s.dims == 3 ? (oz & 1) * 2 : 0) + (oy & 1)) * 2 + (ox & 1);
    const long long px = (n * s.d + iz) * plane + static_cast<long long>(oy >> 1) * s.w + (ox >> 1);
    accumulate<kAligned>(acc, x, wp, px, t, o0, s);
  }

  const long long base = p * s.c_out;
  if (out.epilogue == kRaw) {
    int32_t* y = static_cast<int32_t*>(out.y) + base;
#pragma unroll
    for (int j = 0; j < kOutTile; ++j) {
      if (o0 + j < s.c_out) y[o0 + j] = acc[j];
    }
  } else if (out.epilogue == kDequant) {
    float* y = static_cast<float*>(out.y) + base;
#pragma unroll
    for (int j = 0; j < kOutTile; ++j) {
      const int o = o0 + j;
      if (o < s.c_out) y[o] = dequant(acc[j], out.scale[o], out.bias[o], out.relu);
    }
  } else {
    int8_t* y = static_cast<int8_t*>(out.y) + base;
#pragma unroll
    for (int j = 0; j < kOutTile; ++j) {
      const int o = o0 + j;
      if (o < s.c_out) {
        const float v = dequant(acc[j], out.scale[o], out.bias[o], out.relu);
        int q = __float2int_rn(__fmul_rn(v, out.inv_next));
        q = q > 127 ? 127 : (q < -127 ? -127 : q);
        y[o] = static_cast<int8_t>(q);
      }
    }
  }
}

template <typename... Params, typename... Args>
int launch(void (*kernel)(Params...), dim3 grid, int threads, void* stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = nullptr;
  cfg.numAttrs = 0;
  const cudaError_t rc = cudaLaunchKernelEx(&cfg, kernel, args...);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(rc != cudaSuccess ? rc : last);
}

template <int kMode>
int launch_conv(bool aligned, dim3 grid, void* stream, const int8_t* x, const int32_t* wp, const Shape& s,
                const Out& out) {
  return aligned ? launch(qconv_kernel<kMode, true>, grid, kThreads, stream, x, wp, s, out)
                 : launch(qconv_kernel<kMode, false>, grid, kThreads, stream, x, wp, s, out);
}

}  // namespace

// 32-bit words of the packed weights seq_qconv takes for a conv of this
// mode, rank and width: taps * ceil(c_in / 4) * (c_out rounded up to 16),
// word (t * groups + g) * c_out_pad + o holding channels 4g .. 4g + 3 of tap
// t and output o, channel 4g in the low byte, zero beyond c_in and c_out;
// -1 for arguments it refuses.
extern "C" long long seq_qconv_packed_words(int mode, int dims, int c_in, int c_out) {
  if (mode < 0 || mode > 2 || (dims != 2 && dims != 3) || c_in < 1 || c_out < 1) return -1;
  return static_cast<long long>(taps_of(mode, dims)) * ((c_in + 3) / 4) * round_up(c_out, kOutTile);
}

// x: int8 (n, [d,] h, w, c_in) contiguous, 4-byte aligned; wp: the packed
// weights (seq_qconv_packed_words int32), 16-byte aligned; scale, bias:
// (c_out,) f32 for epilogues 1 and 2 (else unused); y: (n, [od,] oh, ow,
// c_out) of int32 / f32 / int8 by the epilogue. 2D takes d = 1. One launch
// on `stream`; returns its CUDA error (0: launched).
extern "C" int seq_qconv(const int8_t* x, const int32_t* wp, const float* scale, const float* bias, void* y,
                         int n, int d, int h, int wd, int c_in, int c_out, int dims, int mode, int epilogue,
                         int relu, float inv_next, void* stream) {
  if (seq_qconv_packed_words(mode, dims, c_in, c_out) < 0 || n < 1 || d < 1 || h < 1 || wd < 1 ||
      (dims == 2 && d != 1) || epilogue < 0 || epilogue > 2 ||
      (epilogue != kRaw && (scale == nullptr || bias == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int up = mode == kUp2 ? 2 : 1;
  Shape s = {n, d, h, wd, dims == 3 ? d * up : 1, h * up, wd * up, c_in, c_out, (c_in + 3) / 4,
             round_up(c_out, kOutTile), dims};
  const long long n_out = static_cast<long long>(n) * s.od * s.oh * s.ow;
  const long long pixel_blocks = (n_out + kThreads - 1) / kThreads;
  if (pixel_blocks >= (1LL << 31) || s.c_out_pad / kOutTile > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Out out = {y, scale, bias, inv_next, epilogue, relu};
  const dim3 grid(static_cast<unsigned>(pixel_blocks), static_cast<unsigned>(s.c_out_pad / kOutTile));
  const bool aligned = c_in % 4 == 0;
  if (mode == kSame3) return launch_conv<kSame3>(aligned, grid, stream, x, wp, s, out);
  if (mode == kOne) return launch_conv<kOne>(aligned, grid, stream, x, wp, s, out);
  return launch_conv<kUp2>(aligned, grid, stream, x, wp, s, out);
}
