// Euler integration of a flow field, for Hopper (sm_90a): every foreground
// pixel follows the field for n_iter steps in one launch, its position in
// registers from the first step to the last.
//
// Replaces no Pallas kernel: the JAX package runs the loop as a lax.scan
// (sequitr_tpu/ops/flows.py::follow_flows), and the port's plain version,
// ops/flows.py::follow_flows_reference, as about 28 eager launches a step
// over every pixel (~5,600 a frame at 200 steps).
//
// What it computes, for a field flow of (H, W, 2) or (Z, H, W, 3) f32 and a
// mask of (H, W) or (Z, H, W) bytes (or none: every pixel is foreground):
// the final position of each pixel after n_iter steps of
//   x   = clamp(p, 0, n - 1);  x0 = clamp(floor(x), 0, max(n - 2, 0));
//   f   = x - x0                                   (each axis)
//   w_c = product over the axes, in axis order, of 1 - f or f
//   v   = sum over the 2^nd corners c, in itertools.product((0, 1)) order,
//         of g_c * w_c, added left to right
//   p   = min(max(p + step * v, 0), n - 1)
// where g_c is the flow at corner c times the mask there as f32 (the +1
// neighbour edge-clamped, as _shift_axis_next makes it). Every operation
// rounds on its own, as the eager loop's kernels do (no FMA: -fmad=false,
// and the _rn intrinsics), and the clamps are comparisons, so a NaN passes
// as torch.clamp and torch.minimum pass it. The positions are bit-equal to
// the plain version's on the card for every finite field.
//
// The one difference: a background pixel (mask false) writes its own
// coordinate and stops. In the eager loop it samples its own corner, masked
// to zero, with weight 1 and every other corner with weight 0, so it stays
// exactly where it starts, unless a corner holds inf or NaN (0 * inf): there
// the eager loop moves it and this kernel does not.
//
// Bound: 200 dependent gathers per foreground pixel. Each step's four (2D)
// or eight (3D) corner loads hang on the position the step before wrote, so
// the kernel is bound by the latency of L1 and L2 (the 8 MB field of a
// 1024x1024 frame stays in the 50 MB L2), not by bandwidth or FLOPs: a cell
// covers ~2.3% of a frame, ~24k active threads, a handful of warps an SM.
// The roofline that euler_roofline uses counts 32 FLOP a foreground
// pixel-step at the f32 peak, or 1 B a pixel (the mask) and 16 B a
// foreground pixel (its flow in, its position out) at the HBM bandwidth,
// whichever is longer.
//
// Design:
//   * One thread a pixel. A background pixel costs a 1-byte load and its
//     output; only the foreground steps, so the work follows the cells.
//   * Each warp covers an 8x4 patch of a plane (a block of 8 warps 32x8
//     pixels, one plane of a volume a grid row in z), so that a cell's pixels
//     share warps and a warp's lanes converge to the same few sinks, whose
//     corners then sit in the same L1 lines.
//   * A corner's flow is one 8-byte load in 2D (three 4-byte loads in 3D,
//     adjacent), through the read-only path; its mask one byte. Nothing is
//     packed or staged: the 2^nd * nd corner rows the eager loop gathers from
//     would be 32 MB a frame.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps: 4 patches of 8x4 across, 2 down
constexpr int kTileX = 32;
constexpr int kTileY = 8;

// torch.clamp(v, lo, hi): NaN passes
__device__ __forceinline__ float clamp_to(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

template <int ND>
struct Field {
  int n[ND];  // the spatial shape, in axis order
};

template <int ND>
__device__ __forceinline__ void load_flow(const float* __restrict__ flow, long long pix, float* g) {
  if constexpr (ND == 2) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(flow) + pix);
    g[0] = v.x;
    g[1] = v.y;
  } else {
#pragma unroll
    for (int a = 0; a < ND; ++a) g[a] = __ldg(flow + pix * ND + a);
  }
}

template <int ND>
__global__ void __launch_bounds__(kThreads) euler_kernel(const float* __restrict__ flow,
                                                         const unsigned char* __restrict__ mask,
                                                         Field<ND> s, int n_iter, float step,
                                                         float* __restrict__ out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int x = blockIdx.x * kTileX + (warp & 3) * 8 + (lane & 7);
  const int y = blockIdx.y * kTileY + (warp >> 2) * 4 + (lane >> 3);
  const int w = s.n[ND - 1], h = s.n[ND - 2];
  if (x >= w || y >= h) return;
  const long long pix = (static_cast<long long>(blockIdx.z) * h + y) * w + x;
  float p[ND];
  p[ND - 1] = static_cast<float>(x);
  p[ND - 2] = static_cast<float>(y);
  if constexpr (ND == 3) p[0] = static_cast<float>(blockIdx.z);

  if (mask == nullptr || __ldg(mask + pix)) {
    float lim[ND], top[ND];
#pragma unroll
    for (int a = 0; a < ND; ++a) {
      lim[a] = static_cast<float>(s.n[a] - 1);
      top[a] = static_cast<float>(s.n[a] > 2 ? s.n[a] - 2 : 0);
    }
    for (int it = 0; it < n_iter; ++it) {
      int base[ND];
      float wt[ND][2];
#pragma unroll
      for (int a = 0; a < ND; ++a) {
        const float xa = clamp_to(p[a], 0.0f, lim[a]);
        const float x0 = clamp_to(floorf(xa), 0.0f, top[a]);
        const float f = __fsub_rn(xa, x0);
        base[a] = x0 > 0.0f ? static_cast<int>(x0) : 0;  // a NaN position reads corner 0
        wt[a][0] = __fsub_rn(1.0f, f);
        wt[a][1] = f;
      }
      float v[ND];
#pragma unroll
      for (int c = 0; c < (1 << ND); ++c) {
        long long at = 0;
        float wc = 0.0f;
#pragma unroll
        for (int a = 0; a < ND; ++a) {
          const int o = (c >> (ND - 1 - a)) & 1;
          const int i = min(base[a] + o, s.n[a] - 1);
          at = at * s.n[a] + i;
          wc = a == 0 ? wt[0][o] : __fmul_rn(wc, wt[a][o]);
        }
        float g[ND];
        load_flow<ND>(flow, at, g);
        const float m = mask == nullptr ? 1.0f : (__ldg(mask + at) ? 1.0f : 0.0f);
#pragma unroll
        for (int a = 0; a < ND; ++a) {
          const float gw = __fmul_rn(mask == nullptr ? g[a] : __fmul_rn(g[a], m), wc);
          v[a] = c == 0 ? gw : __fadd_rn(v[a], gw);
        }
      }
#pragma unroll
      for (int a = 0; a < ND; ++a) {
        const float t = __fadd_rn(p[a], __fmul_rn(step, v[a]));
        const float lo = t < 0.0f ? 0.0f : t;  // clamp_min(0.0)
        p[a] = lo > lim[a] ? lim[a] : lo;      // torch.minimum(., lim)
      }
    }
  }
#pragma unroll
  for (int a = 0; a < ND; ++a) out[pix * ND + a] = p[a];
}

template <int ND>
int launch(const float* flow, const unsigned char* mask, const Field<ND>& s, int planes, int n_iter,
           float step, float* out, void* stream) {
  cudaLaunchConfig_t cfg = {};
  const int w = s.n[ND - 1], h = s.n[ND - 2];
  cfg.gridDim = dim3((w + kTileX - 1) / kTileX, (h + kTileY - 1) / kTileY, planes);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = nullptr;
  cfg.numAttrs = 0;
  const cudaError_t rc = cudaLaunchKernelEx(&cfg, euler_kernel<ND>, flow, mask, s, n_iter, step, out);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(rc != cudaSuccess ? rc : last);
}

}  // namespace

// flow: (z, h, w, nd) f32, contiguous (z = 1 for nd = 2), 8-byte aligned;
// mask: (z, h, w) bytes, 0 background, or null (every pixel foreground).
// Writes out (z, h, w, nd) f32, every pixel's final position. One launch on
// `stream`; returns its CUDA error (0: launched).
extern "C" int seq_follow_flows(const float* flow, const unsigned char* mask, int nd, int z, int h,
                                int w, int n_iter, float step, float* out, void* stream) {
  const bool shape_ok = z > 0 && h > 0 && w > 0 && (nd == 3 || z == 1) &&
                        (h + kTileY - 1) / kTileY <= 65535 && z <= 65535;
  if (flow == nullptr || out == nullptr || (nd != 2 && nd != 3) || !shape_ok || n_iter < 0 ||
      (reinterpret_cast<uintptr_t>(flow) & 7) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nd == 2) return launch<2>(flow, mask, Field<2>{{h, w}}, 1, n_iter, step, out, stream);
  return launch<3>(flow, mask, Field<3>{{z, h, w}}, z, n_iter, step, out, stream);
}
