// Quantile pass of the percentile normalize, for Hopper (sm_90a): per slice
// min and max, a fixed-bin count histogram and the inversion of its CDF, on
// the device, for all slices of a call in two launches.
//
// Replaces the Pallas TPU kernel sequitr_tpu/ops/pallas/histogram.py::_hist_kernel
// (reached through histogram_2d) and the work pallas_quantiles does around it
// (min and max before it, CDF inversion after it). For each of S slices of an
// (S, n) f32 array, given bins and up to 8 values of q:
//   lo, hi = min and max of the slice;
//   scale  = (bins - 1) / max(hi - lo, 1e-20), one correctly rounded division;
//   counts = histogram with bucket int(clip((x - lo) * scale, 0, bins - 1)),
//            the subtract and the multiply each rounded (no FMA; -fmad=false);
//   for each q, the first bin k with cum[k] / n >= q (bin 0 if none), at the
//   edge (lo + (k + 1) / scale) - 0.5 / scale, each division rounded once.
// Every step rounds where the JAX package rounds, so the quantiles are
// bit-equal to pallas_quantiles' (counts are exact integers to 2^31 a bin;
// the TPU kernel's f32 counts and cumsum are exact to 2^24 pixels a slice).
// A second entry point, seq_histogram_f32, is the counterpart of the TPU
// histogram_2d: the same counting launch with lo and scale given.
//
// Bound: each f32 pixel read once, the counts and quantiles written once:
// 4 bytes a pixel, a 1024x1024 frame = 4.19 MB / 3.35 TB/s = 1.25 us on an
// H100 SXM. The arithmetic (a compare pair, a subtract, a multiply and a
// clamp pair a pixel) is far below the f32 rate. At one frame the fixed
// costs are what count: launches, a pass over the frame, the merge of the
// blocks' bins, the serial tail that inverts the CDF.
//
// Design, and what each choice answers (times: studies/normalize_pass.py
// --parts on an H100, recorded in PERF.md):
//   * Two launches, each finished by its last block (design (a)). min/max
//     must be known before any pixel is counted, and blocks cannot wait for
//     each other without co-residency. minmax_kernel reduces each block's
//     share to two atomics on ordered integer keys; count_kernel is launched
//     with programmatic dependent launch (cudaLaunchKernelEx,
//     griddepcontrol): minmax_kernel lets it start at once, and its blocks
//     load their first pixels and zero their bins while the first launch
//     runs, then wait (griddepcontrol.wait) before they read min and max.
//     The second pass over the slice reads it from L2 (a 4 MiB frame in a
//     50 MB cache), so the frame leaves device memory once.
//   * No zero-fill launch and no host sync. Blocks add their bins into
//     per-slice accumulators in device memory that every call leaves zeroed.
//     The block that finishes last for its slice finds itself by a barrier
//     and one acquire-release atomic ticket; it copies the counts out,
//     inverts the CDF, and zeroes the accumulators, the ticket and the
//     min/max keys. The wrapper keeps that scratch per device and stream,
//     made once with torch.zeros. The keys are ordered so that 0 is below
//     every float and min and max are both an atomicMax on unsigned ints.
//   * Fill the card, few blocks to merge: one block of 512 threads an SM
//     over all slices (one 1024x1024 frame: 132 blocks); each thread issues
//     four 16-byte loads before it counts them (4.3 MB in flight over the
//     card, the whole frame). Two blocks of 256 an SM took 0.0012 ms more:
//     the merge grows with the blocks. The grid is (blocks per slice,
//     slices); a slice's unaligned head and ragged tail (fewer than 4
//     floats each) are counted one by one, the rest by float4.
//   * The merge: each block adds its non-zero bins to one of 4 accumulator
//     copies (block b to copy b % 4), starting its sweep at another line,
//     so that the additions of blocks that finish together spread over
//     L2's slices (one copy took 0.0009 ms more). A block counts into one
//     shared-memory histogram (4 KB at 1024 bins) with plain atomics:
//     merging runs of equal bins cost more in divergence than it saved,
//     even on a flat background.
//   * Deterministic results: the counts are integers; the inversion runs in
//     the last block over finished counts, in a fixed order (a block scan).
//   * NaN pixels are not supported (min/max skip them; the bucket of a NaN is
//     0), as the JAX package's results for them are NaN.
//
// Switches for studies/normalize_pass.py --parts, which times builds with
// parts left out (their results are wrong by design): HISTOGRAM_EMPTY (both
// kernels return at once), HISTOGRAM_WITHOUT_COUNT (pixels loaded, not
// counted), HISTOGRAM_WITHOUT_MERGE (no block adds to the accumulator),
// HISTOGRAM_WITHOUT_TAIL (no last block: nothing is written or zeroed),
// HISTOGRAM_WITHOUT_TICKET (no ticket taken, no last block);
// and HISTOGRAM_THREADS, HISTOGRAM_BLOCKS_PER_SM, HISTOGRAM_COPIES for other
// block shapes, grids and accumulators.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// --- PTX operations (each a function of its own: the rehearsal on the CPU
// replaces this block with their emulation) ---
// Wait until the launch this one depends on has finished and its writes are
// visible; a no-op for a launch made without programmatic serialization.
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}
// Let the launch that depends on this one start before this one ends.
__device__ __forceinline__ void allow_dependent_launch() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}
// Add one to a ticket and return its old value, with release and acquire
// semantics at the scope of the device: what the block wrote before (the
// block barrier makes it this thread's) is visible to whoever takes a later
// ticket, and what those before wrote is visible to this one.
__device__ __forceinline__ unsigned take_ticket(unsigned* ticket) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;" : "=r"(old) : "l"(ticket) : "memory");
  return old;
}
// --- end of the PTX operations ---

namespace {

#ifndef HISTOGRAM_THREADS
#define HISTOGRAM_THREADS 512
#endif
#ifndef HISTOGRAM_BLOCKS_PER_SM
#define HISTOGRAM_BLOCKS_PER_SM 1
#endif
#ifndef HISTOGRAM_COPIES
#define HISTOGRAM_COPIES 4
#endif
constexpr int kThreads = HISTOGRAM_THREADS;
constexpr int kWarps = kThreads / 32;
constexpr int kLoads = 4;  // float4 loads a thread issues before it counts
constexpr int kMaxQs = 8;
constexpr int kMaxBins = 8192;
constexpr int kBlocksPerSm = HISTOGRAM_BLOCKS_PER_SM;
constexpr int kCopies = HISTOGRAM_COPIES;  // accumulators a slice

struct Qs {
  float q[kMaxQs];
};

// The scratch, all zero between calls: [accumulators S x kCopies x bins]
// [ticket S][min key S][max key S] as 32-bit words.
struct Scratch {
  int* acc;
  unsigned* ticket;
  unsigned* min_key;  // ~key(min), so that min is an atomicMax too
  unsigned* max_key;
};

Scratch scratch_of(int* base, int slices, int bins) {
  unsigned* tail = reinterpret_cast<unsigned*>(base + static_cast<long long>(slices) * kCopies * bins);
  return {base, tail, tail + slices, tail + 2 * slices};
}

// Unsigned keys in the order of the floats they stand for: 0 lies below every
// float but a NaN with all bits set, and so does ~key of every float.
__device__ __forceinline__ unsigned order_key(float f) {
  const unsigned b = __float_as_uint(f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}
__device__ __forceinline__ float key_value(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// Visit every pixel of a slice that falls to this block: an aligned body of
// float4, loaded kLoads at a time a thread, each load a stride of the whole
// grid apart; the unaligned head and the tail go to block 0, one a thread.
// The first loads are in flight before `ready()` (called by every thread)
// waits for what the visits need.
template <typename Visit, typename Ready>
__device__ __forceinline__ void walk(const float* xs, long long n, Visit& visit, Ready&& ready) {
  int head = static_cast<int>(((16 - (reinterpret_cast<uintptr_t>(xs) & 15)) & 15) >> 2);
  if (head > n) head = static_cast<int>(n);
  const long long n4 = (n - head) >> 2;
  const int tail = static_cast<int>(n - head - 4 * n4);
  const float4* body = reinterpret_cast<const float4*>(xs + head);
  const long long grid = static_cast<long long>(gridDim.x) * kThreads;
  long long base = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  float4 v[kLoads];
#pragma unroll
  for (int u = 0; u < kLoads; ++u) {
    if (base + u * grid < n4) v[u] = body[base + u * grid];
  }
  ready();
  while (true) {
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      if (base + u * grid < n4) visit(v[u]);
    }
    base += grid * kLoads;
    if (base >= n4) break;
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      if (base + u * grid < n4) v[u] = body[base + u * grid];
    }
  }
  if (blockIdx.x == 0) {
    if (static_cast<int>(threadIdx.x) < head) visit(xs[threadIdx.x]);
    if (static_cast<int>(threadIdx.x) < tail) visit(xs[head + 4 * n4 + threadIdx.x]);
  }
}

struct MinMax {
  float lo, hi;
  __device__ __forceinline__ void operator()(float v) {
    lo = fminf(lo, v);
    hi = fmaxf(hi, v);
  }
  __device__ __forceinline__ void operator()(const float4& v) {
    lo = fminf(lo, fminf(fminf(v.x, v.y), fminf(v.z, v.w)));
    hi = fmaxf(hi, fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w)));
  }
};

struct Counter {
  int* hist;
  float lo, scale, top;
#ifdef HISTOGRAM_WITHOUT_COUNT
  int sink;
  __device__ __forceinline__ void operator()(float v) { sink ^= __float_as_uint(v); }
  __device__ __forceinline__ void operator()(const float4& v) {
    sink ^= __float_as_uint(v.x) ^ __float_as_uint(v.y) ^ __float_as_uint(v.z) ^ __float_as_uint(v.w);
  }
#else
  __device__ __forceinline__ int bin(float v) const {
    const float t = __fmul_rn(__fsub_rn(v, lo), scale);
    return static_cast<int>(fminf(fmaxf(t, 0.0f), top));
  }
  __device__ __forceinline__ void operator()(float v) { atomicAdd(hist + bin(v), 1); }
  __device__ __forceinline__ void operator()(const float4& v) {
    atomicAdd(hist + bin(v.x), 1);
    atomicAdd(hist + bin(v.y), 1);
    atomicAdd(hist + bin(v.z), 1);
    atomicAdd(hist + bin(v.w), 1);
  }
#endif
};

// The sum of v over the threads before this one in the block. Every thread
// of the block calls it; `warp_sums` holds kWarps ints of shared memory.
__device__ int block_exclusive_sum(int v, int* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int before = incl - v;
  for (int w = 0; w < warp; ++w) before += warp_sums[w];
  return before;
}

__global__ void __launch_bounds__(kThreads) minmax_kernel(const float* __restrict__ x, long long n,
                                                          Scratch s) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem);  // kWarps minima, kWarps maxima
  allow_dependent_launch();
#ifdef HISTOGRAM_EMPTY
  return;
#endif
  const int slice = blockIdx.y;
  MinMax mm{INFINITY, -INFINITY};
  walk(x + static_cast<long long>(slice) * n, n, mm, [] {});
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    mm.lo = fminf(mm.lo, __shfl_xor_sync(0xffffffffu, mm.lo, o));
    mm.hi = fmaxf(mm.hi, __shfl_xor_sync(0xffffffffu, mm.hi, o));
  }
  if (lane == 0) {
    red[warp] = mm.lo;
    red[kWarps + warp] = mm.hi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) {
      mm.lo = fminf(mm.lo, red[w]);
      mm.hi = fmaxf(mm.hi, red[kWarps + w]);
    }
    atomicMax(s.min_key + slice, ~order_key(mm.lo));
    atomicMax(s.max_key + slice, order_key(mm.hi));
  }
}

// Counts one slice's share into shared memory and adds it to the slice's
// accumulator; the slice's last block writes the counts and, given qs,
// lo, scale and the quantiles, and leaves the scratch zeroed. lo_in/scale_in
// given: the histogram_2d mode (no min/max keys are read or reset).
__global__ void __launch_bounds__(kThreads) count_kernel(
    const float* __restrict__ x, long long n, int bins, const float* __restrict__ lo_in,
    const float* __restrict__ scale_in, Qs qs, int nq, Scratch s, int* __restrict__ counts,
    float* __restrict__ lo_out, float* __restrict__ scale_out, float* __restrict__ quantiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* hist = reinterpret_cast<int*>(smem);
  int* small = hist + bins;  // [0] last-block flag, [1, 1 + kWarps) warp sums, then one a q
#ifdef HISTOGRAM_EMPTY
  return;
#endif
  const int slice = blockIdx.y;
  const bool given = lo_in != nullptr;
  float lo = 0.0f, scale = 0.0f;
  Counter count{hist, lo, scale, static_cast<float>(bins - 1)};
  // the pixels were written before either launch: they are loaded while the
  // min/max launch still runs
  walk(x + static_cast<long long>(slice) * n, n, count, [&] {
    for (int i = threadIdx.x; i < bins; i += kThreads) hist[i] = 0;
    grid_dependency_wait();
    if (given) {
      lo = lo_in[slice];
      scale = scale_in[slice];
    } else {
      lo = key_value(~__ldcg(s.min_key + slice));
      const float hi = key_value(__ldcg(s.max_key + slice));
      scale = __fdiv_rn(static_cast<float>(bins - 1), fmaxf(__fsub_rn(hi, lo), 1e-20f));
    }
    count.lo = lo;
    count.scale = scale;
    __syncthreads();
  });
#ifdef HISTOGRAM_WITHOUT_COUNT
  if (count.sink == 0x7fc00001) hist[0] = 1;  // keeps the loads
#endif
  __syncthreads();
  // kCopies accumulators a slice, side by side: block b adds to copy b % kCopies
  int* acc = s.acc + static_cast<long long>(slice) * kCopies * bins;
#ifndef HISTOGRAM_WITHOUT_MERGE
  int* mine = acc + (blockIdx.x % kCopies) * bins;
  // blocks finish together: each starts its sweep at another 512-byte line
  // of the accumulator, so that their additions spread over L2's slices
  const int start = static_cast<int>((blockIdx.x * 128u) % static_cast<unsigned>(bins));
  for (int j = threadIdx.x; j < bins; j += kThreads) {
    const int i = j + start < bins ? j + start : j + start - bins;
    const int c = hist[i];
    if (c) atomicAdd(mine + i, c);
  }
#endif
  // the block's additions, made thread 0's by the barrier, are released with
  // its ticket; the last block acquires every other block's
  __syncthreads();
#ifdef HISTOGRAM_WITHOUT_TICKET
  return;
#endif
  if (threadIdx.x == 0) small[0] = take_ticket(s.ticket + slice) == gridDim.x - 1;
  __syncthreads();
  if (!small[0]) return;
#ifdef HISTOGRAM_WITHOUT_TAIL
  return;
#endif

  // the slice's last block: every other block's additions have landed
  int* out = counts + static_cast<long long>(slice) * bins;
  for (int i = threadIdx.x; i < bins; i += kThreads) {
    int c = 0;
#pragma unroll
    for (int k = 0; k < kCopies; ++k) c += __ldcg(acc + k * bins + i);
    hist[i] = c;
    out[i] = c;
#pragma unroll
    for (int k = 0; k < kCopies; ++k) acc[k * bins + i] = 0;
  }
  if (threadIdx.x == 0) {
    s.ticket[slice] = 0;
    if (!given) {
      s.min_key[slice] = 0;
      s.max_key[slice] = 0;
      lo_out[slice] = lo;
      scale_out[slice] = scale;
    }
  }
  if (nq == 0) return;
  int* first = small + 1 + kWarps;
  if (static_cast<int>(threadIdx.x) < nq) first[threadIdx.x] = bins;
  __syncthreads();
  // cumulative counts: each thread sums its run of bins, then a block scan
  const int per = (bins + kThreads - 1) / kThreads;
  const int k0 = min(bins, static_cast<int>(threadIdx.x) * per), k1 = min(bins, k0 + per);
  int run = 0;
  for (int k = k0; k < k1; ++k) {
    run += hist[k];
    hist[k] = run;
  }
  const int before = block_exclusive_sum(run, small + 1);
  // cum[k] / n >= q holds from some bin on: the thread whose run holds that
  // bin finds it
  const float nf = static_cast<float>(n);
  for (int j = 0; j < nq; ++j) {
    for (int k = k0; k < k1; ++k) {
      if (__fdiv_rn(static_cast<float>(hist[k] + before), nf) >= qs.q[j]) {
        atomicMin(first + j, k);
        break;
      }
    }
  }
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < nq) {
    int k = first[threadIdx.x];
    if (k == bins) k = 0;  // no bin reaches q: argmax of all-false is 0
    quantiles[static_cast<long long>(slice) * nq + threadIdx.x] =
        __fsub_rn(__fadd_rn(lo, __fdiv_rn(static_cast<float>(k + 1), scale)), __fdiv_rn(0.5f, scale));
  }
}

int sm_count() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (!cached[dev]) cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount, dev);
  return cached[dev];
}

// kBlocksPerSm blocks on every SM over all slices, but no block with fewer
// than one float4 a thread; `requested` > 0 overrides.
int blocks_per_slice(long long n, int slices, int requested) {
  if (requested > 0) return requested;
  const long long fill = (static_cast<long long>(kBlocksPerSm) * sm_count() + slices - 1) / slices;
  const long long most = (n / 4 + kThreads - 1) / kThreads;
  long long b = fill < most ? fill : most;
  return static_cast<int>(b < 1 ? 1 : b);
}

bool valid(long long n, int slices, int bins, int requested) {
  return n > 0 && n < (1LL << 31) && slices > 0 && slices <= 65535 && bins > 0 &&
         bins <= kMaxBins && requested >= 0 && requested <= (1 << 20);
}

size_t count_smem(int bins) { return (static_cast<size_t>(bins) + 1 + kWarps + kMaxQs) * sizeof(int); }

template <typename... Params, typename... Args>
int launch(void (*kernel)(Params...), dim3 grid, size_t smem, void* stream, bool overlap_previous,
           Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = overlap_previous ? 1 : 0;
  const cudaError_t rc = cudaLaunchKernelEx(&cfg, kernel, args...);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(rc != cudaSuccess ? rc : last);
}

}  // namespace

// The grid the launchers take for (slices, n): blocks per slice (0 asks for
// the default). Launches nothing.
extern "C" int seq_histogram_blocks(long long n, int slices, int requested) {
  if (!valid(n, slices, 1, requested)) return -1;
  return blocks_per_slice(n, slices, requested);
}

// 32-bit words of scratch the launchers need for (slices, bins).
extern "C" long long seq_histogram_scratch_words(int slices, int bins) {
  return static_cast<long long>(slices) * (static_cast<long long>(kCopies) * bins + 3);
}

// x: (slices, n) f32, contiguous; qs: nq (1..8) host floats. Writes counts
// (slices, bins) int32, lo and scale (slices,) f32, quantiles (slices, nq)
// f32. scratch: seq_histogram_scratch_words int32, zero, and zero again
// when the launches have run. Two launches on `stream`; returns the first
// CUDA error (0: both launched).
extern "C" int seq_quantile_pass(const float* x, long long n, int slices, int bins, const float* qs,
                                 int nq, int* counts, float* lo, float* scale, float* quantiles,
                                 int* scratch, int blocks, void* stream) {
  if (!valid(n, slices, bins, blocks) || nq < 1 || nq > kMaxQs) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Qs q = {};
  for (int j = 0; j < nq; ++j) q.q[j] = qs[j];
  const Scratch s = scratch_of(scratch, slices, bins);
  const dim3 grid(blocks_per_slice(n, slices, blocks), slices);
  int rc = launch(minmax_kernel, grid, 2 * kWarps * sizeof(float), stream, false, x, n, s);
  if (rc) return rc;
  return launch(count_kernel, grid, count_smem(bins), stream, true, x, n, bins,
                static_cast<const float*>(nullptr), static_cast<const float*>(nullptr), q, nq, s,
                counts, lo, scale, quantiles);
}

// x: (slices, n) f32, contiguous; lo, scale: (slices,) f32 on the device.
// Writes counts (slices, bins) int32. scratch as above. One launch.
extern "C" int seq_histogram_f32(const float* x, long long n, int slices, const float* lo,
                                 const float* scale, int bins, int* counts, int* scratch, int blocks,
                                 void* stream) {
  if (!valid(n, slices, bins, blocks) || lo == nullptr || scale == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Scratch s = scratch_of(scratch, slices, bins);
  const dim3 grid(blocks_per_slice(n, slices, blocks), slices);
  return launch(count_kernel, grid, count_smem(bins), stream, false, x, n, bins, lo, scale, Qs{}, 0,
                s, counts, static_cast<float*>(nullptr), static_cast<float*>(nullptr),
                static_cast<float*>(nullptr));
}
