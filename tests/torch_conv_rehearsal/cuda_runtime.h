// Stand-in for <cuda_runtime.h> that lets g++ compile csrc/conv3x3.cu,
// csrc/histogram.cu, csrc/qconv.cu and csrc/flows.cu for the CPU: one std::thread per CUDA thread of a block,
// blocks one after another (launches too), a std::barrier for __syncthreads
// and one per warp for __syncwarp, the shuffles and the warp-wide operations
// of ptx_emulation.h; atomics as std::atomic_ref. It rehearses index
// arithmetic and the order of copies, waits, barriers and tickets, not speed.
#pragma once

#include "cuda.h"

#include <atomic>
#include <barrier>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <memory>
#include <thread>
#include <utility>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
#define __align__(n)
#define __grid_constant__

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};
struct uint4 {
  uint32_t x, y, z, w;
};
inline uint4 make_uint4(uint32_t x, uint32_t y, uint32_t z, uint32_t w) { return {x, y, z, w}; }
struct float2 {
  float x, y;
};
struct float4 {
  float x, y, z, w;
};
struct int4 {
  int x, y, z, w;
};

using std::fmaf;
using std::fmaxf;
using std::fminf;
template <typename T>
inline T min(T a, T b) { return a < b ? a : b; }

// --- the runtime calls the launchers make; a small pretend card so that a
// persistent block walks several tiles ---
typedef int cudaError_t;
typedef void* cudaStream_t;
enum {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorLaunchOutOfResources = 701,
  cudaErrorNotSupported = 801,
};
enum cudaDriverEntryPointQueryResult { cudaDriverEntryPointSuccess = 0 };
enum { cudaEnableDefault = 0 };
enum { cudaDevAttrMaxSharedMemoryPerBlockOptin, cudaDevAttrMultiProcessorCount };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize };
namespace emu {
constexpr int kSmemOptin = 232448 - 1024;
constexpr int kSmemPerSm = 232448;
constexpr int kSms = 2;
constexpr int kBlocksByRegisters = 3;  // what the tensor-core kernels' registers allow
}  // namespace emu
inline cudaError_t cudaGetDevice(int* dev) { *dev = 0; return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* v, int attr, int) {
  *v = attr == cudaDevAttrMaxSharedMemoryPerBlockOptin ? emu::kSmemOptin : emu::kSms;
  return cudaSuccess;
}
template <typename K>
inline cudaError_t cudaFuncSetAttribute(K, int, int bytes) {
  return bytes <= emu::kSmemOptin ? cudaSuccess : cudaErrorInvalidValue;
}
template <typename K>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, size_t bytes) {
  *n = static_cast<int>(emu::kSmemPerSm / (bytes + 1024));
  if (*n > emu::kBlocksByRegisters) *n = emu::kBlocksByRegisters;
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaGetDriverEntryPoint(const char*, void** fn, int,
                                           cudaDriverEntryPointQueryResult* found) {
  *fn = reinterpret_cast<void*>(&emu_encode_tiled);
  *found = cudaDriverEntryPointSuccess;
  return cudaSuccess;
}
inline void __trap() { std::abort(); }

// --- threads, blocks, barriers ---
namespace emu {
struct Warp {
  std::barrier<> bar{32};
  const void* addr[32];
  uint32_t regs[32][6];
  uint32_t xchg[32];  // the shuffles' values
};
struct Block {
  explicit Block(int threads) : bar(threads), warps((threads + 31) / 32) {
    for (auto& w : warps) w = std::make_unique<Warp>();
  }
  std::barrier<> bar;
  std::vector<std::unique_ptr<Warp>> warps;
  std::vector<unsigned char> smem;
};
struct Idx {
  unsigned x, y, z;
};
inline thread_local Block* block = nullptr;
inline thread_local Warp* warp = nullptr;
inline thread_local int lane = 0;
}  // namespace emu
inline thread_local emu::Idx threadIdx, blockIdx, gridDim;

inline void __syncthreads() { emu::block->bar.arrive_and_wait(); }
inline void __syncwarp() { emu::warp->bar.arrive_and_wait(); }
inline unsigned char* emu_smem() { return emu::block->smem.data(); }

// Blocks run one after another, the last index first: a card runs them in
// any order, and a kernel must not take the highest index for the last.
template <typename K, typename... A>
void emu_launch(K kernel, dim3 grid, int threads, size_t bytes, A... args) {
  for (unsigned bz = grid.z; bz-- > 0;)
    for (unsigned by = grid.y; by-- > 0;)
      for (unsigned bx = grid.x; bx-- > 0;) {
        emu::Block blk(threads);
        // poisoned, so that a read of shared memory nobody wrote shows
        blk.smem.assign(bytes + 16, 0x7f);
        std::vector<std::thread> pool;
        for (int t = 0; t < threads; ++t)
          pool.emplace_back([&, t] {
            emu::block = &blk;
            emu::warp = blk.warps[t / 32].get();
            emu::lane = t % 32;
            threadIdx = {static_cast<unsigned>(t), 0, 0};
            blockIdx = {bx, by, bz};
            gridDim = {grid.x, grid.y, grid.z};
            kernel(args...);
          });
        for (auto& th : pool) th.join();
      }
}

// launches with attributes: run as any other launch, in order, so a
// programmatic dependent launch finds the launch it depends on finished
enum cudaLaunchAttributeID { cudaLaunchAttributeProgrammaticStreamSerialization = 5 };
union cudaLaunchAttributeValue {
  int programmaticStreamSerializationAllowed;
  unsigned char pad[64];
};
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  cudaLaunchAttributeValue val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim;
  dim3 blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};
template <typename... P, typename... A>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg, void (*kernel)(P...), A&&... args) {
  emu_launch(kernel, cfg->gridDim, static_cast<int>(cfg->blockDim.x), cfg->dynamicSmemBytes,
             static_cast<P>(args)...);
  return cudaSuccess;
}

// --- arithmetic rounded once (g++ with -ffp-contract=off, SSE), bit casts ---
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __int2float_rn(int v) { return static_cast<float>(v); }
// cvt.rni.s32.f32: nearest, ties to even, saturating; NaN gives 0
inline int __float2int_rn(float f) {
  if (std::isnan(f)) return 0;
  const float r = std::nearbyint(f);
  if (r >= 2147483648.0f) return 2147483647;
  if (r < -2147483648.0f) return -2147483647 - 1;
  return static_cast<int>(r);
}
// loads through the read-only cache: plain loads here
template <typename T>
inline T __ldg(const T* p) { return *p; }
inline uint32_t __float_as_uint(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  return u;
}
inline float __uint_as_float(uint32_t u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}

// --- atomics and fences: threads of a block run at once here ---
template <typename T>
inline T atomicAdd(T* p, T v) { return std::atomic_ref<T>(*p).fetch_add(v); }
template <typename T>
inline T atomicMax(T* p, T v) {
  std::atomic_ref<T> a(*p);
  T old = a.load();
  while (old < v && !a.compare_exchange_weak(old, v)) {
  }
  return old;
}
template <typename T>
inline T atomicMin(T* p, T v) {
  std::atomic_ref<T> a(*p);
  T old = a.load();
  while (v < old && !a.compare_exchange_weak(old, v)) {
  }
  return old;
}
template <typename T>
inline T __ldcg(const T* p) { return std::atomic_ref<T>(*const_cast<T*>(p)).load(); }
inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }

// --- shuffles: every lane of the warp takes part ---
namespace emu {
template <typename T, typename Src>
inline T shuffle(T v, Src src) {
  Warp& w = *warp;
  static_assert(sizeof(T) == 4, "32-bit shuffles");
  std::memcpy(&w.xchg[lane], &v, 4);
  w.bar.arrive_and_wait();
  T out;
  std::memcpy(&out, &w.xchg[src(lane)], 4);
  w.bar.arrive_and_wait();
  return out;
}
}  // namespace emu
template <typename T>
inline T __shfl_xor_sync(unsigned, T v, int mask) {
  return emu::shuffle(v, [mask](int l) { return l ^ mask; });
}
template <typename T>
inline T __shfl_up_sync(unsigned, T v, int delta) {
  return emu::shuffle(v, [delta](int l) { return l >= delta ? l - delta : l; });
}
