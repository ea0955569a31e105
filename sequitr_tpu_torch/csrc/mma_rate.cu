// How fast this card's tensor cores take mma.sync.m16n8k16 (bf16 into f32),
// the instruction csrc/conv3x3.cu multiplies with: one block of `warps` warps
// on every SM, each warp 16 independent accumulators fed from 2 A and 4 B
// fragments in registers (the shape of conv3x3.cu's inner step), nothing
// else. studies/conv3x3_parts.py runs it and prints the rate.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two bf16 values with random sign and mantissa and exponents of 0.5 .. 2.
__device__ uint32_t random_pair(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352dU;
  x ^= x >> 15;
  x *= 0x846ca68bU;
  x ^= x >> 16;
  return (x & 0x80ff80ffu) | 0x3f003f00u;
}

__global__ void mma_rate_kernel(float* out, int iters) {
  float acc[16][4] = {};
  uint32_t a[2][4], b[4][2];
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 4; ++j) a[i][j] = random_pair(threadIdx.x * 64 + i * 4 + j);
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 2; ++j) b[i][j] = random_pair(threadIdx.x * 64 + 32 + i * 2 + j);
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int o = 0; o < 2; ++o)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma(acc[o * 8 + i * 4 + j], a[i], b[j]);
  }
  float s = 0.0f;
  for (int j = 0; j < 16; ++j) s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

}  // namespace

// Launches `blocks` blocks of `warps` warps, each warp doing 16 * iters mma,
// on `stream`; out holds blocks * warps * 32 floats. Returns a cudaError_t.
extern "C" int seq_mma_rate(float* out, int blocks, int warps, int iters, void* stream) {
  mma_rate_kernel<<<blocks, warps * 32, 0, static_cast<cudaStream_t>(stream)>>>(out, iters);
  return static_cast<int>(cudaGetLastError());
}
