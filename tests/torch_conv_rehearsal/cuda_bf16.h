// Stand-in for <cuda_bf16.h>: bfloat16 as its 16 bits, round to nearest even.
#pragma once

#include <cstdint>
#include <cstring>

struct __nv_bfloat16 {
  uint16_t bits;
};
inline __nv_bfloat16 __float2bfloat16_rn(float v) {
  uint32_t u;
  std::memcpy(&u, &v, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {static_cast<uint16_t>((u >> 16) | 0x40)};
  u += 0x7fffu + ((u >> 16) & 1u);
  return {static_cast<uint16_t>(u >> 16)};
}
inline float __bfloat162float(__nv_bfloat16 v) {
  const uint32_t u = static_cast<uint32_t>(v.bits) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline uint16_t __bfloat16_as_ushort(__nv_bfloat16 v) { return v.bits; }
struct __nv_bfloat162 {
  __nv_bfloat16 x, y;
};
inline __nv_bfloat162 __floats2bfloat162_rn(float lo, float hi) {
  return {__float2bfloat16_rn(lo), __float2bfloat16_rn(hi)};
}
