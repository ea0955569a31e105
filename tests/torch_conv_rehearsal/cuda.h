// Stand-in for <cuda.h>: the tensor map (TMA descriptor) as a plain record of
// what cuTensorMapEncodeTiled was given, for ptx_emulation.h to copy by.
#pragma once

#include <cstdint>

typedef uint64_t cuuint64_t;
typedef uint32_t cuuint32_t;
typedef int CUresult;
enum { CUDA_SUCCESS = 0, CUDA_ERROR_INVALID_VALUE = 1 };
enum CUtensorMapDataType { CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 };
enum CUtensorMapInterleave { CU_TENSOR_MAP_INTERLEAVE_NONE };
enum CUtensorMapSwizzle {
  CU_TENSOR_MAP_SWIZZLE_NONE,
  CU_TENSOR_MAP_SWIZZLE_32B,
  CU_TENSOR_MAP_SWIZZLE_64B,
  CU_TENSOR_MAP_SWIZZLE_128B,
};
enum CUtensorMapL2promotion { CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B };
enum CUtensorMapFloatOOBfill { CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE };

struct alignas(64) CUtensorMap {
  unsigned char* base;
  uint64_t dims[3];
  uint64_t strides[3];  // bytes; strides[0] is the element size
  uint32_t box[3];
  int swizzle_bytes;  // 0, 32, 64 or 128
};

// The checks libcuda makes on what this repository asks of it.
inline CUresult emu_encode_tiled(CUtensorMap* map, CUtensorMapDataType, cuuint32_t rank, void* base,
                                 const cuuint64_t* dims, const cuuint64_t* strides,
                                 const cuuint32_t* box, const cuuint32_t* element_strides,
                                 CUtensorMapInterleave, CUtensorMapSwizzle swizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill) {
  if (rank != 3 || reinterpret_cast<uintptr_t>(base) % 16) return CUDA_ERROR_INVALID_VALUE;
  map->base = static_cast<unsigned char*>(base);
  map->strides[0] = 2;
  for (int i = 0; i < 3; ++i) {
    if (dims[i] == 0 || box[i] == 0 || box[i] > 256 || element_strides[i] != 1) {
      return CUDA_ERROR_INVALID_VALUE;
    }
    map->dims[i] = dims[i];
    map->box[i] = box[i];
    if (i > 0) {
      if (strides[i - 1] % 16) return CUDA_ERROR_INVALID_VALUE;
      map->strides[i] = strides[i - 1];
    }
  }
  map->swizzle_bytes = swizzle == CU_TENSOR_MAP_SWIZZLE_NONE ? 0 : 16 << swizzle;
  const uint32_t row_bytes = box[0] * 2;
  if (row_bytes % 16 || (map->swizzle_bytes && row_bytes > static_cast<uint32_t>(map->swizzle_bytes))) {
    return CUDA_ERROR_INVALID_VALUE;
  }
  return CUDA_SUCCESS;
}
