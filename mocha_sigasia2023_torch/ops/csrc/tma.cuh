// Host side of the attention kernels' TMA copies: the driver's tensor-map
// encoder, reached through the runtime so the libraries need no link against
// libcuda, and the alignment rules TMA imposes.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tma {

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A (B, H, rows, D) view with element strides (sb, sh, sn, 1) as a 4-D tensor
// map read or written in [box_rows x box_cols] boxes with the 128-byte
// swizzle (the 16-byte unit u of box row r lands at unit u ^ (r % 8));
// box_cols * elem_bytes must be 128.  A dimension of extent 1 takes a harmless stride.
inline bool encode_map(CUtensorMap* map, CUtensorMapDataType type,
                       int elem_bytes, const void* ptr, int B, int H,
                       int rows, int D, long long sb, long long sh,
                       long long sn, int box_cols, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  if (rows == 1) sn = D;
  if (H == 1) sh = sn * rows;
  if (B == 1) sb = sh * H;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)rows, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)(sn * elem_bytes),
                                 (cuuint64_t)(sh * elem_bytes),
                                 (cuuint64_t)(sb * elem_bytes)};
  const cuuint32_t box[4] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1,
                             1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, type, 4, const_cast<void*>(ptr), dims, strides, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// TMA needs 16-byte-aligned starts and strides, unless a dim has extent 1.
inline bool aligned(long long stride, int extent, int elem_bytes) {
  return extent == 1 || (stride * elem_bytes) % 16 == 0;
}

inline bool aligned(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

}  // namespace tma
