// The bf16 warp-level tensor-core tile shared by the port's kernels
// (pw1x1.cu, probes.cu): raw bf16 octets staged into shared memory and the
// mma.sync m16n8k16 product with float32 accumulators.
#pragma once

#include <stdint.h>

namespace sparkdl {

__device__ __forceinline__ uint32_t pack(uint16_t lo, uint16_t hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

// Eight consecutive raw bf16 values of row `row` from column `col` of a
// row-major (rows, cols) matrix, zero outside it, stored to shared `dst`
// (16-byte aligned). VEC: one 16-byte load where the whole octet is inside.
template <bool VEC>
__device__ __forceinline__ void copy8(const uint16_t* __restrict__ p,
                                      long long row, int col, long long rows,
                                      int cols, uint16_t* dst) {
  if (VEC && row < rows && col + 7 < cols) {
    *reinterpret_cast<uint4*>(dst) =
        *reinterpret_cast<const uint4*>(p + row * cols + col);
    return;
  }
  uint16_t v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    v[j] = (row < rows && col + j < cols) ? p[row * cols + col + j] : 0;
  *reinterpret_cast<uint4*>(dst) = make_uint4(
      pack(v[0], v[1]), pack(v[2], v[3]), pack(v[4], v[5]), pack(v[6], v[7]));
}

// D = A(16x16, row) * B(16x8, col) + D, bf16 inputs, float32 accumulators.
__device__ __forceinline__ void mma16816(float d[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

}  // namespace sparkdl
