// Device helpers shared by the quantized kernels (quant_matmul.cu, the
// projections' K2-K4, and moe_quant.cu, the routed experts' K7/K8): the
// bf16 tensor-core product and the exact unpacking of int4 weights to bf16.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace scalellm_quant {

// c += a * b, one m16n8k16 bf16 product with f32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ __nv_bfloat162 bf16x2_from_bits(uint32_t bits) {
  return *reinterpret_cast<const __nv_bfloat162*>(&bits);
}

// Eight int4 weights of one 32-bit word of the port's layout (byte j holds
// K = 2j in bits 0-3 and K = 2j + 1 in bits 4-7, each a signed two's
// complement nibble) -> four bf16x2 words in K order, each weight being
// (its value + 136 - offset). With offset 136 that is the weight itself.
// Exact by construction: a nibble n, unsigned once its sign bit is flipped
// (the weight plus 8), placed in the low mantissa bits of the bf16 128.0
// reads as 128 + n, and the subtraction of small integers is exact. Two
// nibbles at a time, no integer-to-float converts.
__device__ __forceinline__ void unpack_int4x8(uint32_t word, __nv_bfloat162 offset,
                                              uint32_t (&out)[4]) {
  const uint32_t w = word ^ 0x88888888u;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t byte = w >> (8 * j);
    const uint32_t bits = 0x43004300u | (byte & 0xFu) | ((byte << 12) & 0x000F0000u);
    out[j] = bf16x2_bits(__hsub2(bf16x2_from_bits(bits), offset));
  }
}

}  // namespace scalellm_quant
