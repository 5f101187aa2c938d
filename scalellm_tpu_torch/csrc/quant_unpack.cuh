// Device helpers shared by the quantized kernels (quant_matmul.cu, the
// projections' K3/K4; moe_quant.cu, the routed experts' K7/K8; and the
// small-M mainloops of quant_small_m.cuh, K2, K11, K12a and K12b): the bf16
// and int8 tensor-core products, the exact unpacking of int4 weights to
// bf16, and the byte-permute gathers of mma A fragments from packed weights.
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

// c += a * b, one m16n8k32 int8 product with int32 accumulation.
__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
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

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  return bf16x2_bits(__floats2bfloat162_rn(lo, hi));
}

// Four A-fragment words of int4 weights. `word` holds four bytes of the
// port's layout, [row r0 k-lo, row r1 k-lo, row r0 k-hi, row r1 k-hi] (each
// byte two consecutive K); out[0..3] are the bf16 pairs in that order, each
// weight being its value + 136 - the offset of its row. The bit placement
// of unpack_int4x8 (a nibble made unsigned by flipping its sign bit, in the
// low mantissa bits of the bf16 128.0), two weights in one byte-permute and
// one logic op.
__device__ __forceinline__ void unpack_int4_frag(uint32_t word, __nv_bfloat162 off0,
                                                 __nv_bfloat162 off1, uint32_t (&out)[4]) {
  const uint32_t lo = (word ^ 0x88888888u) & 0x0F0F0F0Fu;         // even K: the low nibbles
  const uint32_t hi = ((word >> 4) ^ 0x08080808u) & 0x0F0F0F0Fu;  // odd K: the high nibbles
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t pair = __byte_perm(lo, hi, j | (j << 4) | ((j + 4) << 8) | ((j + 4) << 12));
    const uint32_t bits = (pair & 0x000F000Fu) | 0x43004300u;
    out[j] = bf16x2_bits(__hsub2(bf16x2_from_bits(bits), (j & 1) ? off1 : off0));
  }
}

// d = (a & b) ^ c in one instruction (the compiler would otherwise split the
// two constants into two).
__device__ __forceinline__ uint32_t and_xor(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0x6a;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// The four A-fragment words of one k16 step of int4 weights from two words
// of packed weights (wa: row r0's 8 consecutive K, wb: row r1's; byte j of
// a word holds K 2j and 2j + 1) and the same words shifted right by 4:
// step e takes bytes 2e and 2e + 1, out = [r0 byte 2e, r1 byte 2e, r0 byte
// 2e + 1, r1 byte 2e + 1], each a bf16 pair in K order of (value + 136 -
// 136): the bit placement of unpack_int4_frag, a byte's two nibbles placed
// by one byte-permute (the byte and its shifted copy), made unsigned and
// given the exponent of 128.0 by one logic op, and offset by one bf16x2
// subtraction.
__device__ __forceinline__ void unpack_int4_step(uint32_t wa, uint32_t wa4, uint32_t wb, uint32_t wb4, int e,
                                                 uint32_t mask, uint32_t magic, __nv_bfloat162 off,
                                                 uint32_t (&out)[4]) {
  const uint32_t b0 = 2 * e, b1 = 2 * e + 1;
  const uint32_t p[4] = {__byte_perm(wa, wa4, b0 | ((b0 + 4) << 8)), __byte_perm(wb, wb4, b0 | ((b0 + 4) << 8)),
                         __byte_perm(wa, wa4, b1 | ((b1 + 4) << 8)), __byte_perm(wb, wb4, b1 | ((b1 + 4) << 8))};
#pragma unroll
  for (int j = 0; j < 4; ++j) out[j] = bf16x2_bits(__hsub2(bf16x2_from_bits(and_xor(p[j], mask, magic)), off));
}

// Two int8 weights (the low 16 bits of `pair`, K order) to a bf16 pair; for
// dequant (q - z) rounded to bf16 where there are zero points, then times
// the bf16 scale s, rounded again.
template <bool DEQUANT>
__device__ __forceinline__ uint32_t int8_pair(uint32_t pair, float s, float z, bool asym) {
  float q[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    float d = (float)(int8_t)((pair >> (8 * e)) & 0xFFu);
    if (DEQUANT) {
      if (asym) d = __bfloat162float(__float2bfloat16_rn(d - z));
      d *= s;
    }
    q[e] = d;
  }
  return pack_bf16x2(q[0], q[1]);
}

// The four A-fragment words of one k16 step of int8 weights (wa: row r0's
// 4 consecutive K, wb: row r1's): out = [r0 K 0-1, r1 K 0-1, r0 K 2-3, r1
// K 2-3] as bf16 pairs, exact and without integer-to-float converts: a
// weight q made unsigned (q + 128) in the low byte of the f32 2^23 reads as
// 2^23 + q + 128, one subtraction gives q, and an integer |q| <= 128 in f32
// has its bf16 in the high half, so one byte-permute packs two.
__device__ __forceinline__ void int8_step(uint32_t wa, uint32_t wb, uint32_t (&out)[4]) {
  const uint32_t w[2] = {wa ^ 0x80808080u, wb ^ 0x80808080u};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t word = w[j & 1], b0 = 2 * (j >> 1);
    const float f0 = __uint_as_float(__byte_perm(word, 0x4B000000u, 0x7440 | b0)) - 8388736.f;
    const float f1 = __uint_as_float(__byte_perm(word, 0x4B000000u, 0x7440 | (b0 + 1))) - 8388736.f;
    out[j] = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  }
}

}  // namespace scalellm_quant
