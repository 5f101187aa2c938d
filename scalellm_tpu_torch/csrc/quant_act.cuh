// The activation quantization of the W4A8 kernels, shared by
// quant_matmul.cu (K2, scalellm_quant_matmul_w4a8) and quant_gemv.cu (K12b,
// scalellm_quant_w4a8_gemv), both on the integer small-M mainloop of
// quant_small_m.cuh: the optional RMSNorm, then int8 per (row, k-block)
// with the scale max(absmax, 1e-10) * (1/127), stored in the K order of
// the mainloop's A fragments, and per 128-K span the int32 sum of the
// quantized values beside the span's activation scale.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace scalellm_quant {
namespace {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float load_f32_or_bf16(const void* p, size_t i, int is_bf16) {
  return is_bf16 ? __bfloat162float(static_cast<const bf16*>(p)[i])
                 : static_cast<const float*>(p)[i];
}

// Programmatic dependent launch: a grid launched after this one may start
// (griddep_launch), and a grid waits for the grid before it to complete and
// its writes to be visible (griddep_wait; immediate where it was launched
// without the dependency).
__device__ __forceinline__ void griddep_launch() { asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory"); }
__device__ __forceinline__ void griddep_wait() { asm volatile("griddepcontrol.wait;\n" ::: "memory"); }

// ------------------------------------------------------------ act quant

constexpr int kActThreads = 256;
constexpr int kActSpan = 128;  // K of one folded dot of the W4A8 mainloop

__device__ __forceinline__ float block_reduce(float v, bool take_max, float* red) {
  // Same value in every thread; the order of the combination is fixed.
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float other = __shfl_xor_sync(0xffffffffu, v, o);
    v = take_max ? fmaxf(v, other) : v + other;
  }
  __syncthreads();  // red may still be read from the previous call
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < kActThreads / 32; ++w) r = take_max ? fmaxf(r, red[w]) : r + red[w];
  return r;
}

// One block per (row of x, k-block): grid (M, K / block_k). Writes, in the
// layout of the mainloop's ring stages (ld >= M rows, the token tiles'
// padding: a stage's x and its sums are one contiguous range each),
//   xq [K / 32][ld][32]: row `row` of each 32-K piece, in the K order that
//     the mainloop's A fragments take (bits 4: each 8 K as [k0 k2 k4 k6 k1
//     k3 k5 k7], the even-K and odd-K nibbles of a weight word; bits 8: the
//     piece's 4-byte words as [w0 w4 w1 w5 w2 w6 w3 w7], w_i being K
//     4i..4i+3, the two 16-byte weight columns of an m16n8k32 step);
//   xs [K / 128][2][ld]: row 2 sp holds the int32 sum of xq over span sp,
//     row 2 sp + 1 the activation scale of the span's k-block.
// Rows M..ld-1 are not written. With the RMSNorm every block of a row reads
// all of it for the mean square (one block where one k-block spans K, as
// plan() fuses it).
__global__ void __launch_bounds__(kActThreads) act_quant_kernel(
    const bf16* __restrict__ x, const void* __restrict__ gamma, int gamma_bf16, float eps,
    int8_t* __restrict__ xq, float* __restrict__ xs, int K, int block_k, int ld, int bits) {
  // The k-block, normalised, as bf16 (2 block_k bytes), then its int8
  // values in K order.
  extern __shared__ __align__(16) unsigned char act_smem[];
  bf16* vals = reinterpret_cast<bf16*>(act_smem);
  unsigned char* blk_q = act_smem + 2 * (size_t)block_k;
  __shared__ float red[kActThreads / 32];
  griddep_launch();  // the main grid behind it may start streaming its weights
  const int tid = threadIdx.x;
  const int row = blockIdx.x;
  const int k0 = blockIdx.y * block_k;
  const int i0 = k0 / 8, i1 = i0 + block_k / 8;  // the k-block's 16-byte pieces of the row

  // One pass over x in device memory: the k-block into shared memory and,
  // with the RMSNorm, the row's sum of squares on the way.
  const uint4* xv = reinterpret_cast<const uint4*>(x + (size_t)row * K);
  if (gamma != nullptr) {
    float ss = 0.f;
    for (int i = tid; i < K / 8; i += kActThreads) {
      const uint4 v = __ldg(xv + i);
      if (i >= i0 && i < i1) reinterpret_cast<uint4*>(vals)[i - i0] = v;
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(p[j]);
        ss += f.x * f.x;
        ss += f.y * f.y;
      }
    }
    ss = block_reduce(ss, false, red);  // its barriers also publish vals
    const float inv = __frsqrt_rn(ss / (float)K + eps);
    // f32 norm, rounded to the input type before anything else reads it.
    for (int k = tid; k < block_k; k += kActThreads)
      vals[k] = __float2bfloat16_rn(__bfloat162float(vals[k]) * inv * load_f32_or_bf16(gamma, k0 + k, gamma_bf16));
  } else {
    for (int i = i0 + tid; i < i1; i += kActThreads) reinterpret_cast<uint4*>(vals)[i - i0] = __ldg(xv + i);
  }
  __syncthreads();
  float amax = 0.f;
  for (int k = tid; k < block_k; k += kActThreads) amax = fmaxf(amax, fabsf(__bfloat162float(vals[k])));
  amax = block_reduce(amax, true, red);
  // Times 1/127, not over 127: XLA evaluates the TPU package's division by
  // a constant this way, and the last bit of s decides rounding ties.
  const float s = fmaxf(amax, 1e-10f) * (1.0f / 127.0f);
  for (int sp = tid; sp < block_k / kActSpan; sp += kActThreads)
    xs[(size_t)(2 * (k0 / kActSpan + sp) + 1) * ld + row] = s;
  for (int k = tid; k < block_k; k += kActThreads) {
    float q = rintf(__bfloat162float(vals[k]) / s);  // round half to even
    q = fminf(fmaxf(q, -127.f), 127.f);
    blk_q[k] = (unsigned char)(int8_t)(int)q;
  }
  __syncthreads();
  const uint4* src = reinterpret_cast<const uint4*>(blk_q);
  // Row `row` of piece p: 32 bytes at (p ld + row) 32.
  auto piece = [&](int i32) { return reinterpret_cast<uint4*>(xq + ((size_t)(k0 / 32 + i32) * ld + row) * 32); };
  if (bits == 4) {
    for (int i = tid; i < block_k / 16; i += kActThreads) {
      const uint4 w = src[i];
      piece(i / 2)[i % 2] = make_uint4(__byte_perm(w.x, w.y, 0x6420), __byte_perm(w.x, w.y, 0x7531),
                                       __byte_perm(w.z, w.w, 0x6420), __byte_perm(w.z, w.w, 0x7531));
    }
  } else {
    for (int i = tid; i < block_k / 32; i += kActThreads) {
      const uint4 a = src[2 * i], b = src[2 * i + 1];
      uint4* dst = piece(i);
      dst[0] = make_uint4(a.x, b.x, a.y, b.y);
      dst[1] = make_uint4(a.z, b.z, a.w, b.w);
    }
  }
  // The int32 sum of xq over each span: a warp a span, 4 bytes a lane.
  const int warp = tid >> 5, lane = tid & 31;
  for (int sp = warp; sp < block_k / kActSpan; sp += kActThreads / 32) {
    const uint32_t w = reinterpret_cast<const uint32_t*>(blk_q + sp * kActSpan)[lane];
    int v = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) v += (int)(int8_t)(w >> (8 * j));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) reinterpret_cast<int*>(xs)[(size_t)(2 * (k0 / kActSpan + sp)) * ld + row] = v;
  }
}

}  // namespace
}  // namespace scalellm_quant
