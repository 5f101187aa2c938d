// The activation quantization of the W4A8 kernels, shared by
// quant_matmul.cu (K2, scalellm_quant_matmul_w4a8) and quant_gemv.cu (K12b,
// scalellm_quant_w4a8_gemv): the optional RMSNorm, then int8 per (row,
// k-block) with the scale max(absmax, 1e-10) * (1/127), stored with each 8
// consecutive K as [k0 k2 k4 k6 k1 k3 k5 k7], and the int32 sums of the
// quantized values over each span of `G` K.
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

// ------------------------------------------------------------ act quant

constexpr int kActThreads = 256;

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

// One block per row of x. Writes xq (permuted within each 8 K, see above),
// sx [M, K / block_k] and, when xsum is not null, the int32 sum of xq over
// each weight group [M, K / G].
__global__ void __launch_bounds__(kActThreads) act_quant_kernel(
    const bf16* __restrict__ x, const void* __restrict__ gamma, int gamma_bf16, float eps,
    int8_t* __restrict__ xq, float* __restrict__ sx, int* __restrict__ xsum,
    int K, int block_k, int G) {
  // The row, normalised, as bf16 (2K bytes), then its int8 values in K order.
  extern __shared__ __align__(16) unsigned char act_smem[];
  bf16* vals = reinterpret_cast<bf16*>(act_smem);
  unsigned char* row_q = act_smem + 2 * (size_t)K;
  __shared__ float red[kActThreads / 32];
  const int tid = threadIdx.x;
  const int row = blockIdx.x;
  const int n_kb = K / block_k;

  // One pass over x in device memory: into shared memory, with its sum of
  // squares on the way.
  const uint4* xv = reinterpret_cast<const uint4*>(x + (size_t)row * K);
  float ss = 0.f;
  for (int i = tid; i < K / 8; i += kActThreads) {
    const uint4 v = __ldg(xv + i);
    reinterpret_cast<uint4*>(vals)[i] = v;
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(p[j]);
      ss += f.x * f.x;
      ss += f.y * f.y;
    }
  }
  if (gamma != nullptr) {
    ss = block_reduce(ss, false, red);
    const float inv = __frsqrt_rn(ss / (float)K + eps);
    // f32 norm, rounded to the input type before anything else reads it.
    // Each thread rewrites the pieces it wrote itself.
    for (int i = tid; i < K / 8; i += kActThreads)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int k = i * 8 + j;
        vals[k] = __float2bfloat16_rn(__bfloat162float(vals[k]) * inv *
                                      load_f32_or_bf16(gamma, k, gamma_bf16));
      }
  }
  __syncthreads();
  for (int kb = 0; kb < n_kb; ++kb) {
    const int k_begin = kb * block_k, k_end = k_begin + block_k;
    float amax = 0.f;
    for (int k = k_begin + tid; k < k_end; k += kActThreads)
      amax = fmaxf(amax, fabsf(__bfloat162float(vals[k])));
    amax = block_reduce(amax, true, red);
    // Times 1/127, not over 127: XLA evaluates the TPU package's division by
    // a constant this way, and the last bit of s decides rounding ties.
    const float s = fmaxf(amax, 1e-10f) * (1.0f / 127.0f);
    if (tid == 0) sx[(size_t)row * n_kb + kb] = s;
    for (int k = k_begin + tid; k < k_end; k += kActThreads) {
      float q = rintf(__bfloat162float(vals[k]) / s);  // round half to even
      q = fminf(fmaxf(q, -127.f), 127.f);
      row_q[k] = (unsigned char)(int8_t)(int)q;
    }
  }
  __syncthreads();
  const uint2* src = reinterpret_cast<const uint2*>(row_q);
  uint2* dst = reinterpret_cast<uint2*>(xq + (size_t)row * K);
  for (int i = tid; i < K / 8; i += kActThreads) {
    const uint2 w = src[i];
    dst[i] = make_uint2(__byte_perm(w.x, w.y, 0x6420), __byte_perm(w.x, w.y, 0x7531));
  }
  if (xsum != nullptr) {
    const int n_groups = K / G;
    const int warp = tid >> 5, lane = tid & 31;
    for (int g = warp; g < n_groups; g += kActThreads / 32) {
      int s = 0;
      for (int k = lane; k < G; k += 32) s += (int)(int8_t)row_q[g * G + k];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) xsum[(size_t)row * n_groups + g] = s;
    }
  }
}

}  // namespace
}  // namespace scalellm_quant
