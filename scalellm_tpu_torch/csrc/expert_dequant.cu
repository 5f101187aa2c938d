// INT4 routed-expert dequantization for Hopper (sm_90a): packed int4
// experts and their bf16 group scales -> the bf16 weights that the grouped
// GEMM (K6, grouped_matmul.cu) takes on steps too large for the decode
// kernels (K7/K8).
//
// Replaces the unpack and scale fold that scalellm_tpu/ops/moe_quant.py:633
// leaves to XLA before the stock megablox `gmm` on a TPU. Plain PyTorch
// version: scalellm_tpu_torch/ops/moe_quant.py:plain_dequantize_experts_bf16.
// Contract:
//   qweight  u8 [E, N, K/2]: byte j of a row holds K = 2j in bits 0-3 and
//            K = 2j + 1 in bits 4-7, each a signed nibble;
//   scales   bf16 [E, K/G, N], one per (expert, k-group, column);
//   out      bf16 [E, N, K] in natural K order: bf16_rn(q * s). The product
//            of a 4-bit integer and a bf16 is exact in f32, so it is rounded
//            once, as the plain version's f32 product cast to bf16 is.
//
// What bounds it on an H100: bytes. One DeepSeek-V2-Lite projection (64
// experts, 2048 -> 1408 or 1408 -> 2048) reads 92.3 MB of packed weights
// and 2.9 MB of scales and writes 369.1 MB: 0.139 ms at 3.35 TB/s.
//
// Design: one thread a 16-byte piece of packed weights, as four 4-byte
// words a warp apart (every load and store of a warp covers consecutive
// bytes: 128 read, 512 written), each word 8 weights of one row and one
// group where K % 8 == 0 and G % 8 == 0 (else the kernel takes the bytes
// one at a time). The 8 nibbles become bf16 by bit placement (unpack_int4x8
// of quant_unpack.cuh: no integer-to-float converts, exact), then one
// bf16x2 product with the group's scale each pair (rounded once).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "quant_unpack.cuh"

namespace {

using scalellm_quant::bf16x2_bits;
using scalellm_quant::bf16x2_from_bits;
using scalellm_quant::unpack_int4x8;

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kWordsPerThread = 4;
constexpr int kBlockWords = kThreads * kWordsPerThread;

// grid (ceil(N K / 8 / kBlockWords), E): block (x, e) takes the words
// [x kBlockWords, (x + 1) kBlockWords) of expert e; warp w of it the 128
// words from x kBlockWords + 128 w, lane l words l, l + 32, l + 64, l + 96.
__global__ void __launch_bounds__(kThreads) expert_dequant_words_kernel(const uint32_t* __restrict__ qweight,
                                                                        const bf16* __restrict__ scales,
                                                                        uint4* __restrict__ out, int N, int K,
                                                                        int G) {
  const int e = blockIdx.y, words_per_row = K / 8, n_groups = K / G;
  const int words = N * words_per_row;
  const size_t base = (size_t)e * words;
  const bf16* se = scales + (size_t)e * n_groups * N;
  const int w0 = blockIdx.x * kBlockWords + (threadIdx.x >> 5) * 32 * kWordsPerThread + (threadIdx.x & 31);
  const __nv_bfloat162 off = __float2bfloat162_rn(136.f);
#pragma unroll
  for (int j = 0; j < kWordsPerThread; ++j) {
    const int w = w0 + 32 * j;
    if (w >= words) break;
    const int n = w / words_per_row, k = (w - n * words_per_row) * 8;
    const __nv_bfloat162 s = __bfloat162bfloat162(se[(size_t)(k / G) * N + n]);
    uint32_t v[4];
    unpack_int4x8(__ldg(qweight + base + w), off, v);  // the 8 weights, K order, exact in bf16
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = bf16x2_bits(__hmul2(bf16x2_from_bits(v[i]), s));
    out[base + w] = make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// Any even K and any G that divides K: a thread a packed byte (two weights,
// each with its own group's scale), the f32 products rounded once.
__global__ void __launch_bounds__(kThreads) expert_dequant_bytes_kernel(const uint8_t* __restrict__ qweight,
                                                                        const bf16* __restrict__ scales,
                                                                        __nv_bfloat162* __restrict__ out, int N,
                                                                        int K, int G) {
  const int e = blockIdx.y, half = K / 2, n_groups = K / G;
  const int bytes = N * half;
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= bytes) return;
  const size_t base = (size_t)e * bytes;
  const bf16* se = scales + (size_t)e * n_groups * N;
  const int n = b / half, k = (b - n * half) * 2;
  const int q = (int)(int8_t)qweight[base + b];
  const float lo = (float)((int)((uint32_t)q << 28) >> 28), hi = (float)(q >> 4);  // sign-extended nibbles
  out[base + b] = __floats2bfloat162_rn(lo * __bfloat162float(se[(size_t)(k / G) * N + n]),
                                        hi * __bfloat162float(se[(size_t)((k + 1) / G) * N + n]));
}

}  // namespace

// Plain C entry point, loaded with ctypes: dequantizes E experts of [N, K]
// int4 weights at group size G (K even, K % G == 0) into out; launches on
// `stream`, returns cudaGetLastError() (0 on success), never synchronises.
extern "C" int scalellm_expert_dequant_int4(const void* qweight, const void* scales, void* out, int E, int N,
                                            int K, int G, void* stream) {
  if (E < 0 || N < 0 || K <= 0 || K % 2 || G <= 0 || K % G || E > 65535) return (int)cudaErrorInvalidValue;
  if (E == 0 || N == 0) return 0;
  if ((long long)N * K / 2 > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const bool words = K % 8 == 0 && G % 8 == 0 && reinterpret_cast<uintptr_t>(qweight) % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (words) {
    const long long n_words = (long long)N * K / 8;
    const dim3 grid((unsigned)((n_words + kBlockWords - 1) / kBlockWords), E);
    expert_dequant_words_kernel<<<grid, kThreads, 0, st>>>(static_cast<const uint32_t*>(qweight),
                                                           static_cast<const bf16*>(scales),
                                                           static_cast<uint4*>(out), N, K, G);
  } else {
    const long long n_bytes = (long long)N * K / 2;
    const dim3 grid((unsigned)((n_bytes + kThreads - 1) / kThreads), E);
    expert_dequant_bytes_kernel<<<grid, kThreads, 0, st>>>(static_cast<const uint8_t*>(qweight),
                                                           static_cast<const bf16*>(scales),
                                                           static_cast<__nv_bfloat162*>(out), N, K, G);
  }
  return (int)cudaGetLastError();
}
