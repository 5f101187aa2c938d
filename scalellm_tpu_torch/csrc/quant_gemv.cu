// Small-M variants of the weight-only quantized matmul, and the weight-stream
// probe, for Hopper (sm_90a).
//
// Replaces the Pallas kernels of scalellm_tpu/ops/quant_matmul.py:
//   scalellm_quant_gemv         <- _gemv_kernel        (:304), variant "gemv"
//   scalellm_quant_w4a8_gemv    <- _w4a8_gemv_kernel   (:466), variant "w4a8g"
//   scalellm_quant_stream_probe <- _stream_only_kernel (:556), the probe the
//                                  TPU package runs under QUANT_STREAM_ONLY
// Plain PyTorch versions: plain_gemv, plain_w4a8g and plain_stream in
// scalellm_tpu_torch/ops/quant_matmul.py. Layouts as in quant_matmul.cu:
// x bf16 [M, K]; qweight [N, K/2] (int4, byte j of a row holds K = 2j and
// 2j + 1 as signed nibbles) or [N, K] (int8); scales f32 or bf16 [K/G, N];
// zeros s8 [K/G, N] or null; out bf16 [M, N].
//
// What each computes:
//   gemv: per span of a column's K (128 K where G % 128 == 0, else 32) the
//     f32 dot of bf16 x with the integer weights, then (dot - xsum * zero) *
//     scale, xsum being the f32 sum of x over the span; spans summed in f32.
//     With G = 128 a span is the group, as in the TPU kernel's per-group
//     dots; at G = 32 or 64 the scale distributes over the group's spans.
//   w4a8g: x quantized to int8 per (row, k-block) exactly as K2 does it
//     (quant_act.cuh); per span of 128 K (inside one group: G % 128 == 0)
//     an int32 dot of the int8 activations with the weights, (dot - xsum *
//     zero) * scale * sx in f32, spans summed in f32. G = 128 makes the span
//     the TPU kernel's group.
//   stream probe: reads every byte of qweight, scales and zeros (without the
//     scales in weights-only mode), and writes the TPU probe's "touch" so
//     that its output can be held against the TPU package: for every output
//     row, sum over k-blocks of (first packed byte of the block, as int8) *
//     (first scale row of the block) (+ first zero row) + x[0, block start],
//     in f32, the product and the addition after it fused as XLA fuses
//     them, rounded to bf16.
//
// The TPU kernels' trick, a block-diagonal activation matrix that turns the
// group dots into one MXU dot, has no meaning here.
//
// What bounds them on an H100. The weight bytes: a (4096, 28672) int4
// projection is 59 MB, 17.5 us at 3.35 TB/s. gemv and w4a8g run on the
// tensor-core small-M mainloops of quant_small_m.cuh (mma.sync on weights
// from a TMA ring of weights and x, a producer warp; gemv unpacks to bf16,
// w4a8g multiplies int8 activations by the int4/int8 weights on the
// integer path), so at M <= 64 their products cost little beside the
// bytes: 2 * M * K * N operations, 3.8 G at M = 16 for that projection, 4
// us at 989 TFLOP/s (2 us at 1979 TOP/s int8). The probe is bound by the
// bytes alone.
//
// Design of gemv: see quant_small_m.cuh. A block owns R = 128 / k_slices
// output columns (weight rows) for every token and all of K; where N / 128
// blocks do not fill the SMs the wrapper asks for 2 or 4 K slices (64 or
// 32 rows a block, its 8 consumer warps splitting K); the slices' sums are
// added in slice order in shared memory. A pre-pass (prep_kernel, one block
// a row) runs the RMSNorm prologue into a bf16 copy of x and, with zero
// points, the sums of x per span.
// Design of w4a8g: K2's (quant_matmul.cu), with the fold above: the W4A8
// mainloop of quant_small_m.cuh behind act_quant_kernel, the same blocks
// and K slices as gemv; no split-K partials in device memory.
// Probe: the whole grid (at most 4 blocks an SM) streams qweight, then the
// scales and the zero points, each as one range in memory order (K-contiguous
// rows, as K2/K4 read them), 16-byte loads, 8 in flight a thread; every word
// goes into an xor that one word a warp writes out (so no load is dead); then
// the touch, columns by grid stride. An RMSNorm prologue runs ahead of the
// probe (the reference's runs inside it): what the probe times is the
// weight stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "quant_act.cuh"
#include "quant_small_m.cuh"

namespace {

using scalellm_quant::griddep_wait;
using scalellm_quant::kPrepThreads;
using scalellm_quant::kSmThreads;
using scalellm_quant::kSmChunkK;
using scalellm_quant::kSmWarps;
using scalellm_quant::load_f32_or_bf16;
using scalellm_quant::piece_map;
using scalellm_quant::prep_kernel;
using scalellm_quant::sm_consume;
using scalellm_quant::sm_prefetch_weights;
using scalellm_quant::sm_produce;
using scalellm_quant::sm_reduce_slices;
using scalellm_quant::sm_row_warps;
using scalellm_quant::sm_ring;
using scalellm_quant::sm_smem_bytes;
using scalellm_quant::sm_stage;
using scalellm_quant::sm_stages;
using scalellm_quant::sm_tiles;
using scalellm_quant::sm_w4a8_block;
using scalellm_quant::SmJob;
using scalellm_quant::SmRing;
using scalellm_quant::SmStage;
using scalellm_quant::SmW4a8Kernel;
using scalellm_quant::tensor_map;

typedef __nv_bfloat16 bf16;

// ------------------------------------------------------------ gemv (K12a)

// One block: the 2 * rh weight rows from blockIdx.x * 2 * rh (rh = 8 rw)
// for every token, over all of K, on the small-M mainloop (rw row warps
// times ks K slices, then the producer warp); its K slices' sums added in
// slice order, then bf16 out.
template <int BITS, int NT, bool SPAN32>
__global__ void __launch_bounds__(kSmThreads, NT <= 4 ? 2 : 1) gemv_kernel(
    const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap w_map,
    const __grid_constant__ CUtensorMap xs_map, const void* __restrict__ scales, int scales_bf16,
    const int8_t* __restrict__ zeros, bf16* __restrict__ out, int M, int K, int N, int G, int rw, int ks,
    int stages, int slot_bytes) {
  extern __shared__ uint8_t smem_raw[];
  const SmRing ring = sm_ring(smem_raw, stages, slot_bytes, rw * ks);
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0), lane = threadIdx.x & 31;
  SmJob j;
  j.xmap = &x_map;
  j.wmap = &w_map;
  j.xsmap = zeros != nullptr ? &xs_map : nullptr;
  j.scales = scales;
  j.zeros = zeros;
  j.ld = N;
  j.rw = rw;
  j.ks = ks;
  const int rh = 8 * j.rw;
  const int n0 = blockIdx.x * 2 * rh;
  j.row_a = n0;
  j.row_b = n0 + rh;
  j.valid_a = max(0, min(rh, N - j.row_a));
  j.valid_b = max(0, min(rh, N - j.row_b));
  j.K = K;
  j.G = G;
  j.span = SPAN32 ? 32 : 128;
  j.parts = 1;
  j.st = sm_stage(BITS, NT, j.rw, ks, j.span, 1);
  int g = 0;
  if (warp == rw * ks) {  // the producer warp
    sm_prefetch_weights<BITS>(j, stages, lane);
    griddep_wait();  // behind a pre-pass: its x and sums
    sm_produce<NT, BITS>(j, ring.ring, slot_bytes, stages, ring.full, ring.empty, g, M, scales_bf16, lane);
    return;
  }
  float acc[NT][4];
  sm_consume<NT, BITS, SPAN32>(j, ring.ring, slot_bytes, stages, ring.full, ring.empty, g, M, warp, lane,
                               scales_bf16, acc);
  sm_reduce_slices<NT>(acc, ring.red, j.rw, ks, warp, lane);
  if (warp / j.rw != 0) return;
  const int r = 8 * (warp % j.rw) + (lane >> 2), tig = lane & 3;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int t = 8 * n + 2 * tig + e;
      if (t >= M) continue;
      if (r < j.valid_a) out[(size_t)t * N + j.row_a + r] = __float2bfloat16_rn(acc[n][e]);
      if (r < j.valid_b) out[(size_t)t * N + j.row_b + r] = __float2bfloat16_rn(acc[n][2 + e]);
    }
}

// ------------------------------------------------------------ w4a8g (K12b)

// The W4A8 mainloop of quant_small_m.cuh with K12b's fold: each span's sum
// times its activation scale. NT: token tiles of 8 (1, 2, 4, 8).
template <int BITS, int NT>
__global__ void __launch_bounds__(kSmThreads, NT <= 4 ? 2 : 1) w4a8g_kernel(
    const __grid_constant__ CUtensorMap w_map, const int8_t* __restrict__ xq, const float* __restrict__ xs,
    const void* __restrict__ scales, int scales_bf16, const int8_t* __restrict__ zeros, bf16* __restrict__ out, int M,
    int K, int N, int G, int block_k, int rw, int ks, int stages, int slot_bytes) {
  extern __shared__ uint8_t smem_raw[];
  sm_w4a8_block<BITS, NT, false>(smem_raw, &w_map, xq, xs, scales, scales_bf16, zeros, out, M, K, N, G,
                                 block_k, rw, ks, stages, slot_bytes);
}

SmW4a8Kernel w4a8g_kernel_for(int bits, int nt) {
  switch (nt) {
    case 1: return bits == 4 ? w4a8g_kernel<4, 1> : w4a8g_kernel<8, 1>;
    case 2: return bits == 4 ? w4a8g_kernel<4, 2> : w4a8g_kernel<8, 2>;
    case 4: return bits == 4 ? w4a8g_kernel<4, 4> : w4a8g_kernel<8, 4>;
    default: return bits == 4 ? w4a8g_kernel<4, 8> : w4a8g_kernel<8, 8>;
  }
}

// ------------------------------------------------------------ stream probe (K12c)

constexpr int kStreamThreads = 256;

__device__ __forceinline__ uint32_t warp_xor(uint32_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v ^= __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The xor of the 32-bit words of `bytes` bytes at p (4-byte aligned), by
// every thread of the grid in memory order, 8 loads in flight a thread.
__device__ __forceinline__ uint32_t fold_words(const void* p, size_t bytes, size_t first,
                                               size_t stride) {
  uint32_t fold = 0;
  const size_t n_vec = bytes / 16;
  const uint4* v = static_cast<const uint4*>(p);
#pragma unroll 8
  for (size_t i = first; i < n_vec; i += stride) {
    const uint4 w = __ldg(v + i);
    fold ^= w.x ^ w.y ^ w.z ^ w.w;
  }
  const unsigned char* tail = static_cast<const unsigned char*>(p) + n_vec * 16;
  for (size_t i = first; i < bytes % 16; i += stride) fold ^= tail[i];
  return fold;
}

__global__ void __launch_bounds__(kStreamThreads) stream_probe_kernel(
    const bf16* __restrict__ x, const uint8_t* __restrict__ qw, const void* __restrict__ scales,
    int scales_bf16, const int8_t* __restrict__ zeros, bf16* __restrict__ out,
    uint32_t* __restrict__ sink, int M, int K, int N, int G, int bits, int block_k,
    int weights_only) {
  const int tid = threadIdx.x;
  const size_t first = (size_t)blockIdx.x * kStreamThreads + tid;
  const size_t stride = (size_t)gridDim.x * kStreamThreads;
  const size_t row_bytes = bits == 4 ? (size_t)K / 2 : (size_t)K;
  const size_t n_g = (size_t)(K / G);

  // Every byte of qweight (K-contiguous rows, one column after another),
  // then of the scales and the zero points, streamed by the whole grid.
  uint32_t fold = fold_words(qw, (size_t)N * row_bytes, first, stride);
  if (!weights_only) fold ^= fold_words(scales, n_g * N * (scales_bf16 ? 2 : 4), first, stride);
  if (zeros != nullptr) fold ^= fold_words(zeros, n_g * N, first, stride);
  fold = warp_xor(fold);
  if ((tid & 31) == 0) sink[(size_t)blockIdx.x * (kStreamThreads / 32) + (tid >> 5)] = fold;

  // The touch, columns by grid stride.
  const int pack = bits == 4 ? 2 : 1;
  for (size_t n = first; n < (size_t)N; n += stride) {
    float acc = 0.f;
    for (int kb = 0; kb < K / block_k; ++kb) {
      const int k = kb * block_k;
      const size_t gi = (size_t)(k / G) * N + n;
      const float q = (float)(int8_t)qw[n * row_bytes + k / pack];
      const float s = weights_only ? 1.f : load_f32_or_bf16(scales, gi, scales_bf16);
      const float xc = __bfloat162float(x[k]);
      // As XLA evaluates the TPU probe: the product and the addition after
      // it as one fused multiply-add, every other step rounded on its own.
      const float t = zeros != nullptr ? __fadd_rn(__fmaf_rn(q, s, (float)zeros[gi]), xc)
                                       : __fmaf_rn(q, s, xc);
      acc = __fadd_rn(acc, t);
    }
    const bf16 o = __float2bfloat16_rn(acc);
    for (int m = 0; m < M; ++m) out[(size_t)m * N + n] = o;
  }
}

// ------------------------------------------------------------ launch

// gemv at one instantiation: the stage layout, the ring's depth for the
// blocks an SM the registers allow (2 up to NT = 4), the tensor maps (x:
// the stage's pieces of [8 NT tokens, xk K] in one box; weights: [rh rows,
// 128 bytes], 128-byte swizzle; sums of x: the stage's rows), one block per
// 2 * rh weight rows.
template <int BITS, int NT, bool SPAN32>
int launch_gemv(const bf16* x, const void* qweight, const void* scales, const void* zeros, const float* xsum,
                void* out, int M, int K, int N, int G, int scales_bf16, int ks, bool after_prep, cudaStream_t st) {
  const auto kernel = gemv_kernel<BITS, NT, SPAN32>;
  const int rw = ks == 1 ? sm_row_warps(N) : kSmWarps / ks, rh = 8 * rw;
  const int span = SPAN32 ? 32 : 128;
  const SmStage s = sm_stage(BITS, NT, rw, ks, span, 1);
  const int red = (ks - 1) * rw * NT * 4 * 32 * 4;
  const int blocks = (N + 2 * rh - 1) / (2 * rh);
  const int stages = sm_stages(s.bytes, red, NT <= 4 ? 2 : 1);
  static bool smem_set = false;  // once per instantiation
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  CUtensorMap x_map, w_map, xs_map = {};
  if (!piece_map(&x_map, x, M, K, s.xk, M, kSmChunkK * s.cps / s.xk) ||
      !tensor_map(&w_map, qweight, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, N, K * BITS / 8, rh, 128,
                  CU_TENSOR_MAP_SWIZZLE_128B) ||
      (zeros != nullptr && !tensor_map(&xs_map, xsum, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, K / span, 8 * NT,
                                       s.xs_rows, 8 * NT, CU_TENSOR_MAP_SWIZZLE_NONE)))
    return (int)cudaErrorInvalidValue;
  // Behind a pre-pass the grid is launched as its programmatic dependent:
  // it starts while the pre-pass runs, prefetches its first weight stages
  // into L2, and waits for the pre-pass before it reads x.
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(32 * (rw * ks + 1));
  cfg.dynamicSmemBytes = sm_smem_bytes(stages, s.bytes, red);
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = after_prep ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, x_map, w_map, xs_map, scales, scales_bf16,
                                           static_cast<const int8_t*>(zeros), static_cast<bf16*>(out), M, K, N, G,
                                           rw, ks, stages, s.bytes);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each launches on `stream` and
// returns cudaGetLastError() (0 on success); none synchronises or allocates.

// xn bf16 [M, K] (with rms_gamma) and xsum f32 [K / span, M padded to 8,
// 16, 32 or 64] (with zeros; span 128 where G % 128 == 0, else 32) are
// scratch. k_slices: the K slices
// of a block (1, 2 or 4; the wrapper's small_m_slices). M <= 64, G % 32 ==
// 0, K % 128 == 0; x and qweight 16-byte aligned (TMA).
extern "C" int scalellm_quant_gemv(
    const void* x, const void* qweight, const void* scales, const void* zeros,
    const void* rms_gamma, void* xn, void* xsum, void* out, int M, int K, int N,
    int group_size, int bits, int scales_bf16, int gamma_bf16, int k_slices, float rms_eps,
    void* stream) {
  if (M <= 0 || N <= 0) return 0;
  const int G = group_size;
  if ((bits != 4 && bits != 8) || M > 64 || G <= 0 || G % 32 != 0 || K % G != 0 || K % 128 != 0 ||
      (k_slices != 1 && k_slices != 2 && k_slices != 4) || (rms_gamma != nullptr && xn == nullptr) ||
      (zeros != nullptr && xsum == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const bool span32 = G % 128 != 0;
  const bool prep = rms_gamma != nullptr || zeros != nullptr;
  if (prep) {
    prep_kernel<<<M, kPrepThreads, 0, st>>>(
        static_cast<const bf16*>(x), rms_gamma, gamma_bf16, rms_eps,
        rms_gamma != nullptr ? static_cast<bf16*>(xn) : nullptr,
        zeros != nullptr ? static_cast<float*>(xsum) : nullptr, M, K, span32 ? 32 : 128, 8 * sm_tiles(M));
    const int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
  }
  const bf16* xin = static_cast<const bf16*>(rms_gamma != nullptr ? xn : x);
  const float* xs = zeros != nullptr ? static_cast<const float*>(xsum) : nullptr;
  const int nt = sm_tiles(M);
#define SCALELLM_GEMV(BITS, NT)                                                                     \
  return span32 ? launch_gemv<BITS, NT, true>(xin, qweight, scales, zeros, xs, out, M, K, N, G,   \
                                              scales_bf16, k_slices, prep, st)                    \
                : launch_gemv<BITS, NT, false>(xin, qweight, scales, zeros, xs, out, M, K, N, G,  \
                                               scales_bf16, k_slices, prep, st)
#define SCALELLM_GEMV_NT(BITS)                  \
  switch (nt) {                                 \
    case 1: SCALELLM_GEMV(BITS, 1);             \
    case 2: SCALELLM_GEMV(BITS, 2);             \
    case 4: SCALELLM_GEMV(BITS, 4);             \
    default: SCALELLM_GEMV(BITS, 8);            \
  }
  if (bits == 4) {
    SCALELLM_GEMV_NT(4)
  } else {
    SCALELLM_GEMV_NT(8)
  }
#undef SCALELLM_GEMV_NT
#undef SCALELLM_GEMV
  return (int)cudaErrorInvalidValue;
}

// xq s8 [K / 32, M padded to 8, 16, 32 or 64, 32] and xs f32 [K / 64, M
// padded] (xq in 32-K pieces, and per 128-K span the int32 sums of xq and
// the activation scales, as the ring's stages take them) are scratch;
// k_slices as for gemv. M <= 64, G % 128 == 0, block_k a multiple of G that
// divides K, K <= 32768; x and qweight 16-byte aligned (TMA).
extern "C" int scalellm_quant_w4a8_gemv(
    const void* x, const void* qweight, const void* scales, const void* zeros,
    const void* rms_gamma, void* xq, void* xs, void* out, int M, int K, int N,
    int group_size, int bits, int scales_bf16, int gamma_bf16, int block_k, int k_slices, float rms_eps,
    void* stream) {
  if (M <= 0 || N <= 0) return 0;
  const int G = group_size;
  if ((bits != 4 && bits != 8) || M > 64 || G <= 0 || G % 128 != 0 || K % G != 0 || block_k <= 0 ||
      block_k % G != 0 || K % block_k != 0 || K > 32 * 1024 || (k_slices != 1 && k_slices != 2 && k_slices != 4))
    return (int)cudaErrorInvalidValue;
  return scalellm_quant::sm_w4a8_call(w4a8g_kernel_for, x, qweight, scales, zeros, rms_gamma, xq, xs, out, M, K,
                                      N, G, bits, scales_bf16, gamma_bf16, block_k, k_slices, rms_eps,
                                      reinterpret_cast<cudaStream_t>(stream));
}

// sink u32 [blocks * 8] receives the xor of the words each warp read;
// `blocks` is the grid (the caller sizes it to the card). qweight 16-byte
// aligned, scales and zeros 4-byte aligned. The RMSNorm prologue, where the
// call has one, runs ahead of the probe: what the probe times is the stream.
extern "C" int scalellm_quant_stream_probe(
    const void* x, const void* qweight, const void* scales, const void* zeros, void* sink,
    void* out, int M, int K, int N, int group_size, int bits, int scales_bf16, int block_k,
    int weights_only, int blocks, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  const int G = group_size;
  if ((bits != 4 && bits != 8) || G <= 0 || K % G != 0 || block_k <= 0 || K % block_k != 0 ||
      block_k % G != 0 || blocks <= 0 || reinterpret_cast<uintptr_t>(qweight) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(scales) % 4 != 0 || reinterpret_cast<uintptr_t>(zeros) % 4 != 0)
    return (int)cudaErrorInvalidValue;
  stream_probe_kernel<<<blocks, kStreamThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const uint8_t*>(qweight), scales, scales_bf16,
      static_cast<const int8_t*>(zeros), static_cast<bf16*>(out), static_cast<uint32_t*>(sink),
      M, K, N, G, bits, block_k, weights_only);
  return (int)cudaGetLastError();
}
