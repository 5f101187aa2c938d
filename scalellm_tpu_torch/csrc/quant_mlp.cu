// Fused weight-only quantized MLP for decode, for Hopper (sm_90a):
// gate_up -> act(gate) * up -> down in one call.
//
// Replaces scalellm_tpu/ops/quant_mlp.py:_mlp_kernel (:78, pallas_call :222).
// Plain PyTorch version: plain_quant_mlp in scalellm_tpu_torch/ops/quant_mlp.py.
//
// Layout (the port's kernel layout, ops/quant_matmul.py):
//   x        bf16 [M, D], M <= 64
//   gate_up  qweight [2F, D/2] (int4) or [2F, D] (int8): rows [0, F) gate,
//            [F, 2F) up; scales f32/bf16 [D/G, 2F]; zeros s8 [D/G, 2F] or null
//   down     qweight [D, F/2] or [D, F]; scales [F/G, D]; zeros [F/G, D] or null
//   out      f32 [M, D]
//
// What it computes:
//   g, u = the gate and up columns as quant_gemv.cu's gemv computes them:
//          per span of D (128 where G % 128 == 0, else 32) the f32 dot of
//          bf16 x with the integer weights, (dot - xsum * zero) * scale,
//          spans summed in f32;
//   h    = bf16(act(g) * u), act in f32: silu, or gelu in its tanh form
//          (the TPU op's table maps "gelu" to jax.nn.gelu, which is tanh);
//   out  = h times down the same way, over spans of F (xsum: the f32 sums of
//          h over the span, added from its 32-column parts in order), f32.
// The result does not depend on the run: no atomics.
//
// What bounds it on an H100: at Llama-3.1-8B's widths (D 4096, F 14336,
// int4, G 128) the weights and scales are 91 MB, 27 us at 3.35 TB/s; the
// products, 2 * 3 * M * D * F flops, are 5.6 GFLOP at M = 16, 6 us at 989
// TFLOP/s on the tensor cores.
//
// Design: one cooperative launch, its grid the blocks that can be
// co-resident (the launch fails, and the wrapper raises, where they cannot
// all be), on the small-M mainloop of quant_small_m.cuh (mma.sync on
// weights unpacked in registers, a TMA ring of weights and activations, a
// producer warp):
//   phase 1: items of 64 columns of F; an item is 64 gate rows and their 64
//     up rows, each warp's 16 rows being 8 gate rows and the same 8 up rows,
//     so a thread holds g and u of its column. h goes to a buffer [M, F]
//     (0.46 MB at M = 16, read again from L2) and, with zero points, the
//     sums of h over each 32 columns;
//   a grid barrier (cooperative_groups::this_grid().sync());
//   phase 2: items of 128 / KS rows of down over all of F (KS K slices of 8
//     / KS row warps, their sums added in slice order in shared memory),
//     written as rows of out.
// No f32 partials, no second kernel, and no limit on D from shared memory.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "quant_small_m.cuh"

namespace {

using scalellm_quant::kPrepThreads;
using scalellm_quant::kSmThreads;
using scalellm_quant::kSmChunkK;
using scalellm_quant::kSmWarps;
using scalellm_quant::piece_map;
using scalellm_quant::prep_kernel;
using scalellm_quant::sm_consume;
using scalellm_quant::sm_count;
using scalellm_quant::sm_consumer_sync;
using scalellm_quant::sm_prefetch_weights;
using scalellm_quant::sm_produce;
using scalellm_quant::sm_reduce_slices;
using scalellm_quant::sm_ring;
using scalellm_quant::sm_smem_bytes;
using scalellm_quant::sm_stage;
using scalellm_quant::sm_stages;
using scalellm_quant::sm_tiles;
using scalellm_quant::SmJob;
using scalellm_quant::SmRing;
using scalellm_quant::SmStage;
using scalellm_quant::tensor_map;

typedef __nv_bfloat16 bf16;

constexpr int kItemF = 64;  // columns of F a phase-1 item: 8 a row warp

__device__ __forceinline__ float activation(float g, int act) {
  if (act == 0) return g * (1.f / (1.f + expf(-g)));  // silu: g * sigmoid(g)
  const float c = 0.7978845608028654f;                // sqrt(2 / pi)
  return g * (0.5f * (1.f + tanhf(c * (g + 0.044715f * (g * g * g)))));
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

template <int BITS, int NT, bool SPAN32>
__global__ void __launch_bounds__(kSmThreads, NT <= 4 ? 2 : 1) mlp_kernel(
    const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap gu_map,
    const __grid_constant__ CUtensorMap h_map, const __grid_constant__ CUtensorMap dn_map,
    const __grid_constant__ CUtensorMap xs_map, const __grid_constant__ CUtensorMap hs_map,
    const void* __restrict__ gu_s, const int8_t* __restrict__ gu_z, const void* __restrict__ dn_s,
    const int8_t* __restrict__ dn_z, int scales_bf16, bf16* __restrict__ h, float* __restrict__ hsum,
    float* __restrict__ out, int M, int D, int F, int G, int act, int ks2, int stages, int slot_bytes) {
  extern __shared__ uint8_t smem_raw[];
  const SmRing ring = sm_ring(smem_raw, stages, slot_bytes, kSmWarps);
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0), lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int span = SPAN32 ? 32 : 128;
  const cooperative_groups::grid_group grid = cooperative_groups::this_grid();

  SmJob j1;  // gate_up: rows f0 + [0, 64) (gate) and F + f0 + [0, 64) (up) over D
  j1.xmap = &x_map;
  j1.wmap = &gu_map;
  j1.xsmap = gu_z != nullptr ? &xs_map : nullptr;
  j1.scales = gu_s;
  j1.zeros = gu_z;
  j1.ld = 2 * F;
  j1.rw = kSmWarps;
  j1.ks = 1;
  j1.valid_a = j1.valid_b = kItemF;
  j1.K = D;
  j1.G = G;
  j1.span = span;
  j1.parts = 1;
  j1.st = sm_stage(BITS, NT, j1.rw, 1, span, 1);
  SmJob j2;  // down: rows n0 + [0, 2 rh) over F
  j2.xmap = &h_map;
  j2.wmap = &dn_map;
  j2.xsmap = dn_z != nullptr ? &hs_map : nullptr;
  j2.scales = dn_s;
  j2.zeros = dn_z;
  j2.ld = D;
  j2.rw = kSmWarps / ks2;
  j2.ks = ks2;
  j2.K = F;
  j2.G = G;
  j2.span = span;
  j2.parts = span / 32;
  j2.st = sm_stage(BITS, NT, j2.rw, ks2, span, j2.parts);
  const int rh2 = 8 * j2.rw;
  const int items1 = F / kItemF, items2 = (D + 2 * rh2 - 1) / (2 * rh2);
  auto item1 = [&](int i) {
    j1.row_a = i * kItemF;
    j1.row_b = F + i * kItemF;
  };
  auto item2 = [&](int i) {
    j2.row_a = i * 2 * rh2;
    j2.row_b = j2.row_a + rh2;
    j2.valid_a = max(0, min(rh2, D - j2.row_a));
    j2.valid_b = max(0, min(rh2, D - j2.row_b));
  };

  int g = 0;  // the block's running ring stage, the same in producer and consumers
  if (warp == kSmWarps) {  // the producer warp
    for (int i = blockIdx.x; i < items1; i += gridDim.x) {
      item1(i);
      sm_produce<NT, BITS>(j1, ring.ring, slot_bytes, stages, ring.full, ring.empty, g, M, scales_bf16, lane);
    }
    if (blockIdx.x < items2) {  // down's first stages into L2 while the other blocks finish h
      item2(blockIdx.x);
      sm_prefetch_weights<BITS>(j2, stages, lane);
    }
    grid.sync();
    fence_proxy_async();  // h and hsum, written by the other blocks, before the TMA reads them
    for (int i = blockIdx.x; i < items2; i += gridDim.x) {
      item2(i);
      sm_produce<NT, BITS>(j2, ring.ring, slot_bytes, stages, ring.full, ring.empty, g, M, scales_bf16, lane);
    }
    return;
  }

  float acc[NT][4];
  for (int i = blockIdx.x; i < items1; i += gridDim.x) {
    item1(i);
    sm_consume<NT, BITS, SPAN32>(j1, ring.ring, slot_bytes, stages, ring.full, ring.empty, g, M, warp, lane,
                                 scales_bf16, acc);
    // acc[n][e]: gate of column f, acc[n][2 + e]: its up; tokens 8 n + 2 tig + e.
    const int f = i * kItemF + 8 * warp + gid;
    float hv[NT][2];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int t = 8 * n + 2 * tig + e;
        const bf16 hb = __float2bfloat16_rn(activation(acc[n][e], act) * acc[n][2 + e]);
        hv[n][e] = __bfloat162float(hb);
        if (t < M) h[(size_t)t * F + f] = hb;
      }
    if (gu_z != nullptr) {
      // The sums of h over each 32 columns (4 row warps of 8): a warp's 8
      // by shuffles, then the 4 warps' in order.
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v = hv[n][e];
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
          if (gid == 0) ring.red[warp * 8 * NT + 8 * n + 2 * tig + e] = v;
        }
      sm_consumer_sync(kSmWarps);
      for (int q = threadIdx.x; q < 2 * M; q += 32 * kSmWarps) {
        const int p = q / M, t = q % M;
        const float* rr = ring.red + 4 * p * 8 * NT + t;
        hsum[(size_t)(2 * i + p) * 8 * NT + t] = ((rr[0] + rr[8 * NT]) + rr[16 * NT]) + rr[24 * NT];
      }
      sm_consumer_sync(kSmWarps);
    }
  }
  fence_proxy_async();
  grid.sync();

  for (int i = blockIdx.x; i < items2; i += gridDim.x) {
    item2(i);
    sm_consume<NT, BITS, SPAN32>(j2, ring.ring, slot_bytes, stages, ring.full, ring.empty, g, M, warp, lane,
                                 scales_bf16, acc);
    sm_reduce_slices<NT>(acc, ring.red, j2.rw, ks2, warp, lane);
    if (warp / j2.rw != 0) continue;
    const int r = 8 * (warp % j2.rw) + gid;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int t = 8 * n + 2 * tig + e;
        if (t >= M) continue;
        if (r < j2.valid_a) out[(size_t)t * D + j2.row_a + r] = acc[n][e];
        if (r < j2.valid_b) out[(size_t)t * D + j2.row_b + r] = acc[n][2 + e];
      }
  }
}

// One instantiation: both phases' stage layouts (the ring's slot is the
// larger), the ring's depth for the blocks an SM the registers allow, the
// grid from the occupancy the launch can have, the four tensor maps, one
// cooperative launch.
template <int BITS, int NT, bool SPAN32>
int launch_mlp(const bf16* x, const void* gu_q, const void* gu_s, const void* gu_z, const void* dn_q,
               const void* dn_s, const void* dn_z, int scales_bf16, const float* xsum, bf16* h, float* hsum,
               float* out, int M, int D, int F, int G, int act, int ks2, cudaStream_t st) {
  constexpr int kPad = 8 * NT;
  const auto kernel = mlp_kernel<BITS, NT, SPAN32>;
  const int span = SPAN32 ? 32 : 128;
  const int rw2 = kSmWarps / ks2;
  const SmStage s1 = sm_stage(BITS, NT, kSmWarps, 1, span, 1);
  const SmStage s2 = sm_stage(BITS, NT, rw2, ks2, span, span / 32);
  int slot = s1.bytes > s2.bytes ? s1.bytes : s2.bytes;
  const int red_slices = (ks2 - 1) * rw2 * NT * 4 * 32 * 4, red_h = kSmWarps * 8 * NT * 4;
  const int red = red_slices > red_h ? red_slices : red_h;
  int stages = sm_stages(slot, red, NT <= 4 ? 2 : 1);
  int smem = sm_smem_bytes(stages, slot, red);
  static bool smem_set = false;  // once per instantiation
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  const int sms = sm_count();
  int per_sm = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kSmThreads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;  // no grid barrier to be had
  const int items1 = F / kItemF, items2 = (D + 16 * rw2 - 1) / (16 * rw2);
  const int want = items1 > items2 ? items1 : items2;
  const int blocks = per_sm * sms < want ? per_sm * sms : want;
  CUtensorMap x_map, gu_map, h_map, dn_map, xs_map = {}, hs_map = {};
  const bool asym = gu_z != nullptr;
  if (!piece_map(&x_map, x, M, D, s1.xk, M, kSmChunkK * s1.cps / s1.xk) ||
      !tensor_map(&gu_map, gu_q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, 2 * F, D * BITS / 8, s1.rh, 128,
                  CU_TENSOR_MAP_SWIZZLE_128B) ||
      !piece_map(&h_map, h, M, F, s2.xk, M, kSmChunkK * s2.cps / s2.xk) ||
      !tensor_map(&dn_map, dn_q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, D, F * BITS / 8, s2.rh, 128,
                  CU_TENSOR_MAP_SWIZZLE_128B) ||
      (asym && (!tensor_map(&xs_map, xsum, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, D / span, kPad, s1.xs_rows, kPad,
                            CU_TENSOR_MAP_SWIZZLE_NONE) ||
                !tensor_map(&hs_map, hsum, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, F / 32, kPad, s2.xs_rows, kPad,
                            CU_TENSOR_MAP_SWIZZLE_NONE))))
    return (int)cudaErrorInvalidValue;
  const int8_t* guz = static_cast<const int8_t*>(gu_z);
  const int8_t* dnz = static_cast<const int8_t*>(dn_z);
  void* args[] = {&x_map, &gu_map, &h_map, &dn_map, &xs_map, &hs_map, &gu_s, &guz, &dn_s, &dnz,
                  &scales_bf16, &h, &hsum, &out, &M, &D, &F, &G, &act, &ks2, &stages, &slot};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(blocks), dim3(kSmThreads), args,
                                  (size_t)smem, st);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. Launches on `stream` and returns
// the CUDA error code (0 on success); does not synchronise or allocate.
// Scratch: h bf16 [M, F]; with zero points xsum f32 [D / span, Mp] (span 128
// where G % 128 == 0, else 32) and hsum f32 [F / 32, Mp] (null without), Mp
// being M padded to 8, 16, 32 or 64.
// M <= 64, G % 32 == 0, D and F multiples of 128 and of G; act: 0 silu, 1
// gelu (tanh form); k_slices: the K slices of a down block (1, 2 or 4; the
// wrapper's small_m_slices). x, both qweights and h 16-byte aligned (TMA).
extern "C" int scalellm_quant_mlp(
    const void* x, const void* gu_qweight, const void* gu_scales, const void* gu_zeros,
    const void* dn_qweight, const void* dn_scales, const void* dn_zeros, void* xsum, void* h, void* hsum,
    void* out, int M, int D, int F, int group_size, int bits, int scales_bf16, int act, int k_slices,
    void* stream) {
  if (M <= 0 || D <= 0) return 0;
  const int G = group_size;
  const bool asym = gu_zeros != nullptr;
  if ((bits != 4 && bits != 8) || M > 64 || G <= 0 || G % 32 != 0 || D % 128 != 0 || F <= 0 || F % 128 != 0 ||
      D % G != 0 || F % G != 0 || (act != 0 && act != 1) || (k_slices != 1 && k_slices != 2 && k_slices != 4) ||
      asym != (dn_zeros != nullptr) || h == nullptr || (asym && (xsum == nullptr || hsum == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const bool span32 = G % 128 != 0;
  if (asym) {  // the sums of x over each span of D
    prep_kernel<<<M, kPrepThreads, 0, st>>>(static_cast<const bf16*>(x), nullptr, 0, 0.f, nullptr,
                                            static_cast<float*>(xsum), M, D, span32 ? 32 : 128,
                                            8 * sm_tiles(M));
    const int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
  }
  const float* xs = asym ? static_cast<const float*>(xsum) : nullptr;
  float* hs = asym ? static_cast<float*>(hsum) : nullptr;
  const int nt = sm_tiles(M);
#define SCALELLM_MLP(BITS, NT)                                                                                 \
  return span32 ? launch_mlp<BITS, NT, true>(static_cast<const bf16*>(x), gu_qweight, gu_scales, gu_zeros,    \
                                             dn_qweight, dn_scales, dn_zeros, scales_bf16, xs,                \
                                             static_cast<bf16*>(h), hs, static_cast<float*>(out), M, D, F, G, \
                                             act, k_slices, st)                                               \
                : launch_mlp<BITS, NT, false>(static_cast<const bf16*>(x), gu_qweight, gu_scales, gu_zeros,   \
                                              dn_qweight, dn_scales, dn_zeros, scales_bf16, xs,               \
                                              static_cast<bf16*>(h), hs, static_cast<float*>(out), M, D, F,   \
                                              G, act, k_slices, st)
#define SCALELLM_MLP_NT(BITS)      \
  switch (nt) {                    \
    case 1: SCALELLM_MLP(BITS, 1); \
    case 2: SCALELLM_MLP(BITS, 2); \
    case 4: SCALELLM_MLP(BITS, 4); \
    default: SCALELLM_MLP(BITS, 8); \
  }
  if (bits == 4) {
    SCALELLM_MLP_NT(4)
  } else {
    SCALELLM_MLP_NT(8)
  }
#undef SCALELLM_MLP_NT
#undef SCALELLM_MLP
  return (int)cudaErrorInvalidValue;
}
