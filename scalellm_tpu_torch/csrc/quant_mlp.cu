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
// What it computes, per slice of BF = max(128, G) columns of F:
//   g, u = the slice's gate and up columns: per span of D (128 where
//          G % 128 == 0, else 32) the f32 dot of bf16 x with the integer
//          weights, (dot - xsum * zero) * scale, spans summed in f32;
//   h    = bf16(act(g) * u), act in f32: silu, or gelu in its tanh form
//          (the TPU op's table maps "gelu" to jax.nn.gelu, which is tanh);
//   part[slice] = per group of the slice's BF rows of down: the f32 dot of h
//          with the weights, (dot - hsum * zero) * scale, in group order;
//   out  = part[0] + part[1] + ..., in slice order (a second kernel).
// h never leaves the block's shared memory; the f32 partials do. The result
// does not depend on the run: no float atomics.
//
// What bounds it on an H100: at Llama-3.1-8B's widths (D 4096, F 14336,
// int4, G 128) the weights and scales are 91 MB, 27 us at 3.35 TB/s; the
// f32 partials add 2 * (F / BF) * M * D * 4 bytes (3.7 MB at M = 1, 59 MB
// at M = 16); from a few rows up the CUDA cores bind it: 3 * M * D * F f32
// FMAs, 84 us at M = 16 at 33.5 T FMA/s.
//
// Design, simple first (no mma, TMA or wgmma yet): one block (8 warps) per
// (slice, tile of up to MT rows); 112 slices at the 8B widths. The block
// stages its rows of x whole in shared memory (16-byte pieces swizzled by
// span, as in quant_gemv.cu), then walks the slice's 2 * BF gate and up
// columns, 4 a warp at a time, 8 lanes a column each reading 128-K spans one
// chunk ahead of their use; the 8 lanes add their sums by shuffles. Then h
// in f32 (its bf16 values) in shared memory, read by every thread at once,
// while each thread owns one output column of down and walks the slice's
// rows of it, one pass of 256 columns ahead.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "quant_act.cuh"
#include "quant_unpack.cuh"

namespace {

using scalellm_quant::load_f32_or_bf16;

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSpanK = 128;
constexpr int kLanesPerCol = 8;
constexpr int kColsPerWarp = 32 / kLanesPerCol;
constexpr int kChunkK = kLanesPerCol * kSpanK;

__device__ __forceinline__ int swz(int q) { return q ^ ((q >> 4) & 7); }

__device__ __forceinline__ void bf16x8_to_float(const uint4& v, float (&f)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 t = __bfloat1622float2(p[j]);
    f[2 * j] = t.x;
    f[2 * j + 1] = t.y;
  }
}

// Eight weights of K order: int4 from one 32-bit word, int8 from two.
template <int BITS>
__device__ __forceinline__ void weights8(const uint4* v, int step, float (&f)[8]) {
  if (BITS == 4) {
    const uint4& w = v[step / 4];
    const uint32_t word = (step & 3) == 0 ? w.x : (step & 3) == 1 ? w.y : (step & 3) == 2 ? w.z : w.w;
    uint32_t packed[4];
    scalellm_quant::unpack_int4x8(word, __float2bfloat162_rn(136.f), packed);
    bf16x8_to_float(make_uint4(packed[0], packed[1], packed[2], packed[3]), f);
  } else {
    const uint4& w = v[step / 2];
    const uint32_t lo = (step & 1) ? w.z : w.x, hi = (step & 1) ? w.w : w.y;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      f[j] = (float)(int8_t)((lo >> (8 * j)) & 0xFFu);
      f[4 + j] = (float)(int8_t)((hi >> (8 * j)) & 0xFFu);
    }
  }
}

__device__ __forceinline__ float activation(float g, int act) {
  if (act == 0) return g * (1.f / (1.f + expf(-g)));  // silu: g * sigmoid(g)
  const float c = 0.7978845608028654f;                // sqrt(2 / pi)
  return g * (0.5f * (1.f + tanhf(c * (g + 0.044715f * (g * g * g)))));
}

// Dynamic shared memory: x [MT][D] bf16 (swizzled pieces), gu [MT][2 BF]
// f32, h [MT][BF] f32, hsum [MT][BF / G] f32.
template <int MT, int BITS, bool ASYM>
__global__ void __launch_bounds__(kThreads) mlp_kernel(
    const bf16* __restrict__ x, const uint8_t* __restrict__ gu_q, const void* __restrict__ gu_s,
    const int8_t* __restrict__ gu_z, const uint8_t* __restrict__ dn_q,
    const void* __restrict__ dn_s, const int8_t* __restrict__ dn_z, int scales_bf16,
    float* __restrict__ part, int M, int D, int F, int G, int BF, int act) {
  constexpr int kVecs = BITS == 4 ? 4 : 8;  // 16-byte words of a 128-K span
  constexpr int kSubs = kSpanK / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  const int pieces = D / 8;
  uint4* xs = reinterpret_cast<uint4*>(smem);
  float* gu = reinterpret_cast<float*>(smem + (size_t)MT * D * 2);
  float* hs = gu + MT * 2 * BF;
  float* hsum = hs + MT * BF;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_mt = (M + MT - 1) / MT;
  const int mt = blockIdx.x % n_mt, slice = blockIdx.x / n_mt;
  const int m0 = mt * MT, rows = min(MT, M - m0);
  const int f0 = slice * BF;
  const int span = G % kSpanK == 0 ? kSpanK : 32;
  const int steps_per_sub = span / 8;

  for (int i = tid; i < MT * pieces; i += kThreads) {
    const int r = i / pieces, q = i % pieces;
    xs[r * pieces + swz(q)] =
        r < rows ? __ldg(reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * D) + q)
                 : make_uint4(0, 0, 0, 0);
  }
  __syncthreads();

  // ---- gate and up: 2 BF columns of gate_up, kWarps * 4 a pass.
  {
    const size_t row_bytes = BITS == 4 ? (size_t)D / 2 : (size_t)D;
    const int n_chunks = (D + kChunkK - 1) / kChunkK;
    const int passes = 2 * BF / (kWarps * kColsPerWarp);
    const int sp = lane % kLanesPerCol;
    auto column = [&](int pass) {
      const int j = pass * kWarps * kColsPerWarp + warp * kColsPerWarp + lane / kLanesPerCol;
      return j < BF ? f0 + j : F + f0 + (j - BF);
    };
    uint4 cur[kVecs], nxt[kVecs];
    float s_cur[kSubs], s_nxt[kSubs], z_cur[kSubs], z_nxt[kSubs];
    auto fetch = [&](int step, uint4 (&v)[kVecs], float (&s)[kSubs], float (&z)[kSubs]) {
      const int col = column(step / n_chunks);
      const int k = (step % n_chunks) * kChunkK + sp * kSpanK;
      const bool ok = k < D;
      const uint4* p = reinterpret_cast<const uint4*>(gu_q + (size_t)col * row_bytes +
                                                      (BITS == 4 ? k / 2 : k));
#pragma unroll
      for (int i = 0; i < kVecs; ++i) v[i] = ok ? __ldg(p + i) : make_uint4(0, 0, 0, 0);
#pragma unroll
      for (int j = 0; j < kSubs; ++j) {
        s[j] = z[j] = 0.f;
        if (ok && j * span < kSpanK) {
          const size_t gi = (size_t)((k + j * span) / G) * (2 * F) + col;
          s[j] = load_f32_or_bf16(gu_s, gi, scales_bf16);
          if (ASYM) z[j] = (float)gu_z[gi];
        }
      }
    };
    const int total = passes * n_chunks;
    fetch(0, cur, s_cur, z_cur);
    float acc[MT];
    for (int step = 0; step < total; ++step) {
      const int chunk = step % n_chunks;
      if (chunk == 0) {
#pragma unroll
        for (int m = 0; m < MT; ++m) acc[m] = 0.f;
      }
      if (step + 1 < total) fetch(step + 1, nxt, s_nxt, z_nxt);
      const int kl = chunk * kChunkK + sp * kSpanK;
      if (kl < D) {
        float d[MT], xsum[MT];
#pragma unroll
        for (int st = 0; st < kSpanK / 8; ++st) {
          if ((st & (steps_per_sub - 1)) == 0) {
#pragma unroll
            for (int m = 0; m < MT; ++m) d[m] = xsum[m] = 0.f;
          }
          float w[8];
          weights8<BITS>(cur, st, w);
          const int q = kl / 8 + st;
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            if (m >= rows) break;
            float xv[8];
            bf16x8_to_float(xs[m * pieces + swz(q)], xv);
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              d[m] = fmaf(xv[j], w[j], d[m]);
              if (ASYM) xsum[m] += xv[j];
            }
          }
          if (((st + 1) & (steps_per_sub - 1)) == 0) {
            // span 32: sub-span st / 4 of the 128 K; span 128: the one span.
            const float s = span == kSpanK ? s_cur[0] : s_cur[st / 4];
            const float z = span == kSpanK ? z_cur[0] : z_cur[st / 4];
#pragma unroll
            for (int m = 0; m < MT; ++m) {
              if (m >= rows) break;
              acc[m] += (ASYM ? d[m] - xsum[m] * z : d[m]) * s;
            }
          }
        }
      }
      if (chunk == n_chunks - 1) {
        // The column is done: its 8 lanes add their sums (fixed order).
        const int pass = step / n_chunks;
        const int j = pass * kWarps * kColsPerWarp + warp * kColsPerWarp + lane / kLanesPerCol;
#pragma unroll
        for (int m = 0; m < MT; ++m) {
#pragma unroll
          for (int o = 1; o < kLanesPerCol; o <<= 1) acc[m] += __shfl_xor_sync(0xffffffffu, acc[m], o);
          if (sp == 0 && m < rows) gu[m * 2 * BF + j] = acc[m];
        }
      }
#pragma unroll
      for (int i = 0; i < kVecs; ++i) cur[i] = nxt[i];
#pragma unroll
      for (int j = 0; j < kSubs; ++j) {
        s_cur[j] = s_nxt[j];
        z_cur[j] = z_nxt[j];
      }
    }
  }
  __syncthreads();

  // ---- h = bf16(act(g) * u), kept as f32; its sums per group of down.
  for (int i = tid; i < MT * BF; i += kThreads) {
    const int m = i / BF, j = i % BF;
    float h = 0.f;
    if (m < rows) {
      const float a = activation(gu[m * 2 * BF + j], act);
      h = __bfloat162float(__float2bfloat16_rn(a * gu[m * 2 * BF + BF + j]));
    }
    hs[i] = h;
  }
  __syncthreads();
  const int n_grp = BF / G;
  if (ASYM) {
    for (int i = tid; i < MT * n_grp; i += kThreads) {
      const int m = i / n_grp, g = i % n_grp;
      float s = 0.f;
      for (int j = 0; j < G; ++j) s += hs[m * BF + g * G + j];
      hsum[i] = s;
    }
    __syncthreads();
  }

  // ---- down: thread t owns output column pass * 256 + t; the slice's BF
  // rows of down are BF / 128 spans of its K-contiguous row.
  {
    const size_t row_bytes = BITS == 4 ? (size_t)F / 2 : (size_t)F;
    const int n_spans = BF / kSpanK;
    const int passes = (D + kThreads - 1) / kThreads;
    const int total = passes * n_spans;
    uint4 cur[kVecs], nxt[kVecs];
    auto fetch = [&](int step, uint4 (&v)[kVecs]) {
      const int d = (step / n_spans) * kThreads + tid;
      const int k = f0 + (step % n_spans) * kSpanK;
      const uint4* p = reinterpret_cast<const uint4*>(dn_q + (size_t)min(d, D - 1) * row_bytes +
                                                      (BITS == 4 ? k / 2 : k));
#pragma unroll
      for (int i = 0; i < kVecs; ++i) v[i] = d < D ? __ldg(p + i) : make_uint4(0, 0, 0, 0);
    };
    fetch(0, cur);
    float out[MT], dot[MT];
    for (int step = 0; step < total; ++step) {
      const int d = (step / n_spans) * kThreads + tid;
      const int sp = step % n_spans;
      if (sp == 0) {
#pragma unroll
        for (int m = 0; m < MT; ++m) out[m] = 0.f;
      }
      if (step + 1 < total) fetch(step + 1, nxt);
#pragma unroll
      for (int st = 0; st < kSpanK / 8; ++st) {
        const int kl = sp * kSpanK + st * 8;  // row of the slice
        if (kl % G == 0) {
#pragma unroll
          for (int m = 0; m < MT; ++m) dot[m] = 0.f;
        }
        float w[8];
        weights8<BITS>(cur, st, w);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          if (m >= rows) break;
          const float4 h0 = *reinterpret_cast<const float4*>(hs + m * BF + kl);
          const float4 h1 = *reinterpret_cast<const float4*>(hs + m * BF + kl + 4);
          float v = dot[m];
          v = fmaf(h0.x, w[0], v);
          v = fmaf(h0.y, w[1], v);
          v = fmaf(h0.z, w[2], v);
          v = fmaf(h0.w, w[3], v);
          v = fmaf(h1.x, w[4], v);
          v = fmaf(h1.y, w[5], v);
          v = fmaf(h1.z, w[6], v);
          v = fmaf(h1.w, w[7], v);
          dot[m] = v;
        }
        if ((kl + 8) % G == 0 && d < D) {
          const int g = (f0 + kl) / G;  // group of down's K
          const size_t gi = (size_t)g * D + d;
          const float s = load_f32_or_bf16(dn_s, gi, scales_bf16);
          const float z = ASYM ? (float)dn_z[gi] : 0.f;
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            if (m >= rows) break;
            out[m] += (ASYM ? dot[m] - hsum[m * n_grp + kl / G] * z : dot[m]) * s;
          }
        }
      }
      if (sp == n_spans - 1 && d < D) {
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          if (m >= rows) break;
          part[((size_t)slice * M + m0 + m) * D + d] = out[m];
        }
      }
#pragma unroll
      for (int i = 0; i < kVecs; ++i) cur[i] = nxt[i];
    }
  }
}

// out = part[0] + part[1] + ..., in slice order.
__global__ void slice_sum_kernel(const float* __restrict__ part, float* __restrict__ out,
                                 int slices, size_t count) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < count;
       i += (size_t)gridDim.x * blockDim.x) {
    float v = part[i];
    for (int s = 1; s < slices; ++s) v += part[(size_t)s * count + i];
    out[i] = v;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. Launches on `stream` and returns
// cudaGetLastError() (0 on success); does not synchronise or allocate.
// part f32 [F / BF, M, D] is scratch, BF = max(128, G). M <= 64, G % 32 ==
// 0 and G divides or is a multiple of 128, F % BF == 0, D % 128 == 0.
// act: 0 silu, 1 gelu (tanh form). MT rows a block: 1, 4, 8 or 16, chosen by
// the caller so that MT rows of x fit in shared memory.
extern "C" int scalellm_quant_mlp(
    const void* x, const void* gu_qweight, const void* gu_scales, const void* gu_zeros,
    const void* dn_qweight, const void* dn_scales, const void* dn_zeros, void* part, void* out,
    int M, int D, int F, int group_size, int bits, int scales_bf16, int act, int rows_tile,
    void* stream) {
  if (M <= 0 || D <= 0) return 0;
  const int G = group_size;
  const int BF = std::max(kSpanK, G);
  const int mt = rows_tile;
  if ((bits != 4 && bits != 8) || M > 64 || G <= 0 || G % 32 != 0 ||
      (kSpanK % G != 0 && G % kSpanK != 0) || F <= 0 || F % BF != 0 || D % kSpanK != 0 ||
      (act != 0 && act != 1) || (mt != 1 && mt != 4 && mt != 8 && mt != 16) ||
      (gu_zeros == nullptr) != (dn_zeros == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)mt * D * 2 + (size_t)mt * 3 * BF * 4 + (size_t)mt * (BF / G) * 4;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int slices = F / BF;
  const dim3 grid(((M + mt - 1) / mt) * slices);
  const bool asym = gu_zeros != nullptr;
  cudaError_t e = cudaSuccess;
#define SCALELLM_MLP(MT, BITS, ASYM)                                                          \
  do {                                                                                        \
    e = cudaFuncSetAttribute(reinterpret_cast<const void*>(&mlp_kernel<MT, BITS, ASYM>),      \
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);         \
    if (e != cudaSuccess) return (int)e;                                                      \
    mlp_kernel<MT, BITS, ASYM><<<grid, kThreads, smem, st>>>(                                 \
        static_cast<const bf16*>(x), static_cast<const uint8_t*>(gu_qweight), gu_scales,      \
        static_cast<const int8_t*>(gu_zeros), static_cast<const uint8_t*>(dn_qweight),        \
        dn_scales, static_cast<const int8_t*>(dn_zeros), scales_bf16,                         \
        static_cast<float*>(part), M, D, F, G, BF, act);                                      \
  } while (0)
#define SCALELLM_MLP_MT(BITS, ASYM)            \
  if (mt == 1) SCALELLM_MLP(1, BITS, ASYM);    \
  else if (mt == 4) SCALELLM_MLP(4, BITS, ASYM); \
  else if (mt == 8) SCALELLM_MLP(8, BITS, ASYM); \
  else SCALELLM_MLP(16, BITS, ASYM)
  if (bits == 4) {
    if (asym) { SCALELLM_MLP_MT(4, true); } else { SCALELLM_MLP_MT(4, false); }
  } else {
    if (asym) { SCALELLM_MLP_MT(8, true); } else { SCALELLM_MLP_MT(8, false); }
  }
#undef SCALELLM_MLP_MT
#undef SCALELLM_MLP
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const size_t count = (size_t)M * D;
  const int blocks = (int)std::min<size_t>((count + 255) / 256, 4096);
  slice_sum_kernel<<<blocks, 256, 0, st>>>(static_cast<const float*>(part),
                                           static_cast<float*>(out), slices, count);
  return (int)cudaGetLastError();
}
