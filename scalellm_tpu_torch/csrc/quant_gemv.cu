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
//     an int32 dot of the int8 activations with the int8-widened weights,
//     (dot - xsum * zero) * scale * sx in f32, spans summed in f32. G = 128
//     makes the span the TPU kernel's group.
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
// projection is 59 MB, 17.5 us at 3.35 TB/s. gemv runs on the tensor-core
// small-M mainloop of quant_small_m.cuh (mma.sync on weights unpacked in
// registers, a TMA ring of weights and x, a producer warp), so at M <= 64
// its products cost little beside the bytes: 2 * M * K * N flops, 3.8 GFLOP
// at M = 16 for that projection, 4 us at 989 TFLOP/s. w4a8g is a CUDA-core
// GEMV: from a few rows up dp4a's issue rate bounds it (4 MACs an
// instruction at half the FMA issue rate). The probe is bound by the bytes
// alone.
//
// Design of gemv: see quant_small_m.cuh. A block owns R = 128 / k_slices
// output columns (weight rows) for every token and all of K; where N / 128
// blocks do not fill the SMs the wrapper asks for 2 or 4 K slices (64 or
// 32 rows a block, its 8 consumer warps splitting K); the slices' sums are
// added in slice order in shared memory. A pre-pass (prep_kernel, one block
// a row) runs the RMSNorm prologue into a bf16 copy of x and, with zero
// points, the sums of x per span.
// Design of w4a8g, simple first:
//   - a block of 8 warps owns 32 output columns and one tile of up to MT
//     rows (MT = 1, 4, 8 or 16; more rows take more tiles, which run side by
//     side over the same columns, so their weights come from L2);
//   - 8 lanes share a column: lane s reads the column's K-contiguous 16-byte
//     words of span s of each 1024-K chunk (64 bytes int4, 128 int8), one
//     chunk ahead of its use, with the span's scales and zero points;
//   - the block stages each chunk of xq (int8) in shared memory, 16-byte
//     pieces swizzled by span so that the 8 lanes of a column read 8
//     different bank groups;
//   - at the end the 8 lanes of a column add their sums by shuffles (fixed
//     order); where N gives fewer than 2 blocks an SM, the chunks are split
//     over blockIdx.y and the f32 partials summed in split order by a second
//     kernel: deterministic, no float atomics.
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

#include <algorithm>

#include "quant_act.cuh"
#include "quant_small_m.cuh"

namespace {

using scalellm_quant::act_quant_kernel;
using scalellm_quant::griddep_wait;
using scalellm_quant::kActThreads;
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

constexpr int kGvThreads = 256;
constexpr int kGvWarps = kGvThreads / 32;
constexpr int kSpanK = 128;                             // K of one lane's span
constexpr int kLanesPerCol = 8;                         // spans of a chunk
constexpr int kColsPerWarp = 32 / kLanesPerCol;         // 4
constexpr int kGvCols = kGvWarps * kColsPerWarp;        // 32 columns a block
constexpr int kChunkK = kLanesPerCol * kSpanK;          // 1024 K a step

// 16-byte piece q of a staged row -> its slot: the three low bits are xored
// with the span's index, so the 8 spans' pieces j sit in 8 bank groups.
__device__ __forceinline__ int swz(int q, int pieces_per_span_log2) {
  return q ^ ((q >> pieces_per_span_log2) & 7);
}

// ------------------------------------------------------------ split sums

// out = bf16(part[0] + part[1] + ...), in split order.
__global__ void split_sum_kernel(const float* __restrict__ part, bf16* __restrict__ out,
                                 int splits, size_t count) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < count;
       i += (size_t)gridDim.x * blockDim.x) {
    float v = part[i];
    for (int s = 1; s < splits; ++s) v += part[(size_t)s * count + i];
    out[i] = __float2bfloat16_rn(v);
  }
}

// The block's rows, columns and chunks; shared by gemv and w4a8g.
struct Tile {
  int m0, rows, col, sp, c_begin, c_end;
  bool col_ok;
};

template <int MT>
__device__ __forceinline__ Tile tile_of(int M, int N, int K, int chunks_per_split) {
  Tile t;
  const int n_mt = (M + MT - 1) / MT;
  const int mt = blockIdx.x % n_mt, cb = blockIdx.x / n_mt;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  t.m0 = mt * MT;
  t.rows = min(MT, M - t.m0);
  t.col = cb * kGvCols + warp * kColsPerWarp + lane / kLanesPerCol;
  t.sp = lane % kLanesPerCol;
  t.col_ok = t.col < N;
  const int n_chunks = (K + kChunkK - 1) / kChunkK;
  t.c_begin = blockIdx.y * chunks_per_split;
  t.c_end = min(n_chunks, t.c_begin + chunks_per_split);
  return t;
}

// The 8 lanes of a column add their sums (xor 1, 2, 4: a fixed order), and
// the span-0 lane writes the column: bf16 out, or f32 partials of this split.
template <int MT>
__device__ __forceinline__ void finish(const Tile& t, float (&acc)[MT], bf16* out, float* part,
                                       int M, int N) {
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int o = 1; o < kLanesPerCol; o <<= 1) acc[m] += __shfl_xor_sync(0xffffffffu, acc[m], o);
  }
  if (t.sp != 0 || !t.col_ok) return;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m >= t.rows) break;
    const size_t i = (size_t)(t.m0 + m) * N + t.col;
    if (part != nullptr) part[(size_t)blockIdx.y * M * N + i] = acc[m];
    else out[i] = __float2bfloat16_rn(acc[m]);
  }
}

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

// xq: int8 [M, K] from act_quant_kernel (each 8 K as evens, then odds);
// sx f32 [M, K / block_k]; xsum s32 [M, K / 128] or null.
template <int MT, int BITS, bool ASYM>
__global__ void __launch_bounds__(kGvThreads) w4a8g_kernel(
    const int8_t* __restrict__ xq, const float* __restrict__ sx, const int* __restrict__ xsum,
    const uint8_t* __restrict__ qw, const void* __restrict__ scales, int scales_bf16,
    const int8_t* __restrict__ zeros, bf16* __restrict__ out, float* __restrict__ part,
    int M, int K, int N, int G, int block_k, int chunks_per_split) {
  constexpr int kVecs = BITS == 4 ? 4 : 8;
  constexpr int kPieces = kChunkK / 16;  // 16-byte pieces of a staged int8 row
  __shared__ __align__(16) uint4 xs[MT * kPieces];
  __shared__ float sx_s[MT][kLanesPerCol];
  __shared__ int xsum_s[MT][kLanesPerCol];

  const Tile t = tile_of<MT>(M, N, K, chunks_per_split);
  const size_t row_bytes = BITS == 4 ? (size_t)K / 2 : (size_t)K;
  const uint8_t* wrow = qw + (size_t)(t.col_ok ? t.col : 0) * row_bytes;
  const int n_kb = K / block_k, n_spans = K / kSpanK;

  float acc[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) acc[m] = 0.f;

  uint4 cur[kVecs], nxt[kVecs];
  float s_cur = 0.f, s_nxt = 0.f;
  int z_cur = 0, z_nxt = 0;
  auto fetch = [&](int c, uint4 (&v)[kVecs], float& s, int& z) {
    const int k = c * kChunkK + t.sp * kSpanK;
    const bool ok = t.col_ok && k < K;
    const uint4* p = reinterpret_cast<const uint4*>(wrow + (BITS == 4 ? k / 2 : k));
#pragma unroll
    for (int i = 0; i < kVecs; ++i) v[i] = ok ? __ldg(p + i) : make_uint4(0, 0, 0, 0);
    s = 0.f;
    z = 0;
    if (ok) {
      const size_t gi = (size_t)(k / G) * N + t.col;
      s = load_f32_or_bf16(scales, gi, scales_bf16);
      if (ASYM) z = zeros[gi];
    }
  };
  if (t.c_begin < t.c_end) fetch(t.c_begin, cur, s_cur, z_cur);

  for (int c = t.c_begin; c < t.c_end; ++c) {
    const int k0 = c * kChunkK;
    const int kc = min(kChunkK, K - k0);
    __syncthreads();
    for (int i = threadIdx.x; i < MT * kPieces; i += kGvThreads) {
      const int r = i / kPieces, q = i % kPieces;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (r < t.rows && q * 16 < kc)
        v = __ldg(reinterpret_cast<const uint4*>(xq + (size_t)(t.m0 + r) * K + k0) + q);
      xs[r * kPieces + swz(q, 3)] = v;
    }
    if (threadIdx.x < MT * kLanesPerCol) {
      const int r = threadIdx.x / kLanesPerCol, s = threadIdx.x % kLanesPerCol;
      const int k = k0 + s * kSpanK;
      const bool ok = r < t.rows && k < K;
      sx_s[r][s] = ok ? sx[(size_t)(t.m0 + r) * n_kb + k / block_k] : 0.f;
      xsum_s[r][s] = ok && ASYM ? xsum[(size_t)(t.m0 + r) * n_spans + k / kSpanK] : 0;
    }
    __syncthreads();
    if (c + 1 < t.c_end) fetch(c + 1, nxt, s_nxt, z_nxt);

    if (t.col_ok && t.sp * kSpanK < kc) {
      int d[MT];
#pragma unroll
      for (int m = 0; m < MT; ++m) d[m] = 0;
      const int q0 = t.sp * (kSpanK / 16);
      if (BITS == 4) {
        // A 16-byte word holds 32 K; nibbles are used as 16 times their
        // value (masks, no sign extension) and the sum shifted back.
#pragma unroll
        for (int i = 0; i < kVecs; ++i) {
          const uint32_t w[4] = {cur[i].x, cur[i].y, cur[i].z, cur[i].w};
          uint32_t lo[4], hi[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            lo[j] = (w[j] << 4) & 0xF0F0F0F0u;  // even K
            hi[j] = w[j] & 0xF0F0F0F0u;         // odd K
          }
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            if (m >= t.rows) break;
            const uint4 a = xs[m * kPieces + swz(q0 + 2 * i, 3)];
            const uint4 b = xs[m * kPieces + swz(q0 + 2 * i + 1, 3)];
            int v = d[m];
            v = __dp4a((int)a.x, (int)lo[0], v);
            v = __dp4a((int)a.y, (int)hi[0], v);
            v = __dp4a((int)a.z, (int)lo[1], v);
            v = __dp4a((int)a.w, (int)hi[1], v);
            v = __dp4a((int)b.x, (int)lo[2], v);
            v = __dp4a((int)b.y, (int)hi[2], v);
            v = __dp4a((int)b.z, (int)lo[3], v);
            v = __dp4a((int)b.w, (int)hi[3], v);
            d[m] = v;
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < kVecs; ++i) {
          const uint32_t e0 = __byte_perm(cur[i].x, cur[i].y, 0x6420);
          const uint32_t o0 = __byte_perm(cur[i].x, cur[i].y, 0x7531);
          const uint32_t e1 = __byte_perm(cur[i].z, cur[i].w, 0x6420);
          const uint32_t o1 = __byte_perm(cur[i].z, cur[i].w, 0x7531);
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            if (m >= t.rows) break;
            const uint4 a = xs[m * kPieces + swz(q0 + i, 3)];
            int v = d[m];
            v = __dp4a((int)a.x, (int)e0, v);
            v = __dp4a((int)a.y, (int)o0, v);
            v = __dp4a((int)a.z, (int)e1, v);
            v = __dp4a((int)a.w, (int)o1, v);
            d[m] = v;
          }
        }
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m >= t.rows) break;
        int v = BITS == 4 ? d[m] >> 4 : d[m];
        if (ASYM) v -= xsum_s[m][t.sp] * z_cur;
        acc[m] += (float)v * s_cur * sx_s[m][t.sp];
      }
    }
#pragma unroll
    for (int i = 0; i < kVecs; ++i) cur[i] = nxt[i];
    s_cur = s_nxt;
    z_cur = z_nxt;
  }
  finish<MT>(t, acc, out, part, M, N);
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

int rows_tile(int M) { return M <= 1 ? 1 : (M <= 4 ? 4 : (M <= 8 ? 8 : 16)); }

int finish_splits(const float* part, void* out, int splits, int M, int N, cudaStream_t st) {
  int rc = (int)cudaGetLastError();
  if (rc != 0 || splits <= 1) return rc;
  const size_t count = (size_t)M * N;
  const int blocks = (int)std::min<size_t>((count + 255) / 256, 4096);
  split_sum_kernel<<<blocks, 256, 0, st>>>(part, static_cast<bf16*>(out), splits, count);
  return (int)cudaGetLastError();
}

// Row warps of a one-slice gemv block (4 to 8, 64 to 128 rows): where 128
// rows give at most two blocks an SM (all resident at once), the count
// whose blocks, spread evenly over the SMs, give the busiest SM the fewest
// rows (the larger on a tie: x is read once a block); at the 8B gate_up (N
// = 28672, 132 SMs) 7: 256 blocks of 112 rows, two on all but 8 SMs, where
// 128 rows give 224 blocks and leave 40 SMs one. Larger grids run in waves
// that even themselves out: 8.
int gemv_row_warps(int N) {
  const int sms = scalellm_quant::sm_count();
  int best = kSmWarps, best_rows = 1 << 30;
  if ((N + 16 * kSmWarps - 1) / (16 * kSmWarps) > 2 * sms) return kSmWarps;
  for (int rw = kSmWarps; rw >= 4 && sms > 0; --rw) {
    const int rows = 16 * rw, blocks = (N + rows - 1) / rows;
    const int busiest = (blocks + sms - 1) / sms * rows;
    if (busiest < best_rows) best = rw, best_rows = busiest;
  }
  return best;
}

// gemv at one instantiation: the stage layout, the ring's depth for the
// blocks an SM the registers allow (2 up to NT = 4), the tensor maps (x:
// the stage's pieces of [8 NT tokens, xk K] in one box; weights: [rh rows,
// 128 bytes], 128-byte swizzle; sums of x: the stage's rows), one block per
// 2 * rh weight rows.
template <int BITS, int NT, bool SPAN32>
int launch_gemv(const bf16* x, const void* qweight, const void* scales, const void* zeros, const float* xsum,
                void* out, int M, int K, int N, int G, int scales_bf16, int ks, bool after_prep, cudaStream_t st) {
  const auto kernel = gemv_kernel<BITS, NT, SPAN32>;
  const int rw = ks == 1 ? gemv_row_warps(N) : kSmWarps / ks, rh = 8 * rw;
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
// `splits` is the split-K the caller chose (1: none) and `part` its scratch,
// f32 [splits, M, N] (null when splits is 1).

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

// xq s8 [M, K], sx f32 [M, K / block_k] and xsum s32 [M, K / 128] (null when
// zeros is null) are scratch. M <= 64, G % 128 == 0, K <= 32768.
extern "C" int scalellm_quant_w4a8_gemv(
    const void* x, const void* qweight, const void* scales, const void* zeros,
    const void* rms_gamma, void* xq, void* sx, void* xsum, void* part, void* out, int M, int K,
    int N, int group_size, int bits, int scales_bf16, int gamma_bf16, int block_k, int splits,
    float rms_eps, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  const int G = group_size;
  const int n_chunks = (K + kChunkK - 1) / kChunkK;
  if ((bits != 4 && bits != 8) || M > 64 || G <= 0 || G % kSpanK != 0 || K % G != 0 ||
      block_k <= 0 || block_k % G != 0 || K % block_k != 0 || K > 32 * 1024 || splits < 1 ||
      splits > n_chunks || (splits > 1 && part == nullptr) ||
      (zeros != nullptr && xsum == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int act_smem = 3 * K;  // bf16 values and int8 values of one row
  if (act_smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        act_quant_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, act_smem);
    if (e != cudaSuccess) return (int)e;
  }
  // The int32 sums of xq over each 128-K span (the span of one dot).
  act_quant_kernel<<<M, kActThreads, act_smem, st>>>(
      static_cast<const bf16*>(x), rms_gamma, gamma_bf16, rms_eps, static_cast<int8_t*>(xq),
      static_cast<float*>(sx), zeros != nullptr ? static_cast<int*>(xsum) : nullptr, K, block_k,
      kSpanK);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const int mt = rows_tile(M);
  const int cps = (n_chunks + splits - 1) / splits;
  const dim3 grid(((M + mt - 1) / mt) * ((N + kGvCols - 1) / kGvCols), (n_chunks + cps - 1) / cps);
  float* p = splits > 1 ? static_cast<float*>(part) : nullptr;
#define SCALELLM_W4A8G(MT, BITS, ASYM)                                                    \
  w4a8g_kernel<MT, BITS, ASYM><<<grid, kGvThreads, 0, st>>>(                              \
      static_cast<const int8_t*>(xq), static_cast<const float*>(sx),                      \
      static_cast<const int*>(xsum), static_cast<const uint8_t*>(qweight), scales,        \
      scales_bf16, static_cast<const int8_t*>(zeros), static_cast<bf16*>(out), p, M, K, N, \
      G, block_k, cps)
#define SCALELLM_W4A8G_MT(BITS, ASYM)            \
  if (mt == 1) SCALELLM_W4A8G(1, BITS, ASYM);    \
  else if (mt == 4) SCALELLM_W4A8G(4, BITS, ASYM); \
  else if (mt == 8) SCALELLM_W4A8G(8, BITS, ASYM); \
  else SCALELLM_W4A8G(16, BITS, ASYM)
  const bool asym = zeros != nullptr;
  if (bits == 4) {
    if (asym) { SCALELLM_W4A8G_MT(4, true); } else { SCALELLM_W4A8G_MT(4, false); }
  } else {
    if (asym) { SCALELLM_W4A8G_MT(8, true); } else { SCALELLM_W4A8G_MT(8, false); }
  }
#undef SCALELLM_W4A8G_MT
#undef SCALELLM_W4A8G
  return finish_splits(p, out, (int)grid.y, M, N, st);
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
