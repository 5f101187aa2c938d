// Ragged paged attention for Hopper (sm_90a), bf16 pages, f32 online softmax.
//
// Replaces the stock Pallas ragged-paged-attention kernel that
// scalellm_tpu/ops/attention.py:131 calls. It computes what
// scalellm_tpu/ops/attention_ref.py:ref_ragged_paged_attention computes
// (plain PyTorch version: scalellm_tpu_torch/ops/attention_ref.py), not the
// stock kernel's block structure:
//   - q is a flattened ragged batch [T, H, D] that mixes prefill chunks and
//     decode tokens; cu_q_lens[S+1] gives the chunk boundaries, kv_lens[S]
//     the context lengths, and each chunk is the tail of its context;
//   - KV pages [P, page_size, 2*Hkv, D], K at even and V at odd combined
//     heads, reached through the block table page_indices[S, MAXP];
//   - GQA, causal masking by absolute position, sliding window (<= 0
//     disables it), logit soft cap (<= 0 disables it);
//   - rows that own no KV (padding sequences with kv_len 0, and rows at or
//     past cu_q_lens[num_seqs]) write zeros, never NaN.
// Page 0 is the reserved padding page: padding tokens write their K/V
// there, and no real sequence's block table walks into it below kv_len.
// Entries of cu_q_lens past the real sequences repeat the last value.
//
// What bounds it on an H100: the bytes of KV it reads. A decode token does
// 4 flops per KV element it loads (q.k and p.v), far below the ~295
// flops/byte the card needs before its tensor cores are the limit, so the
// design keeps every KV byte read once per (query token, KV head) block and
// does all arithmetic from shared memory in f32.
//
// Design: one block per (query token, KV head). The block loads its GQA
// group's q rows (8 heads x 64 for TinyLlama) into shared memory, finds its
// sequence by binary search over cu_q_lens (this replaces the TPU kernel's
// scalar prefetch), then walks that sequence's pages through the block table
// in tiles of 32 KV rows, over [max(0, pos - window + 1), min(pos + 1,
// kv_len)), with an f32 online softmax. Templated on head dim 64 and 128.
// Inside a tile:
//   - the next tile's K/V rows are loaded into registers (16 bytes a
//     thread) while the current tile is computed, so the load latency
//     overlaps the arithmetic;
//   - one warp owns a head's 32 scores (one per lane) and runs the online
//     softmax on them in registers, with shuffles;
//   - q.k and p.V read shared memory as float4 (K rows padded by 4 floats,
//     so 8 lanes reading 8 rows hit distinct banks); each thread owns 4
//     consecutive output dims of one head.
//
// Known limit, later work: decode at small batch gives few blocks
// (S * Hkv = 32 blocks at b = 8 for TinyLlama, against 132 SMs), and a
// prefill chunk re-reads its sequence's KV once per query token (from L2).
// A split-KV decode kernel and a q-tiled prefill kernel, fed by TMA and
// computing with wgmma, are the next step. Int8 pages with k/v scales,
// ALiBi and head dim 256 are not covered; the Python wrapper refuses them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTileKV = 32;    // KV rows per tile; one per lane in the softmax
constexpr int kMaxGroup = 16;  // query heads per KV head
constexpr int kVec = 8;        // bf16 per 16-byte load
constexpr int kPad = 4;        // floats after each K row in shared memory

// The thread's share of one tile's K and V rows, as raw 16-byte chunks.
template <int D>
struct TileRegs {
  static constexpr int kChunks = D / kVec;                       // per row
  static constexpr int kLoads = kTileKV * kChunks / kThreads;   // per thread
  uint4 k[kLoads];
  uint4 v[kLoads];
};

// Loads rows [base, base + n) of the tile into registers: chunk
// c = tid + r * kThreads is row c / kChunks, dims (c % kChunks) * kVec.
template <int D>
__device__ __forceinline__ void load_tile(
    TileRegs<D>& regs, const __nv_bfloat16* __restrict__ kv_head,
    const int* __restrict__ table, size_t row_stride, int page_size, int base,
    int n, int tid) {
#pragma unroll
  for (int r = 0; r < TileRegs<D>::kLoads; ++r) {
    const int c = tid + r * kThreads;
    const int j = c / TileRegs<D>::kChunks;
    const int d0 = (c % TileRegs<D>::kChunks) * kVec;
    if (j < n) {
      const int p = base + j;
      const size_t row = (size_t)table[p / page_size] * page_size + p % page_size;
      const __nv_bfloat16* src = kv_head + row * row_stride + d0;
      regs.k[r] = *reinterpret_cast<const uint4*>(src);
      regs.v[r] = *reinterpret_cast<const uint4*>(src + D);
    }
  }
}

__device__ __forceinline__ void store_f32(float* dst, const uint4& raw) {
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < kVec / 2; ++e) {
    const float2 f = __bfloat1622float2(b[e]);
    dst[2 * e] = f.x;
    dst[2 * e + 1] = f.y;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
ragged_paged_attention_kernel(
    const __nv_bfloat16* __restrict__ q,         // [T, H, D]
    const __nv_bfloat16* __restrict__ kv_pages,  // [P, page, 2*Hkv, D]
    const int* __restrict__ kv_lens,             // [S]
    const int* __restrict__ page_indices,        // [S, maxp]
    const int* __restrict__ cu_q_lens,           // [S+1]
    const int* __restrict__ num_seqs,            // [1]
    __nv_bfloat16* __restrict__ out,             // [T, H, D]
    int S, int maxp, int page_size, int n_heads, int n_kv_heads,
    float sm_scale, int window, float soft_cap) {
  constexpr int kQuads = D / 4;                                // float4 per row
  constexpr int kOutQuads = kMaxGroup * kQuads / kThreads;     // per thread
  constexpr int kHeadsPerWarp = kMaxGroup / kWarps;
  static_assert(kTileKV * (D / kVec) % kThreads == 0, "tile chunks");
  static_assert(kMaxGroup * kQuads % kThreads == 0, "output quads");

  __shared__ __align__(16) float q_s[kMaxGroup][D];
  __shared__ __align__(16) float k_s[kTileKV][D + kPad];
  __shared__ __align__(16) float v_s[kTileKV][D];
  __shared__ float p_s[kMaxGroup][kTileKV];
  __shared__ float alpha_s[kMaxGroup];
  __shared__ float l_s[kMaxGroup];

  const int t = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int group = n_heads / n_kv_heads;
  const size_t head0 = (size_t)t * n_heads + (size_t)h * group;
  const __nv_bfloat16* q_ptr = q + head0 * D;
  __nv_bfloat16* o_ptr = out + head0 * D;

  // Which sequence owns token t: the first s with cu_q_lens[s + 1] > t.
  // Every thread computes the same values, so branches below are uniform.
  const int n_real = min(max(num_seqs[0], 0), S);
  int s = 0, kv_begin = 0, kv_end = 0;
  if (t < cu_q_lens[n_real]) {
    int lo = 0, hi = S - 1;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (cu_q_lens[mid + 1] > t) hi = mid; else lo = mid + 1;
    }
    s = lo;
    const int kv_len = kv_lens[s];
    const int q_start = cu_q_lens[s];
    const int pos = kv_len - (cu_q_lens[s + 1] - q_start) + (t - q_start);
    kv_end = min(pos + 1, kv_len);
    kv_begin = window > 0 ? max(0, pos - window + 1) : 0;
  }
  if (kv_end <= kv_begin) {  // fully masked row
    for (int i = tid; i < group * D; i += kThreads) o_ptr[i] = __float2bfloat16(0.f);
    return;
  }

  const int* table = page_indices + (size_t)s * maxp;
  const size_t row_stride = (size_t)2 * n_kv_heads * D;  // elements per KV row
  const __nv_bfloat16* kv_head = kv_pages + (size_t)(2 * h) * D;
  TileRegs<D> regs;
  load_tile<D>(regs, kv_head, table, row_stride, page_size, kv_begin,
               min(kTileKV, kv_end - kv_begin), tid);

  for (int i = tid; i < group * D; i += kThreads)
    q_s[i / D][i % D] = __bfloat162float(q_ptr[i]) * sm_scale;

  // Running max and sum of the heads this warp owns (g = warp + k * kWarps),
  // held by every lane of the warp.
  float m_run[kHeadsPerWarp], l_run[kHeadsPerWarp];
#pragma unroll
  for (int k = 0; k < kHeadsPerWarp; ++k) {
    m_run[k] = -INFINITY;
    l_run[k] = 0.f;
  }
  float4 acc[kOutQuads];
#pragma unroll
  for (int r = 0; r < kOutQuads; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int base = kv_begin; base < kv_end; base += kTileKV) {
    const int n = min(kTileKV, kv_end - base);
    // This tile's rows, from registers to shared memory as f32.
#pragma unroll
    for (int r = 0; r < TileRegs<D>::kLoads; ++r) {
      const int c = tid + r * kThreads;
      const int j = c / TileRegs<D>::kChunks;
      const int d0 = (c % TileRegs<D>::kChunks) * kVec;
      if (j < n) {
        store_f32(&k_s[j][d0], regs.k[r]);
        store_f32(&v_s[j][d0], regs.v[r]);
      }
    }
    __syncthreads();
    // The next tile's loads are in flight during the arithmetic below.
    if (base + kTileKV < kv_end)
      load_tile<D>(regs, kv_head, table, row_stride, page_size, base + kTileKV,
                   min(kTileKV, kv_end - base - kTileKV), tid);

    // Scores and online softmax: one warp per head, one lane per tile row.
    // The tile holds at least one unmasked row, so the new max is finite.
#pragma unroll
    for (int k = 0; k < kHeadsPerWarp; ++k) {
      const int g = warp + k * kWarps;
      if (g >= group) break;  // uniform across the warp
      float sc = -INFINITY;
      if (lane < n) {
        const float4* qr = reinterpret_cast<const float4*>(q_s[g]);
        const float4* kr = reinterpret_cast<const float4*>(k_s[lane]);
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < kQuads; ++d) {
          const float4 a = qr[d], b = kr[d];
          dot += a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
        }
        sc = soft_cap > 0.f ? soft_cap * tanhf(dot / soft_cap) : dot;
      }
      float mx = sc;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_run[k], mx);
      const float pr = lane < n ? __expf(sc - m_new) : 0.f;
      float sum = pr;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float alpha = __expf(m_run[k] - m_new);  // 0 on the first tile
      l_run[k] = l_run[k] * alpha + sum;
      m_run[k] = m_new;
      p_s[g][lane] = pr;
      if (lane == 0) alpha_s[g] = alpha;
    }
    __syncthreads();

    // o = o * alpha + p @ V; thread owns dims [d0, d0 + 4) of head g.
#pragma unroll
    for (int r = 0; r < kOutQuads; ++r) {
      const int i = tid + r * kThreads;
      if (i < group * kQuads) {
        const int g = i / kQuads, d0 = (i % kQuads) * 4;
        const float a = alpha_s[g];
        float4 o = acc[r];
        o.x *= a; o.y *= a; o.z *= a; o.w *= a;
        for (int j = 0; j < n; ++j) {
          const float p = p_s[g][j];
          const float4 v = *reinterpret_cast<const float4*>(&v_s[j][d0]);
          o.x += p * v.x; o.y += p * v.y; o.z += p * v.z; o.w += p * v.w;
        }
        acc[r] = o;
      }
    }
    __syncthreads();
  }

  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kHeadsPerWarp; ++k) {
      const int g = warp + k * kWarps;
      if (g < group) l_s[g] = l_run[k];
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kOutQuads; ++r) {
    const int i = tid + r * kThreads;
    if (i < group * kQuads) {
      const int g = i / kQuads, d0 = (i % kQuads) * 4;
      const float l = l_s[g];
      const float inv = l > 0.f ? 1.f / l : 0.f;
      __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(o_ptr + g * D + d0);
      dst[0] = __floats2bfloat162_rn(acc[r].x * inv, acc[r].y * inv);
      dst[1] = __floats2bfloat162_rn(acc[r].z * inv, acc[r].w * inv);
    }
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. Launches on `stream` and returns
// cudaGetLastError() (0 on success); it never synchronises.
extern "C" int scalellm_ragged_paged_attention(
    const void* q, const void* kv_pages, const void* kv_lens,
    const void* page_indices, const void* cu_q_lens, const void* num_seqs,
    void* out, int num_tokens, int num_seq_slots, int maxp, int page_size,
    int n_heads, int n_kv_heads, int head_dim, float sm_scale, int window,
    float soft_cap, void* stream) {
  if (num_tokens == 0) return 0;
  if (n_kv_heads <= 0 || n_heads % n_kv_heads != 0 || n_heads / n_kv_heads > kMaxGroup)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(num_tokens, n_kv_heads);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
#define SCALELLM_RPA_LAUNCH(D)                                                \
  ragged_paged_attention_kernel<D><<<grid, kThreads, 0, st>>>(                \
      static_cast<const __nv_bfloat16*>(q),                                   \
      static_cast<const __nv_bfloat16*>(kv_pages),                            \
      static_cast<const int*>(kv_lens), static_cast<const int*>(page_indices), \
      static_cast<const int*>(cu_q_lens), static_cast<const int*>(num_seqs),   \
      static_cast<__nv_bfloat16*>(out), num_seq_slots, maxp, page_size,       \
      n_heads, n_kv_heads, sm_scale, window, soft_cap)
  switch (head_dim) {
    case 64: SCALELLM_RPA_LAUNCH(64); break;
    case 128: SCALELLM_RPA_LAUNCH(128); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef SCALELLM_RPA_LAUNCH
  return (int)cudaGetLastError();
}
