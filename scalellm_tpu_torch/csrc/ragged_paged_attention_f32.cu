// Ragged paged attention for Hopper (sm_90a) in float32: f32 q and pages,
// f32 dot products and softmax on the CUDA cores (no TF32).
//
// Replaces, for float32 models (GPT-2's checkpoints are served in float32,
// the reference's dtype rule), the same stock Pallas ragged-paged-attention
// kernel that scalellm_tpu/ops/attention.py:132 calls, which the reference
// runs in the q's type. It computes what
// scalellm_tpu/ops/attention_ref.py:ref_ragged_paged_attention computes (plain
// PyTorch version: scalellm_tpu_torch/ops/attention_ref.py), the contract of
// the bf16 kernel of ragged_paged_attention.cu: a flattened ragged batch q
// [T, H, D] of prefill chunks and decode tokens (cu_q_lens[S+1], kv_lens[S],
// each chunk the tail of its context), KV pages [P, page_size, 2*Hkv, D] with
// K at even and V at odd combined heads through the block table
// page_indices[S, MAXP], GQA (group <= 16), causal masking by absolute
// position, a sliding window (<= 0 disables it), ALiBi (score += slope[head]
// * (kv_pos - q_pos), after the scale and before the soft cap; null slopes
// disable it), a logit soft cap (<= 0 disables it), and zero rows for the
// rows that own no KV (padding sequences with kv_len 0, rows at or past
// cu_q_lens[num_seqs]). Pages are f32, or int8 (a float32 checkpoint served
// with kv_cache_dtype="int8"), each element then read as f32(element) *
// k_scale or * v_scale, the stock kernel's dequantization in q's type: the
// same registers fetch 4 bytes a chunk of 4 elements where f32 pages take
// 16, and widen them when they store.
//
// What bounds it: a simple kernel, right first. Its blocks take tiles of
// up to 16 q rows (16 / group tokens of one sequence x the group's heads,
// a KV head a block; a decode token is a tile of its own), walk the tile's
// KV range 32 rows at a time through shared memory (K rows padded to D + 1
// floats, so that the 32 lanes reading one column of 32 rows hit 32 banks),
// and a warp keeps 4 rows' online softmax: lane j scores KV row j against
// the warp's 4 q rows, then each lane accumulates its D / 32 output columns
// over the 32 rows. Each thread fetches its share of the next 32 rows into
// registers while the block computes the current ones (TileLoad; at D = 64,
// GPT-2's), and a warp without a live row skips the arithmetic. A decode token still walks
// its whole context in one block, so at decode it is bound by that block's
// chain of tiles, not by the card's memory rate. Every block also zeroes
// its share of the padding rows (a grid stride over them).
// No atomics: the same inputs give the same bits on every call.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;             // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;                 // q rows a block
constexpr int kWarpRows = kRows / kWarps; // q rows a warp
constexpr int kCols = 32;                 // KV rows a staged tile
constexpr int kMaxGroup = 16;

struct Params {
  const float* q;          // [T, H, D]
  const float* kv;         // [P, page, 2*Hkv, D] (f32 pages)
  const int8_t* kv8;       // [P, page, 2*Hkv, D] (int8 pages; the kInt8 instances only)
  float k_scale, v_scale;  // int8 pages: element = f32(int8) * scale
  const int* kv_lens;      // [S]
  const int* table;        // [S, maxp]
  const int* cu;           // [S+1]
  const int* num_seqs;     // [1]
  const float* alibi;      // [H] ALiBi slopes, or null
  float* out;              // [T, H, D]
  int T, S, maxp, page_size, n_heads, n_kv_heads, group;
  int tile_tokens, tile_blocks;  // tokens a tile, tiles the grid has room for
  int window;
  float sm_scale, soft_cap;
};

template <int D>
__host__ __device__ constexpr int smem_floats() {
  return kRows * D + kCols * (D + 1) + kCols * D + kWarps * kWarpRows * kCols;
}

// Warp 0 finds the sequence and the tile within it that hold tile b: a
// scan of the per-sequence tile counts (every real sequence, q_len / bq
// rounded up). seq is -1 past the last tile.
__device__ __forceinline__ void find_tile(const Params& p, int n_real, int b, int& seq, int& tile) {
  const int lane = threadIdx.x & 31, bq = p.tile_tokens;
  int before = 0;  // tiles of the slots already scanned
  seq = -1;
  tile = 0;
  for (int s0 = 0; s0 < n_real; s0 += 32) {
    const int s = s0 + lane;
    const int q_len = s < n_real ? p.cu[s + 1] - p.cu[s] : 0;
    const int own = q_len > 0 ? (q_len + bq - 1) / bq : 0;
    int incl = own;  // inclusive scan over the warp's 32 slots
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    const unsigned hit = __ballot_sync(0xffffffffu, before + incl > b);
    if (hit) {  // uniform across the warp
      const int first = __ffs(hit) - 1;
      seq = s0 + first;
      tile = b - before - (__shfl_sync(0xffffffffu, incl, first) - __shfl_sync(0xffffffffu, own, first));
      return;
    }
    before += __shfl_sync(0xffffffffu, incl, 31);
  }
}

// 4 int8 elements widened to f32, times `scale`.
__device__ __forceinline__ float4 widen4(uint32_t w, float scale) {
  return make_float4((float)(int8_t)w * scale, (float)(int8_t)(w >> 8) * scale, (float)(int8_t)(w >> 16) * scale,
                     (float)(int8_t)(w >> 24) * scale);
}

// One thread's share of a tile of K and V rows [base, base + kCols) of one
// KV head: kLoads chunks of 4 elements of each (16 bytes of f32 pages, 4 of
// int8 pages), fetched into registers (rows at or past `end` zero) while the
// block computes the tile before, then stored to shared memory as f32 (K
// rows padded to D + 1 floats), int8 ones widened by their scale.
template <int D, bool kInt8>
struct TileLoad {
  static constexpr int kLoads = kCols * (D / 4) / kThreads;
  static_assert(kCols * (D / 4) % kThreads == 0, "tile chunks");
  using Chunk = typename std::conditional<kInt8, uint32_t, float4>::type;
  Chunk k[kLoads], v[kLoads];

  __device__ __forceinline__ void fetch(const Params& p, int h, const int* table, int base, int end) {
    const size_t row_stride = (size_t)2 * p.n_kv_heads * D;  // elements
#pragma unroll
    for (int r = 0; r < kLoads; ++r) {
      const int i = threadIdx.x + r * kThreads;
      const int j = i / (D / 4), c = i % (D / 4), pos = base + j;
      k[r] = v[r] = Chunk{};
      if (pos < end) {
        const int pg = pos / p.page_size;
        const size_t off = ((size_t)table[pg] * p.page_size + (pos - pg * p.page_size)) * row_stride +
                           (size_t)(2 * h) * D + 4 * c;
        if constexpr (kInt8) {
          k[r] = *reinterpret_cast<const uint32_t*>(p.kv8 + off);
          v[r] = *reinterpret_cast<const uint32_t*>(p.kv8 + off + D);
        } else {
          k[r] = *reinterpret_cast<const float4*>(p.kv + off);
          v[r] = *reinterpret_cast<const float4*>(p.kv + off + D);
        }
      }
    }
  }

  __device__ __forceinline__ void store(const Params& p, float* ks, float* vs) const {
#pragma unroll
    for (int r = 0; r < kLoads; ++r) {
      const int i = threadIdx.x + r * kThreads;
      const int j = i / (D / 4), c = i % (D / 4);
      float4 kf, vf;
      if constexpr (kInt8) {
        kf = widen4(k[r], p.k_scale);
        vf = widen4(v[r], p.v_scale);
      } else {
        kf = k[r];
        vf = v[r];
      }
      float* kd = ks + j * (D + 1) + 4 * c;
      kd[0] = kf.x;
      kd[1] = kf.y;
      kd[2] = kf.z;
      kd[3] = kf.w;
      *reinterpret_cast<float4*>(vs + j * D + 4 * c) = vf;
    }
  }
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Block (b, KV head h).
template <int D, bool kInt8>
__global__ void __launch_bounds__(kThreads) ragged_paged_attention_f32_kernel(const Params p) {
  constexpr int kLaneCols = (D + 31) / 32;  // output columns a lane accumulates
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                        // [kRows][D]
  float* ks = qs + kRows * D;              // [kCols][D + 1]
  float* vs = ks + kCols * (D + 1);        // [kCols][D]
  float* ps = vs + kCols * D;              // [kWarps][kWarpRows][kCols]
  __shared__ int found[2];

  const int b = blockIdx.x, h = blockIdx.y;
  const int n_real = min(max(p.num_seqs[0], 0), p.S);
  const int group = p.group;
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;

  // The padding rows (at or past cu[n_real]) of this KV head's q heads.
  for (int t = p.cu[n_real] + b; t < p.T; t += gridDim.x) {
    float* dst = p.out + ((size_t)t * p.n_heads + (size_t)h * group) * D;
    for (int i = threadIdx.x; i < group * D; i += kThreads) dst[i] = 0.f;
  }

  if (threadIdx.x < 32) {
    int seq, tile;
    find_tile(p, n_real, b, seq, tile);
    if (lane == 0) {
      found[0] = seq;
      found[1] = tile;
    }
  }
  __syncthreads();
  const int s = found[0];
  if (s < 0) return;  // past the last tile (the grid is sized from T and S)

  const int q_start = p.cu[s], q_len = p.cu[s + 1] - q_start, kv_len = p.kv_lens[s];
  const int tok0 = found[1] * p.tile_tokens;
  const int n_tok = min(p.tile_tokens, q_len - tok0);
  const int pos0 = kv_len - q_len + tok0;  // absolute position of the tile's first token
  const int kv_cap = min(kv_len, p.maxp * p.page_size);

  // Row r of the tile: token r / group, head h * group + r % group.
  for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
    const int r = i / D, d = i % D, k = r / group;
    const int row = q_start + tok0 + k;
    qs[i] = k < n_tok && row < p.T ? p.q[((size_t)row * p.n_heads + (size_t)h * group + r % group) * D + d] : 0.f;
  }

  // This warp's rows: their visible KV range [lo, hi), query position and slope.
  int lo[kWarpRows], hi[kWarpRows], q_pos[kWarpRows];
  float slope[kWarpRows], m[kWarpRows], l[kWarpRows], o[kWarpRows][kLaneCols];
  bool live[kWarpRows];
#pragma unroll
  for (int i = 0; i < kWarpRows; ++i) {
    const int r = warp * kWarpRows + i, k = r / group;
    q_pos[i] = pos0 + k;
    live[i] = k < n_tok && q_start + tok0 + k < p.T;
    lo[i] = p.window > 0 ? max(0, q_pos[i] - p.window + 1) : 0;
    hi[i] = live[i] ? min(q_pos[i] + 1, kv_cap) : 0;
    slope[i] = p.alibi != nullptr && live[i] ? p.alibi[h * group + r % group] : 0.f;
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kLaneCols; ++c) o[i][c] = 0.f;
  }
  const int begin = p.window > 0 ? max(0, pos0 - p.window + 1) : 0;
  const int end = min(pos0 + n_tok, kv_cap);
  const int* table = p.table + (size_t)s * p.maxp;
  float* pw = ps + warp * kWarpRows * kCols;
  const bool warp_live = live[0];  // rows ascend: the warp's first row is live if any is

  // A tile ahead in registers at D = 64 (GPT-2's): at D = 80 and 128 ptxas
  // spills with them (12 and 4 bytes), at 256 they would take 128 registers.
  constexpr bool kAhead = D <= 64;
  TileLoad<D, kInt8> next;
  if (kAhead && begin < end) next.fetch(p, h, table, begin, end);
  for (int base = begin; base < end; base += kCols) {
    if (!kAhead) next.fetch(p, h, table, base, end);
    __syncthreads();  // q rows written; every warp done with the last tile
    next.store(p, ks, vs);
    __syncthreads();
    if (kAhead && base + kCols < end) next.fetch(p, h, table, base + kCols, end);  // in flight below
    if (!warp_live) continue;

    // Lane j: KV row base + j against the warp's rows.
    float sc[kWarpRows];
#pragma unroll
    for (int i = 0; i < kWarpRows; ++i) sc[i] = 0.f;
    const float* krow = ks + lane * (D + 1);
    const float* qw = qs + warp * kWarpRows * D;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float kd = krow[d];
#pragma unroll
      for (int i = 0; i < kWarpRows; ++i) sc[i] = fmaf(qw[i * D + d], kd, sc[i]);
    }
    const int pos = base + lane;
#pragma unroll
    for (int i = 0; i < kWarpRows; ++i) {
      float x = sc[i] * p.sm_scale;
      if (p.alibi != nullptr) x += slope[i] * (float)(pos - q_pos[i]);
      if (p.soft_cap > 0.f) x = p.soft_cap * tanhf(x / p.soft_cap);
      if (!(pos >= lo[i] && pos < hi[i])) x = -INFINITY;
      const float m_new = fmaxf(m[i], warp_max(x));
      const float mb = m_new == -INFINITY ? 0.f : m_new;  // a row with nothing visible yet
      const float alpha = expf(m[i] - mb);                 // 0 while the row was empty
      const float pe = expf(x - mb);                       // masked: 0
      l[i] = l[i] * alpha + warp_sum(pe);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kLaneCols; ++c) o[i][c] *= alpha;
      pw[i * kCols + lane] = pe;
    }
    __syncwarp();
    // O += P V: lane columns lane, lane + 32, ...
#pragma unroll 4
    for (int j = 0; j < kCols; ++j) {
#pragma unroll
      for (int c = 0; c < kLaneCols; ++c) {
        const int d = lane + 32 * c;
        if (d < D) {
          const float v = vs[j * D + d];
#pragma unroll
          for (int i = 0; i < kWarpRows; ++i) o[i][c] = fmaf(pw[i * kCols + j], v, o[i][c]);
        }
      }
    }
    __syncwarp();  // the next tile's scores overwrite pw
  }

#pragma unroll
  for (int i = 0; i < kWarpRows; ++i) {
    if (!live[i]) continue;
    const int r = warp * kWarpRows + i;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    float* dst = p.out + ((size_t)(q_start + tok0 + r / group) * p.n_heads + (size_t)h * group + r % group) * D;
#pragma unroll
    for (int c = 0; c < kLaneCols; ++c) {
      const int d = lane + 32 * c;
      if (d < D) dst[d] = o[i][c] * inv;
    }
  }
}

template <int D, bool kInt8>
int launch(Params p, cudaStream_t st) {
  p.tile_tokens = kRows / p.group;
  // Real sequences hold at most T / tile_tokens + S tiles.
  p.tile_blocks = (p.T + p.tile_tokens - 1) / p.tile_tokens + min(p.S, p.T);
  constexpr int bytes = smem_floats<D>() * (int)sizeof(float);
  static const int smem_rc = (int)cudaFuncSetAttribute(
      ragged_paged_attention_f32_kernel<D, kInt8>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (smem_rc) return smem_rc;
  ragged_paged_attention_f32_kernel<D, kInt8><<<dim3(p.tile_blocks, p.n_kv_heads), kThreads, bytes, st>>>(p);
  return (int)cudaGetLastError();
}

template <int D>
int launch_any(const Params& p, cudaStream_t st) {
  return p.kv8 ? launch<D, true>(p, st) : launch<D, false>(p, st);
}

}  // namespace

// Plain C entry point, loaded with ctypes. Launches the kernel on `stream`
// and returns cudaGetLastError() (0 on success); it never synchronises.
// `alibi_slopes`: f32 [n_heads] on the device, or null (no ALiBi).
// kv_int8: the pages are int8, each element read as f32(element) * k_scale
// (K) or * v_scale (V); else f32 pages (the scales unused).
extern "C" int scalellm_ragged_paged_attention_f32(
    const void* q, const void* kv_pages, const void* kv_lens, const void* page_indices,
    const void* cu_q_lens, const void* num_seqs, void* out, const void* alibi_slopes, int num_tokens,
    int num_seq_slots, int maxp, int page_size, int n_heads, int n_kv_heads, int head_dim, float sm_scale,
    int window, float soft_cap, int kv_int8, float k_scale, float v_scale, void* stream) {
  if (num_tokens == 0) return 0;
  if (n_kv_heads <= 0 || n_heads % n_kv_heads != 0 || n_heads / n_kv_heads > kMaxGroup ||
      num_seq_slots <= 0 || maxp <= 0 || page_size <= 0)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = static_cast<const float*>(q);
  p.kv = kv_int8 ? nullptr : static_cast<const float*>(kv_pages);
  p.kv8 = kv_int8 ? static_cast<const int8_t*>(kv_pages) : nullptr;
  p.k_scale = k_scale;
  p.v_scale = v_scale;
  p.kv_lens = static_cast<const int*>(kv_lens);
  p.table = static_cast<const int*>(page_indices);
  p.cu = static_cast<const int*>(cu_q_lens);
  p.num_seqs = static_cast<const int*>(num_seqs);
  p.alibi = static_cast<const float*>(alibi_slopes);
  p.out = static_cast<float*>(out);
  p.T = num_tokens;
  p.S = num_seq_slots;
  p.maxp = maxp;
  p.page_size = page_size;
  p.n_heads = n_heads;
  p.n_kv_heads = n_kv_heads;
  p.group = n_heads / n_kv_heads;
  p.window = window;
  p.sm_scale = sm_scale;
  p.soft_cap = soft_cap;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64: return launch_any<64>(p, st);
    case 80: return launch_any<80>(p, st);
    case 128: return launch_any<128>(p, st);
    case 256: return launch_any<256>(p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
