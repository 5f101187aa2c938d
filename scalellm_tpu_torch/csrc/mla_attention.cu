// MLA latent attention for Hopper (sm_90a): the decode kernel (K9) and the
// ragged prefill kernel (K10) over a K-only latent page cache, bf16 pages,
// f32 online softmax, bf16 tensor-core products (mma.sync m16n8k16).
//
// Replaces scalellm_tpu/ops/mla_attention.py:_mla_decode_kernel (K9, one
// query per sequence, called by mla_decode_attention) and
// :_mla_prefill_kernel (K10, a ragged batch of prefill chunks and decode
// tokens, called by mla_prefill_attention). Plain PyTorch versions:
// scalellm_tpu_torch/ops/mla_attention.py plain_mla_decode and
// plain_mla_prefill. Both compute DeepSeek's absorbed MLA, which is
// multi-query attention over one shared latent head:
//   - pages [P, page_size, 1, Dc] hold K = [c_kv | k_pe] only; V is the
//     first v_dim (= kv_lora_rank) columns of the same rows, so one tile of
//     rows in shared memory serves both products and V is never loaded
//     twice. Built for DeepSeek-V2's widths only (V2, V2-Lite and V3 alike):
//     Dc = 576, v_dim = 512; the entry points refuse any other;
//   - q [T, H, Dc], scores over all Dc columns (the rope part included),
//     scaled by sm_scale in f32 (the caller folds yarn's mscale^2 into it);
//   - K9: row s < S of q is sequence s's only query and attends its first
//     kv_len rows; rows s >= S and sequences with kv_len 0 write zeros;
//   - K10: token t finds its sequence by binary search over cu_q_lens and
//     attends rows [0, pos] with pos = kv_len - q_len + i, its absolute
//     position (causal), within kv_len. Each token writes only its own
//     output rows; rows at or past cu_q_lens[num_seqs] write zeros.
//
// What bounds it on an H100: at decode, the latent bytes it reads (a query
// does 2 * (Dc + v_dim) flops per 2 * Dc bytes of K, far below the ~295
// flops/byte the card needs to be compute-bound); at prefill, with many
// tokens over one context, the flops. The design reads each latent row once
// per block into shared memory and runs both products on the tensor cores.
//
// Design: one block of 8 warps per (query token, group of 16 heads). The 16
// heads are the mma M dimension, so a tile of 32 latent rows is one
// M=16 x K=Dc x N=32 product for the scores and one M=16 x K=32 x N=v_dim
// product for the output:
//   - tiles of 32 rows are walked through the block table with cp.async
//     into a double buffer (the next tile loads while this one computes);
//     rows past the token's end are zero-filled, so a masked row's p = 0
//     never meets garbage;
//   - scores: warp w takes token columns 8 * (w % 4) and half of the Dc/16
//     k-steps (w / 4); the two halves meet in shared memory;
//   - softmax: 16 threads per head row, shuffles, running max and sum in
//     registers; p is rounded to bf16 for the second product (as the TPU
//     kernel does);
//   - output: the 16 x v_dim f32 accumulator is split over the 8 warps by
//     column (64 columns, 32 registers a thread at v_dim 512), V fragments
//     read from the K tile with ldmatrix.trans.
//
// Known limits, later work: K9 runs one block per sequence (8 of 132 SMs at
// 8 sequences) and K10 re-reads a context once per query token (from L2);
// split-KV for decode, q-tiling for prefill, TMA and wgmma are the next
// steps. int8 latent pages are not covered; the Python wrapper refuses them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;      // query heads per block: the mma M dimension
constexpr int kTile = 32;      // latent rows per tile
constexpr int kPad = 8;        // bf16 after each shared row: 16 bytes, no bank conflicts
constexpr int kDc = 576;       // latent dim: kv_lora_rank 512 + rope dims 64
constexpr int kVd = 512;       // v_dim: kv_lora_rank
constexpr int kLd = kDc + kPad;  // shared row stride, bf16

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled when !valid (nothing is read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Shared memory of one block (dynamic: 97 KB, over the 48 KB static limit).
struct Smem {
  __nv_bfloat16 q[kRows][kLd];
  __nv_bfloat16 k[2][kTile][kLd];
  float s[2][kRows][kTile];  // score partials of the two k halves
  __nv_bfloat16 p[kRows][kTile + kPad];
  float alpha[kRows];
  float l[kRows];
};

// Rows [base, base + kTile) of a context (row i at page table[i / page_size],
// slot i % page_size) into a shared tile; rows at or past `end` are zeros.
__device__ __forceinline__ void load_tile(__nv_bfloat16 (*dst)[kLd], const __nv_bfloat16* pages,
                                          const int* table, int page_size, int base, int end) {
  constexpr int kChunks = kDc / 8;
  for (int i = threadIdx.x; i < kTile * kChunks; i += kThreads) {
    const int r = i / kChunks, ch = i % kChunks;
    const int pos = base + r;
    const bool valid = pos < end;
    const __nv_bfloat16* src = pages;
    if (valid)
      src = pages + ((size_t)table[pos / page_size] * page_size + pos % page_size) * kDc + ch * 8;
    cp_async16(&dst[r][ch * 8], src, valid);
  }
}

// One block: the query rows q_tok [n_heads, kDc] of one token, heads
// [head0, head0 + 16), attend rows [0, end) of the context behind `table`;
// writes out_tok [n_heads, kVd] for those heads. Uniform across the block.
__device__ void attend(const __nv_bfloat16* __restrict__ q_tok,
                       const __nv_bfloat16* __restrict__ pages, const int* __restrict__ table,
                       int page_size, int end, int n_heads, int head0, float sm_scale,
                       __nv_bfloat16* __restrict__ out_tok, Smem& sm) {
  constexpr int kCols = kVd / kWarps;  // output columns per warp
  constexpr int kNt = kCols / 8;       // n8 tiles per warp
  constexpr int kNk = kDc / 16;        // k16 steps of the scores
  static_assert(kCols % 8 == 0 && kDc % 16 == 0 && kVd <= kDc, "widths must split into mma tiles");
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const int rows = min(kRows, n_heads - head0);

  if (end <= 0) {  // owns no KV: zeros, never NaN
    for (int i = tid; i < rows * kVd; i += kThreads)
      out_tok[(size_t)(head0 + i / kVd) * kVd + i % kVd] = __float2bfloat16(0.f);
    return;
  }

  // q rows of this head group (missing heads as zeros), then tile 0.
  for (int i = tid; i < kRows * (kDc / 8); i += kThreads) {
    const int r = i / (kDc / 8), ch = i % (kDc / 8);
    const bool valid = r < rows;
    cp_async16(&sm.q[r][ch * 8], valid ? q_tok + (size_t)(head0 + r) * kDc + ch * 8 : q_tok, valid);
  }
  load_tile(sm.k[0], pages, table, page_size, 0, end);
  cp_async_commit();

  float acc[kNt][4];
#pragma unroll
  for (int j = 0; j < kNt; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  // Softmax state of row tid / 16, held by the row's 16 threads.
  float m_run = -INFINITY, l_run = 0.f;
  const int srow = tid / 16, scol = (tid % 16) * 2;
  const int kh = warp / 4, nt = warp % 4;
  const int k_lo = kh ? kNk / 2 : 0, k_hi = kh ? kNk : kNk / 2;

  const int n_tiles = (end + kTile - 1) / kTile;
  for (int it = 0; it < n_tiles; ++it) {
    const int base = it * kTile;
    __nv_bfloat16 (*kt)[kLd] = sm.k[it & 1];
    if (it + 1 < n_tiles) {
      load_tile(sm.k[(it + 1) & 1], pages, table, page_size, base + kTile, end);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // Scores: rows 0..15 x columns 8 * nt .. + 8, over this warp's k half.
    {
      float sc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 6
      for (int ks = k_lo; ks < k_hi; ++ks) {
        uint32_t a[4], b[2];
        ldmatrix_x4(a, &sm.q[lane % 16][ks * 16 + (lane / 16) * 8]);
        ldmatrix_x2(b, &kt[nt * 8 + lane % 8][ks * 16 + ((lane / 8) % 2) * 8]);
        mma_bf16(sc, a, b);
      }
      float (*s_out)[kTile] = sm.s[kh];
      s_out[g][nt * 8 + 2 * c] = sc[0];
      s_out[g][nt * 8 + 2 * c + 1] = sc[1];
      s_out[g + 8][nt * 8 + 2 * c] = sc[2];
      s_out[g + 8][nt * 8 + 2 * c + 1] = sc[3];
    }
    __syncthreads();

    // Online softmax: thread holds columns scol, scol + 1 of row srow.
    {
      float s2[2];
      bool valid[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = scol + e;
        valid[e] = base + col < end;
        const float v = (sm.s[0][srow][col] + sm.s[1][srow][col]) * sm_scale;
        s2[e] = valid[e] ? v : -INFINITY;
      }
      float mx = fmaxf(s2[0], s2[1]);
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_run, mx);  // finite: the tile holds a visible row
      const float p0 = valid[0] ? __expf(s2[0] - m_new) : 0.f;
      const float p1 = valid[1] ? __expf(s2[1] - m_new) : 0.f;
      float sum = p0 + p1;
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float alpha = __expf(m_run - m_new);  // 0 on the first tile
      l_run = l_run * alpha + sum;
      m_run = m_new;
      *reinterpret_cast<__nv_bfloat162*>(&sm.p[srow][scol]) = __floats2bfloat162_rn(p0, p1);
      if (tid % 16 == 0) sm.alpha[srow] = alpha;
    }
    __syncthreads();

    // acc = acc * alpha + p @ V, V = this tile's first kVd columns.
    {
      const float a_lo = sm.alpha[g], a_hi = sm.alpha[g + 8];
#pragma unroll
      for (int j = 0; j < kNt; ++j) {
        acc[j][0] *= a_lo;
        acc[j][1] *= a_lo;
        acc[j][2] *= a_hi;
        acc[j][3] *= a_hi;
      }
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, &sm.p[lane % 16][kk * 16 + (lane / 16) * 8]);
#pragma unroll
        for (int j = 0; j < kNt; ++j) {
          uint32_t b[2];
          ldmatrix_x2_trans(b, &kt[kk * 16 + lane % 16][warp * kCols + j * 8]);
          mma_bf16(acc[j], a, b);
        }
      }
    }
    __syncthreads();  // this buffer is reloaded two tiles on
  }

  if (tid % 16 == 0) sm.l[srow] = l_run;
  __syncthreads();
  const float l_lo = sm.l[g], l_hi = sm.l[g + 8];
  const float inv_lo = l_lo > 0.f ? 1.f / l_lo : 0.f;
  const float inv_hi = l_hi > 0.f ? 1.f / l_hi : 0.f;
#pragma unroll
  for (int j = 0; j < kNt; ++j) {
    const int col = warp * kCols + j * 8 + 2 * c;
    if (g < rows)
      *reinterpret_cast<__nv_bfloat162*>(out_tok + (size_t)(head0 + g) * kVd + col) =
          __floats2bfloat162_rn(acc[j][0] * inv_lo, acc[j][1] * inv_lo);
    if (g + 8 < rows)
      *reinterpret_cast<__nv_bfloat162*>(out_tok + (size_t)(head0 + g + 8) * kVd + col) =
          __floats2bfloat162_rn(acc[j][2] * inv_hi, acc[j][3] * inv_hi);
  }
}

// K9: block (s, head group); rows s >= num_seqs write zeros.
__global__ void __launch_bounds__(kThreads)
mla_decode_kernel(const __nv_bfloat16* __restrict__ q,      // [T, H, kDc]
                  const __nv_bfloat16* __restrict__ pages,  // [P, page, 1, kDc]
                  const int* __restrict__ kv_lens,          // [S]
                  const int* __restrict__ page_indices,     // [S, maxp]
                  __nv_bfloat16* __restrict__ out,          // [T, H, kVd]
                  int num_seqs, int maxp, int page_size, int n_heads, float sm_scale) {
  extern __shared__ __align__(16) char smem[];
  const int s = blockIdx.x;
  const int end = s < num_seqs ? kv_lens[s] : 0;
  attend(q + (size_t)s * n_heads * kDc, pages, page_indices + (size_t)min(s, num_seqs - 1) * maxp,
         page_size, end, n_heads, blockIdx.y * kRows, sm_scale, out + (size_t)s * n_heads * kVd,
         *reinterpret_cast<Smem*>(smem));
}

// K10: block (token, head group); the token's sequence by binary search.
__global__ void __launch_bounds__(kThreads)
mla_prefill_kernel(const __nv_bfloat16* __restrict__ q,      // [T, H, kDc]
                   const __nv_bfloat16* __restrict__ pages,  // [P, page, 1, kDc]
                   const int* __restrict__ kv_lens,          // [S]
                   const int* __restrict__ page_indices,     // [S, maxp]
                   const int* __restrict__ cu_q_lens,        // [S + 1]
                   const int* __restrict__ num_seqs,         // [1]
                   __nv_bfloat16* __restrict__ out,          // [T, H, kVd]
                   int S, int maxp, int page_size, int n_heads, float sm_scale) {
  extern __shared__ __align__(16) char smem[];
  const int t = blockIdx.x;
  const int n_real = min(max(num_seqs[0], 0), S);
  int s = 0, end = 0;
  if (t < cu_q_lens[n_real]) {
    int lo = 0, hi = S - 1;
    while (lo < hi) {  // the first s with cu_q_lens[s + 1] > t
      const int mid = (lo + hi) >> 1;
      if (cu_q_lens[mid + 1] > t) hi = mid; else lo = mid + 1;
    }
    s = lo;
    const int kv_len = kv_lens[s];
    const int q_start = cu_q_lens[s];
    const int pos = kv_len - (cu_q_lens[s + 1] - q_start) + (t - q_start);
    end = min(pos + 1, kv_len);
  }
  attend(q + (size_t)t * n_heads * kDc, pages, page_indices + (size_t)s * maxp, page_size, end,
         n_heads, blockIdx.y * kRows, sm_scale, out + (size_t)t * n_heads * kVd,
         *reinterpret_cast<Smem*>(smem));
}

// Allows a kernel its dynamic shared memory, once per kernel.
template <typename Kernel>
int allow_smem(Kernel kernel) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)sizeof(Smem));
}

bool shape_ok(int n_heads, int latent_dim, int v_dim) {
  return n_heads > 0 && latent_dim == kDc && v_dim == kVd;
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each launches on `stream` and
// returns a CUDA error code (0 on success); neither synchronises. latent_dim
// and v_dim must be 576 and 512.
extern "C" int scalellm_mla_decode(const void* q, const void* k_pages, const void* kv_lens,
                                   const void* page_indices, void* out, int num_rows,
                                   int num_seqs, int maxp, int page_size, int n_heads,
                                   int latent_dim, int v_dim, float sm_scale, void* stream) {
  if (num_rows == 0) return 0;
  if (!shape_ok(n_heads, latent_dim, v_dim) || num_seqs <= 0 || num_rows < num_seqs)
    return (int)cudaErrorInvalidValue;
  static const int rc = allow_smem(mla_decode_kernel);
  if (rc) return rc;
  const dim3 grid(num_rows, (n_heads + kRows - 1) / kRows);
  mla_decode_kernel<<<grid, kThreads, sizeof(Smem), reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k_pages),
      static_cast<const int*>(kv_lens), static_cast<const int*>(page_indices),
      static_cast<__nv_bfloat16*>(out), num_seqs, maxp, page_size, n_heads, sm_scale);
  return (int)cudaGetLastError();
}

extern "C" int scalellm_mla_prefill(const void* q, const void* k_pages, const void* kv_lens,
                                    const void* page_indices, const void* cu_q_lens,
                                    const void* num_seqs, void* out, int num_tokens,
                                    int num_seq_slots, int maxp, int page_size, int n_heads,
                                    int latent_dim, int v_dim, float sm_scale, void* stream) {
  if (num_tokens == 0) return 0;
  if (!shape_ok(n_heads, latent_dim, v_dim) || num_seq_slots <= 0)
    return (int)cudaErrorInvalidValue;
  static const int rc = allow_smem(mla_prefill_kernel);
  if (rc) return rc;
  const dim3 grid(num_tokens, (n_heads + kRows - 1) / kRows);
  mla_prefill_kernel<<<grid, kThreads, sizeof(Smem), reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k_pages),
      static_cast<const int*>(kv_lens), static_cast<const int*>(page_indices),
      static_cast<const int*>(cu_q_lens), static_cast<const int*>(num_seqs),
      static_cast<__nv_bfloat16*>(out), num_seq_slots, maxp, page_size, n_heads, sm_scale);
  return (int)cudaGetLastError();
}
