// Ragged paged attention for Hopper (sm_90a), bf16 or int8 pages, f32 online
// softmax, bf16 tensor-core products (mma.sync m16n8k16).
//
// Replaces the stock Pallas ragged-paged-attention kernel that
// scalellm_tpu/ops/attention.py:132 calls. It computes what
// scalellm_tpu/ops/attention_ref.py:ref_ragged_paged_attention computes
// (plain PyTorch version: scalellm_tpu_torch/ops/attention_ref.py), not the
// stock kernel's block structure:
//   - q is a flattened ragged batch [T, H, D] that mixes prefill chunks and
//     decode tokens; cu_q_lens[S+1] gives the chunk boundaries, kv_lens[S]
//     the context lengths, and each chunk is the tail of its context;
//   - KV pages [P, page_size, 2*Hkv, D], K at even and V at odd combined
//     heads, reached through the block table page_indices[S, MAXP]; bf16,
//     or int8 with static k and v scales;
//   - GQA (group <= 16), causal masking by absolute position, sliding window
//     (<= 0 disables it), ALiBi (score += slope[head] * (kv_pos - q_pos),
//     after the scale and before the soft cap), logit soft cap (<= 0
//     disables it, applied before the max);
//   - rows that own no KV (padding sequences with kv_len 0, and rows at or
//     past cu_q_lens[num_seqs]) write zeros, never NaN.
// Page 0 is the reserved padding page: padding tokens write their K/V
// there, and no real sequence's block table walks into it below kv_len.
// Entries of cu_q_lens past the real sequences repeat the last value.
//
// What bounds it on an H100: the bytes of KV it reads. A decode token does
// 4 flops per KV element it loads (q.k and p.v), far below the ~295
// flops/byte the card needs before its tensor cores are the limit; a
// prefill chunk of n tokens does 4n, so at n >= ~64 the flops start to count.
// So every KV row is read from device memory once per (sequence, KV head),
// the card is filled with enough blocks to keep its memory busy, and the
// products run on the tensor cores so that they cost little next to the
// loads. What binds it now (measured: PERF.md): the split path runs at about
// the pace of its load ring alone, two stages ahead of the products
// against the memory latency; the tile path adds its products and softmax
// to its ring's pace.
//
// Design. One launch of attention_kernel computes two kinds of blocks, and
// merge_kernel (launched by the same entry point) finishes the split rows:
//   - split blocks (s, split, KV head) take a sequence slot whose query is a
//     single token (every slot of a decode step, the decodes of a mixed
//     step; a decode step runs the same launch and its tile blocks find no
//     tile). The slot's KV range is cut into `splits` pieces of split_len
//     rows (a multiple of the 64-row stage), which the host sizes
//     from the block table's length, S, Hkv and the SM count, never from a
//     device value. The block's group q rows (<= 16) are one mma A operand;
//     its 4 warps take 16 of each stage's 64 KV rows each, and meet in
//     shared memory at the end. It writes f32 partials (unnormalised o, its
//     max m and sum l) to scratch, or an empty partial (m = -inf, l = 0)
//     when its split lies past kv_len or before the window;
//   - tile blocks (tile, KV head) take BQ = 64 / group query tokens of one
//     sequence of 2 or more tokens: BQ x group = up to 64 q rows, 16 a
//     warp (32 rows at D = 256, below). The device maps a tile to its sequence (a scan of the
//     per-sequence tile counts from cu_q_lens); the grid is sized from T
//     and S. The tile's KV range (the union of its tokens' ranges) is
//     walked once, shared by every row, with per-row causal and window
//     masks by absolute position; the block writes its bf16 rows;
//   - both stream their K and V rows through a 3-stage cp.async ring (16
//     bytes a thread, rows past the range zero-filled, so a masked p = 0
//     never meets garbage) with an XOR swizzle of the 16-byte chunks, so
//     ldmatrix (K) and ldmatrix.trans (V) read without bank conflicts.
//     S = QK^T and O += PV run on mma.sync; P stays in registers, rounded
//     to bf16 for the PV product (as FlashAttention-2 does); the softmax
//     runs in base 2 with the scale folded in;
//   - merge_kernel, one thread per 4 dims of a q row's head: merges a split
//     row's partials in split order (over the splits its KV range touches)
//     and writes its bf16 row; writes zeros for padding rows and for split
//     rows without KV; leaves tile rows alone. It is launched as the
//     attention grid's programmatic dependent, so its launch and slot
//     lookup overlap that grid.
//   - head dim 256 (Gemma, Gemma2): a warp's q A fragments would take 64
//     registers a thread beside the 128 of its accumulator and the 32 of
//     its scores, past the 255 a thread has, so at D = 256 each warp stages
//     its 16 q rows in shared memory behind the ring (swizzled as a stage
//     is) and loads a k16 step's fragment with one ldmatrix where it needs
//     it (QOperand). That is enough for the split blocks (16 columns of
//     scores a warp). A tile block still spilled, so there two pairs of
//     warps take the same 32 q rows (BQ = 32 / group tokens), each warp of
//     a pair computing the whole scores but the PV product of its half of
//     D (an accumulator of 64 registers). The ring keeps its 3 stages of 64
//     rows (192 KB; with q, 224 KB of the 227 KB a block may take), so a
//     D = 256 block has an SM to itself; its 2 stages in flight (128 KB)
//     are more than an SM needs to keep its share of the memory busy.
//   - head dim 80 (Phi-2): a row is 10 16-byte chunks, which the XOR swizzle
//     of 8 chunks cannot permute within the row, so an 80-wide row is staged
//     in a 128-wide stage row (stage_dim) with the D = 128 swizzle; its 6
//     extra chunks are never written nor read (the loads, QK's k16 steps and
//     PV's n8 tiles cover 80 columns), and each row still reads 160 bytes
//     from device memory. The ring is D = 128's (96 KB, two blocks an SM).
//   - ALiBi (MPT, BLOOM) is a template flag, so the other paths keep their
//     code: each row adds its head's slope times its distance to every
//     score, the `whole` fast path included (it skips the masks only).
//   - int8 pages (kv_cache_dtype="int8") are a template flag too. As the
//     stock kernel does, each element is widened to f32, multiplied by the
//     static k_scale or v_scale and rounded to bf16 (exact at the model's
//     scale of 1.0). An int8 row is D bytes, half a 16-byte cp.async per
//     chunk of 8, so the stage loads go through registers instead: each
//     thread loads up to 8 of its chunks of K and of V (8 bytes each; 4 at
//     D = 256) with plain loads, in flight together, then widens them and
//     stores the 16-byte bf16 chunks at the same swizzled offsets. The ring, the
//     products and the merge are the bf16 kernel's. The loads are
//     synchronous: a thread waits for its stage's bytes before it attends
//     the stage before (a simple form; PERF.md has its time).
// No float atomics: the same inputs give the same bits on every call.
// Head dims other than 64, 80, 128 and 256 are not covered; the Python
// wrapper refuses them. f32 q and pages go to the kernel of
// ragged_paged_attention_f32.cu.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;                 // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kStage = 64;                    // KV rows per ring stage
constexpr int kStages = 3;                    // ring depth
constexpr int kMaxGroup = 16;                 // query heads per KV head
constexpr int kRedPad = 4;                    // floats after each row of the warp merge
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const __nv_bfloat16* q;         // [T, H, D]
  const __nv_bfloat16* kv;        // [P, page, 2*Hkv, D] (bf16 pages)
  const int8_t* kv8;              // [P, page, 2*Hkv, D] (int8 pages; the kInt8 instances only)
  const int* kv_lens;             // [S]
  const int* table;               // [S, maxp]
  const int* cu;                  // [S+1]
  const int* num_seqs;            // [1]
  __nv_bfloat16* out;             // [T, H, D]
  float* o_part;                  // [S, splits, H, D]
  float2* ml_part;                // [S, splits, H]: (m in base 2, l)
  int T, S, maxp, page_size, page_shift, n_heads, n_kv_heads, group;  // page_shift: log2, or -1
  int splits, split_len;          // split blocks: pieces of a slot's KV range
  int tile_tokens, tile_blocks;   // tile blocks: tokens a tile, grid share (set by launch<D>)
  int window;
  float sm_scale, soft_cap;
  float scale_log2;               // sm_scale * log2(e): scores in base 2 without a soft cap
  const float* alibi;             // [H] ALiBi slopes (the kAlibi instances only)
  float k_scale, v_scale;         // int8 pages: element = bf16(int8 * scale)
};

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
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x (ex2.approx: 2 ulp; -inf gives 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Programmatic dependent launch: the grid launched behind this one may
// start (griddep_launch); a grid waits for the one before it to finish and
// its writes to be visible (griddep_wait).
__device__ __forceinline__ void griddep_launch() { asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory"); }
__device__ __forceinline__ void griddep_wait() { asm volatile("griddepcontrol.wait;\n" ::: "memory"); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Elements of a stage row: D, or 128 at D = 80 (10 chunks do not take the
// 8-chunk XOR swizzle within a row; see the design notes).
template <int D>
__host__ __device__ constexpr int stage_dim() {
  return D == 80 ? 128 : D;
}

// Element offset of 16-byte chunk `ch` of row `j` in a [kStage, stage_dim]
// stage: the chunk index is XORed with the row's low 3 bits, so the 8 rows
// one ldmatrix phase reads lie in 8 different bank groups.
template <int D>
__device__ __forceinline__ int swz(int j, int ch) {
  return j * stage_dim<D>() + ((ch ^ (j & 7)) << 3);
}

// 8 int8 elements (a 16-byte bf16 chunk's worth), widened to f32, times
// `scale`, rounded to bf16: the stock kernel's (int8 -> f32) * scale cast to
// q's type.
__device__ __forceinline__ uint4 widen8(uint2 w, float scale) {
  const auto el = [&](uint32_t word, int i) { return (float)(int8_t)(word >> (8 * i)) * scale; };
  return make_uint4(pack_bf16(el(w.x, 0), el(w.x, 1)), pack_bf16(el(w.x, 2), el(w.x, 3)),
                    pack_bf16(el(w.y, 0), el(w.y, 1)), pack_bf16(el(w.y, 2), el(w.y, 3)));
}

// KV head h's first K row element in the pages (V follows D elements on):
// bf16 pages, or int8 pages in the kInt8 instances.
template <int D, bool kInt8>
__device__ __forceinline__ const void* kv_head_of(const Params& p, int h) {
  if constexpr (kInt8) return p.kv8 + (size_t)(2 * h) * D;
  return p.kv + (size_t)(2 * h) * D;
}

// Stage K and V rows [base, base + kStage) of one KV head; rows at or past
// `end` are zero-filled. Row i lies at page table[i / page_size], slot
// i % page_size. bf16 pages: 16-byte cp.async a chunk. int8 pages: 8-byte
// loads into registers, a batch of up to 8 chunks of K and of V in flight
// together, widened (widen8) and stored as bf16 at the same offsets.
template <int D, bool kInt8>
__device__ __forceinline__ void load_stage(__nv_bfloat16* ks, const Params& p, const void* kv_head,
                                           const int* table, int base, int end) {
  constexpr int kChunks = D / 8;  // 16-byte bf16 chunks a row
  constexpr int kIters = kStage * kChunks / kThreads;
  static_assert(kStage * kChunks % kThreads == 0, "stage chunks");
  __nv_bfloat16* vs = ks + kStage * stage_dim<D>();
  const size_t row_stride = (size_t)2 * p.n_kv_heads * D;  // elements
  const auto row_of = [&](int pos) {
    const int pg = p.page_shift >= 0 ? pos >> p.page_shift : pos / p.page_size;
    return ((size_t)table[pg] * p.page_size + (pos - pg * p.page_size)) * row_stride;
  };
  if constexpr (!kInt8) {
    const __nv_bfloat16* head = static_cast<const __nv_bfloat16*>(kv_head);
#pragma unroll
    for (int i = 0; i < kIters; ++i) {
      const int c = threadIdx.x + i * kThreads;
      const int j = c / kChunks, ch = c % kChunks;
      const int pos = base + j;
      const bool valid = pos < end;
      const __nv_bfloat16* src = valid ? head + row_of(pos) + ch * 8 : head;
      const int off = swz<D>(j, ch);
      cp_async16(ks + off, src, valid);
      cp_async16(vs + off, valid ? src + D : head, valid);
    }
  } else {
    const int8_t* head = static_cast<const int8_t*>(kv_head);
    // Chunks in flight a batch: 8 (32 registers), 4 at D = 256, whose tile
    // blocks hold 128 accumulator registers beside them.
    constexpr int kBatch = D > 128 ? 4 : (kIters < 8 ? kIters : 8);
    static_assert(kIters % kBatch == 0, "whole batches");
#pragma unroll
    for (int i0 = 0; i0 < kIters; i0 += kBatch) {
      uint2 kw[kBatch], vw[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int c = threadIdx.x + (i0 + i) * kThreads;
        const int pos = base + c / kChunks;
        kw[i] = vw[i] = make_uint2(0u, 0u);
        if (pos < end) {
          const int8_t* src = head + row_of(pos) + (c % kChunks) * 8;
          kw[i] = *reinterpret_cast<const uint2*>(src);
          vw[i] = *reinterpret_cast<const uint2*>(src + D);
        }
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int c = threadIdx.x + (i0 + i) * kThreads;
        const int off = swz<D>(c / kChunks, c % kChunks);
        *reinterpret_cast<uint4*>(ks + off) = widen8(kw[i], p.k_scale);
        *reinterpret_cast<uint4*>(vs + off) = widen8(vw[i], p.v_scale);
      }
    }
  }
}

// The q rows of one warp as mma A fragments: row_lo holds rows g and
// row_hi rows g + 8 (null: a padding row, zeros).
template <int D>
__device__ __forceinline__ void load_q(uint32_t (&qa)[D / 16][4], const __nv_bfloat16* row_lo,
                                       const __nv_bfloat16* row_hi) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const int c = ks * 16 + 2 * t;
    qa[ks][0] = row_lo ? *reinterpret_cast<const uint32_t*>(row_lo + c) : 0u;
    qa[ks][1] = row_hi ? *reinterpret_cast<const uint32_t*>(row_hi + c) : 0u;
    qa[ks][2] = row_lo ? *reinterpret_cast<const uint32_t*>(row_lo + c + 8) : 0u;
    qa[ks][3] = row_hi ? *reinterpret_cast<const uint32_t*>(row_hi + c + 8) : 0u;
  }
}

// q's A fragments at D = 256 stay in shared memory (see the design notes).
template <int D>
__host__ __device__ constexpr bool q_in_smem() {
  return D > 128;
}

// The q rows of one warp as the mma A operand: registers up to D = 128,
// this warp's [16, D] swizzled rows in shared memory at D = 256.
template <int D>
struct QOperand {
  uint32_t reg[q_in_smem<D>() ? 1 : D / 16][4];
  const __nv_bfloat16* rows;  // q_in_smem: the warp's rows in shared memory

  // Rows g (row_lo) and g + 8 (row_hi) of this warp (null: a padding row,
  // zeros); `smem` is the warp's [16, D] of shared memory (q_in_smem only).
  __device__ __forceinline__ void load(const __nv_bfloat16* row_lo, const __nv_bfloat16* row_hi,
                                       __nv_bfloat16* smem) {
    if constexpr (q_in_smem<D>()) {
      const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
      const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int i = 0; i < D / 32; ++i) {  // the row's 16-byte chunks t, t + 4, ...
        const int ch = t + 4 * i;
        *reinterpret_cast<uint4*>(smem + swz<D>(g, ch)) =
            row_lo ? *reinterpret_cast<const uint4*>(row_lo + ch * 8) : zero;
        *reinterpret_cast<uint4*>(smem + swz<D>(g + 8, ch)) =
            row_hi ? *reinterpret_cast<const uint4*>(row_hi + ch * 8) : zero;
      }
      __syncwarp();
      rows = smem;
    } else {
      load_q<D>(reg, row_lo, row_hi);
    }
  }

  // The A fragment of k16 step kk.
  __device__ __forceinline__ void frag(int kk, uint32_t (&a)[4]) const {
    if constexpr (q_in_smem<D>()) {
      const int lane = threadIdx.x & 31;
      ldmatrix_x4(a, rows + swz<D>(lane & 15, 2 * kk + (lane >> 4)));
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = reg[kk][i];
    }
  }
};

// Online-softmax state of one warp's 16 rows over DV output columns; this
// lane holds rows g (index 0) and g + 8 (index 1). l is the lane's share of
// the row sum until row_sums() adds the row's 4 lanes.
template <int DV>
struct WarpAcc {
  float o[DV / 8][4];
  float m[2], l[2];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int n = 0; n < DV / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;
  }
  __device__ __forceinline__ void row_sums() {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
  }
};

// One warp's ALiBi rows: the slope of each row's head (0 for a padding row)
// and its query's absolute position.
struct RowAlibi {
  float slope[2];
  int q_pos[2];
};

// One warp over NC KV columns [col0, col0 + NC) of a staged tile whose row
// 0 is KV position `base`: S = q K^T, ALiBi (kAlibi), masks, online softmax,
// O += P V for the DV output columns [dv0, dv0 + DV). A column at position
// pos is visible to row r (0: g, 1: g + 8) when lo[r] <= pos < hi[r].
template <int D, int NC, int DV, bool kAlibi>
__device__ __forceinline__ void attend_stage(const __nv_bfloat16* ks, const QOperand<D>& q,
                                             WarpAcc<DV>& acc, const Params& p, int col0, int base,
                                             const int (&lo)[2], const int (&hi)[2], int dv0,
                                             const RowAlibi& al) {
  static_assert(NC % 16 == 0, "columns in k16 steps");
  const __nv_bfloat16* vs = ks + kStage * stage_dim<D>();
  const int lane = threadIdx.x & 31, t = lane & 3, mat = lane >> 3;
  float s[NC / 8][4];
#pragma unroll
  for (int n = 0; n < NC / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;

  // S = Q K^T: K rows are the B operand's columns, d-contiguous.
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    q.frag(kk, a);
#pragma unroll
    for (int n = 0; n < NC / 8; n += 2) {
      uint32_t b[4];
      const int j = col0 + (n + (mat >> 1)) * 8 + (lane & 7);
      ldmatrix_x4(b, ks + swz<D>(j, 2 * kk + (mat & 1)));
      mma_bf16(s[n], a, b[0], b[1]);
      mma_bf16(s[n + 1], a, b[2], b[3]);
    }
  }

  // Scale, ALiBi, soft cap, masks; base-2 scores and the rows' new maxima.
  // Where every column of the warp's share is visible to both rows, no masks.
  const int c0 = base + col0;
  const bool whole = c0 >= lo[0] && c0 + NC <= hi[0] && c0 >= lo[1] && c0 + NC <= hi[1];
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < NC / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      const int pos = c0 + n * 8 + 2 * t + (e & 1);
      float x;
      if constexpr (kAlibi) {
        x = s[n][e] * p.sm_scale + al.slope[r] * (float)(pos - al.q_pos[r]);
        x = p.soft_cap > 0.f ? p.soft_cap * tanhf(x / p.soft_cap) * kLog2e : x * kLog2e;
      } else {
        x = p.soft_cap > 0.f ? p.soft_cap * tanhf(s[n][e] * p.sm_scale / p.soft_cap) * kLog2e
                             : s[n][e] * p.scale_log2;
      }
      if (!whole && !(pos >= lo[r] && pos < hi[r])) x = -INFINITY;
      s[n][e] = x;
      mx[r] = fmaxf(mx[r], x);
    }
  }
  float base_m[2], alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(acc.m[r], mx[r]);
    base_m[r] = m_new == -INFINITY ? 0.f : m_new;  // a row with nothing visible yet
    alpha[r] = exp2_approx(acc.m[r] - base_m[r]);   // 0 while the row was empty
    acc.m[r] = m_new;
  }
#pragma unroll
  for (int n = 0; n < NC / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float pe = exp2_approx(s[n][e] - base_m[e >> 1]);  // masked: 2^-inf = 0
      s[n][e] = pe;
      sum[e >> 1] += pe;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) acc.l[r] = acc.l[r] * alpha[r] + sum[r];
#pragma unroll
  for (int n = 0; n < DV / 8; ++n) {
    acc.o[n][0] *= alpha[0];
    acc.o[n][1] *= alpha[0];
    acc.o[n][2] *= alpha[1];
    acc.o[n][3] *= alpha[1];
  }

  // O += P V: P from the score registers (the C layout of two n8 tiles is
  // the A layout of one k16 step); V rows through ldmatrix.trans.
#pragma unroll
  for (int kk = 0; kk < NC / 16; ++kk) {
    const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                           pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                           pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
    const int j = col0 + kk * 16 + (mat & 1) * 8 + (lane & 7);
#pragma unroll
    for (int n = 0; n < DV / 8; n += 2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, vs + swz<D>(j, dv0 / 8 + n + (mat >> 1)));
      mma_bf16(acc.o[n], a, b[0], b[1]);
      mma_bf16(acc.o[n + 1], a, b[2], b[3]);
    }
  }
}

// Walks KV positions [begin, end) of one (sequence, KV head) through the
// ring. Warp w takes columns (w % KW) * (kStage / KW) of every stage: with
// KW = 1 every warp sees the whole stage (its own 16 q rows), with KW =
// kWarps the warps share the q rows and split the stage. The warp
// accumulates output columns [dv0, dv0 + DV).
template <int D, int KW, int DV, bool kAlibi, bool kInt8>
__device__ __forceinline__ void walk(const Params& p, const void* kv_head, const int* table,
                                     int begin, int end, const QOperand<D>& q, WarpAcc<DV>& acc,
                                     const int (&lo)[2], const int (&hi)[2], __nv_bfloat16* ring, int dv0,
                                     const RowAlibi& al) {
  constexpr int kCols = kStage / KW;
  constexpr int kStageElems = 2 * kStage * stage_dim<D>();
  const int col0 = (threadIdx.x / 32 % KW) * kCols;
  const int n_tiles = (end - begin + kStage - 1) / kStage;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_tiles) load_stage<D, kInt8>(ring + st * kStageElems, p, kv_head, table, begin + st * kStage, end);
    cp_async_commit();
  }
  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile `it` landed; every warp is done with tile it - 1
    const int next = it + kStages - 1;
    if (next < n_tiles)
      load_stage<D, kInt8>(ring + (next % kStages) * kStageElems, p, kv_head, table, begin + next * kStage, end);
    cp_async_commit();
    attend_stage<D, kCols, DV, kAlibi>(ring + (it % kStages) * kStageElems, q, acc, p, col0,
                                       begin + it * kStage, lo, hi, dv0, al);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for reuse
}

// Slot s is finished by a split block and the merge when it is a real
// sequence of one token (row cu[s]). Sets its row and KV length.
__device__ __forceinline__ bool split_slot(const Params& p, int s, int n_real, int& row, int& kv_len) {
  if (s >= n_real || p.cu[s + 1] - p.cu[s] != 1) return false;
  row = p.cu[s];
  if (row >= p.T) return false;
  kv_len = p.kv_lens[s];
  return true;
}

// The KV rows [lo, hi) a split slot's token sees: its window, within the
// block table.
__device__ __forceinline__ void split_range(const Params& p, int kv_len, int& lo, int& hi) {
  lo = p.window > 0 ? max(0, kv_len - p.window) : 0;
  hi = min(kv_len, p.maxp * p.page_size);
}

// Shared memory: the ring, then (q_in_smem) each warp's 16 q rows.
template <int D>
__host__ __device__ constexpr int ring_bytes() {
  return kStages * 2 * kStage * stage_dim<D>() * (int)sizeof(__nv_bfloat16);
}
template <int D>
__host__ __device__ constexpr int smem_bytes() {
  return ring_bytes<D>() + (q_in_smem<D>() ? kWarps * 16 * D * (int)sizeof(__nv_bfloat16) : 0);
}
template <int D>
__device__ __forceinline__ __nv_bfloat16* warp_q_smem(__nv_bfloat16* ring) {
  return ring + ring_bytes<D>() / (int)sizeof(__nv_bfloat16) + (threadIdx.x / 32) * 16 * D;
}

template <int D, bool kAlibi, bool kInt8>
__device__ void split_block(const Params& p, int x, int h, __nv_bfloat16* ring) {
  const int s = x / p.splits, sp = x % p.splits;
  const int n_real = min(max(p.num_seqs[0], 0), p.S);
  int row, kv_len;
  if (!split_slot(p, s, n_real, row, kv_len)) return;  // the merge never reads it
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32, g = lane >> 2;
  const int group = p.group;
  const size_t part = ((size_t)s * p.splits + sp) * p.n_heads + (size_t)h * group;

  int r_lo, r_hi;
  split_range(p, kv_len, r_lo, r_hi);
  const int begin = max(r_lo, sp * p.split_len);
  const int end = min(r_hi, (sp + 1) * p.split_len);
  if (end <= begin) {  // nothing of this split is visible: an empty partial
    if (threadIdx.x < group) p.ml_part[part + threadIdx.x] = make_float2(-INFINITY, 0.f);
    return;
  }

  const __nv_bfloat16* q_tok = p.q + ((size_t)row * p.n_heads + (size_t)h * group) * D;
  QOperand<D> q;
  q.load(g < group ? q_tok + g * D : nullptr, g + 8 < group ? q_tok + (g + 8) * D : nullptr,
         warp_q_smem<D>(ring));
  WarpAcc<D> acc;
  acc.init();
  const int lo[2] = {begin, begin}, hi[2] = {end, end};
  RowAlibi al = {};
  if constexpr (kAlibi) {  // rows g and g + 8 are heads h * group + g, + 8; the token sits at kv_len - 1
    al.slope[0] = g < group ? p.alibi[h * group + g] : 0.f;
    al.slope[1] = g + 8 < group ? p.alibi[h * group + g + 8] : 0.f;
    al.q_pos[0] = al.q_pos[1] = kv_len - 1;
  }
  walk<D, kWarps, D, kAlibi, kInt8>(p, kv_head_of<D, kInt8>(p, h), p.table + (size_t)s * p.maxp, begin, end, q,
                                    acc, lo, hi, ring, 0, al);
  acc.row_sums();

  // The warps' states meet in the (now free) ring: o [warp][16][D + pad].
  float* red_o = reinterpret_cast<float*>(ring);
  float* red_m = red_o + kWarps * 16 * (D + kRedPad);
  float* red_l = red_m + kWarps * 16;
  const int t = lane & 3;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    float* r0 = red_o + (warp * 16 + g) * (D + kRedPad) + n * 8 + 2 * t;
    *reinterpret_cast<float2*>(r0) = make_float2(acc.o[n][0], acc.o[n][1]);
    *reinterpret_cast<float2*>(r0 + 8 * (D + kRedPad)) = make_float2(acc.o[n][2], acc.o[n][3]);
  }
  if (t == 0) {
    red_m[warp * 16 + g] = acc.m[0];
    red_m[warp * 16 + g + 8] = acc.m[1];
    red_l[warp * 16 + g] = acc.l[0];
    red_l[warp * 16 + g + 8] = acc.l[1];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < group * D; i += kThreads) {
    const int r = i / D, d = i % D;
    float m = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, red_m[w * 16 + r]);
    const float mb = m == -INFINITY ? 0.f : m;
    float o = 0.f, l = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = exp2_approx(red_m[w * 16 + r] - mb);
      o += wt * red_o[(w * 16 + r) * (D + kRedPad) + d];
      l += wt * red_l[w * 16 + r];
    }
    p.o_part[(part + r) * D + d] = o;
    if (d == 0) p.ml_part[part + r] = make_float2(m, l);
  }
}

// A tile block's warps: kRowWarps<D> of them take 16 q rows each; at D =
// 256 two pairs of warps take the same 32 rows, each warp of a pair
// computing the whole scores and the softmax (the same values in both) but
// the PV product and the output of its half of D: an accumulator of D / 2
// columns, 64 registers and not 128, which a thread holds beside its scores
// without spills.
template <int D>
constexpr int kRowWarps = D > 128 ? 2 : kWarps;
template <int D>
__host__ __device__ constexpr int tile_q_rows() {
  return 16 * kRowWarps<D>;
}

template <int D, bool kAlibi, bool kInt8>
__device__ void tile_block(const Params& p, int b, int h, __nv_bfloat16* ring) {
  constexpr int DV = D * kRowWarps<D> / kWarps;  // output columns a warp accumulates
  __shared__ int found[2];  // sequence, tile within it
  const int n_real = min(max(p.num_seqs[0], 0), p.S);
  const int bq = p.tile_tokens;
  if (threadIdx.x < 32) {
    // Warp 0 scans the per-sequence tile counts (sequences of 2 or more
    // tokens) for the sequence that holds tile b.
    const int lane = threadIdx.x;
    int before = 0, seq = -1, tile = 0;  // before: tiles of the slots already scanned
    for (int s0 = 0; s0 < n_real; s0 += 32) {
      const int s = s0 + lane;
      const int q_len = s < n_real ? p.cu[s + 1] - p.cu[s] : 0;
      const int own = q_len >= 2 ? (q_len + bq - 1) / bq : 0;
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
        break;
      }
      before += __shfl_sync(0xffffffffu, incl, 31);
    }
    if (lane == 0) {
      found[0] = seq;
      found[1] = tile;
    }
  }
  __syncthreads();
  const int s = found[0];
  if (s < 0) return;  // past the last tile (the grid is sized from T and S)

  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32, g = lane >> 2;
  const int group = p.group;
  const int q_start = p.cu[s], q_len = p.cu[s + 1] - q_start, kv_len = p.kv_lens[s];
  const int tok0 = found[1] * bq;
  const int n_tok = min(bq, q_len - tok0);
  const int pos0 = kv_len - q_len + tok0;  // absolute position of the tile's first token
  const int kv_cap = min(kv_len, p.maxp * p.page_size);

  // Rows g and g + 8 of this warp: token r / group, head r % group; its
  // output columns from dv0.
  const int dv0 = warp / kRowWarps<D> * DV;
  int lo[2], hi[2];
  const __nv_bfloat16* q_row[2];
  RowAlibi al = {};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp % kRowWarps<D> * 16 + g + 8 * i;
    const int k = r / group;
    const int pos = pos0 + k;
    q_row[i] = nullptr;
    lo[i] = hi[i] = 0;
    if (k < n_tok) {
      q_row[i] = p.q + ((size_t)(q_start + tok0 + k) * p.n_heads + (size_t)h * group + r % group) * D;
      lo[i] = p.window > 0 ? max(0, pos - p.window + 1) : 0;
      hi[i] = min(pos + 1, kv_cap);
      if constexpr (kAlibi) {
        al.slope[i] = p.alibi[h * group + r % group];
        al.q_pos[i] = pos;
      }
    }
  }
  const int begin = p.window > 0 ? max(0, pos0 - p.window + 1) : 0;
  const int end = min(pos0 + n_tok, kv_cap);

  QOperand<D> q;
  q.load(q_row[0], q_row[1], warp_q_smem<D>(ring));
  WarpAcc<DV> acc;
  acc.init();
  if (end > begin)
    walk<D, 1, DV, kAlibi, kInt8>(p, kv_head_of<D, kInt8>(p, h), p.table + (size_t)s * p.maxp, begin, end, q,
                                  acc, lo, hi, ring, dv0, al);
  acc.row_sums();

  const int t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!q_row[i]) continue;
    const float inv = acc.l[i] > 0.f ? 1.f / acc.l[i] : 0.f;
    __nv_bfloat16* dst = p.out + (q_row[i] - p.q) + dv0;
#pragma unroll
    for (int n = 0; n < DV / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + n * 8 + 2 * t) =
          __floats2bfloat162_rn(acc.o[n][2 * i] * inv, acc.o[n][2 * i + 1] * inv);
  }
}

// Block (x, KV head): x < tile_blocks is a tile block, the rest are split
// blocks (slot, split) = ((x - tile_blocks) / splits, % splits).
template <int D, bool kAlibi, bool kInt8>
__global__ void __launch_bounds__(kThreads, 2) ragged_paged_attention_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  const int x = blockIdx.x, h = blockIdx.y;
  griddep_launch();  // the merge may start; it waits for this grid before it reads
  if (x < p.tile_blocks)
    tile_block<D, kAlibi, kInt8>(p, x, h, ring);
  else
    split_block<D, kAlibi, kInt8>(p, x - p.tile_blocks, h, ring);
}

// Block (t, c): q row t, its quads (4 dims of one head) c * kThreads ..,
// one a thread. A split row merges its slot's partials in split order,
// over the splits that hold some of its KV range (the others are empty); a
// padding row (and a split row without KV) writes zeros; a tile row is
// left to its tile block.
template <int D>
__global__ void __launch_bounds__(kThreads) ragged_paged_attention_merge_kernel(const Params p) {
  constexpr int kQuads = D / 4;
  const int t = blockIdx.x;
  const int n_real = min(max(p.num_seqs[0], 0), p.S);
  int s = -1, row = 0, kv_len = 0;  // s: the split slot whose row t is, else -1 (zeros)
  bool tile_row = false;
  if (t < p.cu[n_real]) {
    int lo = 0, hi = p.S - 1;
    while (lo < hi) {  // the first s with cu[s + 1] > t
      const int mid = (lo + hi) >> 1;
      if (p.cu[mid + 1] > t) hi = mid; else lo = mid + 1;
    }
    if (split_slot(p, lo, n_real, row, kv_len)) s = lo; else tile_row = true;
  }
  // Every block waits, so that this grid ends after the attention grid and
  // the kernels behind it see its rows.
  griddep_wait();
  const int i = blockIdx.y * kThreads + threadIdx.x;
  if (tile_row || i >= p.n_heads * kQuads) return;
  const int hq = i / kQuads, d = (i % kQuads) * 4;
  float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
  float l = 0.f;
  if (s >= 0) {
    int lo, hi;
    split_range(p, kv_len, lo, hi);
    const int sp0 = lo / p.split_len, sp1 = hi > lo ? (hi - 1) / p.split_len + 1 : sp0;
    const size_t part0 = (size_t)s * p.splits * p.n_heads + hq;  // split sp: + sp * n_heads
    float m = -INFINITY;
#pragma unroll 8
    for (int sp = sp0; sp < sp1; ++sp) m = fmaxf(m, p.ml_part[part0 + (size_t)sp * p.n_heads].x);
#pragma unroll 4
    for (int sp = sp0; sp < sp1; ++sp) {
      const size_t part = part0 + (size_t)sp * p.n_heads;
      const float2 ml = p.ml_part[part];
      const float4 v = *reinterpret_cast<const float4*>(p.o_part + part * D + d);
      const float w = exp2_approx(ml.x - m);
      o.x += w * v.x;
      o.y += w * v.y;
      o.z += w * v.z;
      o.w += w * v.w;
      l += w * ml.y;
    }
  }
  const float inv = l > 0.f ? 1.f / l : 0.f;
  __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(p.out + ((size_t)t * p.n_heads + hq) * D + d);
  dst[0] = __floats2bfloat162_rn(o.x * inv, o.y * inv);
  dst[1] = __floats2bfloat162_rn(o.z * inv, o.w * inv);
}

static_assert(kWarps * 16 * (64 + kRedPad + 2) * 4 <= ring_bytes<64>(), "warp merge fits the ring");
static_assert(kWarps * 16 * (80 + kRedPad + 2) * 4 <= ring_bytes<80>(), "warp merge fits the ring");
static_assert(kWarps * 16 * (128 + kRedPad + 2) * 4 <= ring_bytes<128>(), "warp merge fits the ring");
static_assert(kWarps * 16 * (256 + kRedPad + 2) * 4 <= ring_bytes<256>(), "warp merge fits the ring");
static_assert(smem_bytes<256>() + 16 <= 232448, "ring, q rows and the tile lookup fit a block's shared memory");

template <int D, bool kAlibi, bool kInt8>
int launch(Params p, cudaStream_t st) {
  p.tile_tokens = tile_q_rows<D>() / p.group;
  // Sequences of 2 or more tokens hold at most T / tile_tokens + S tiles.
  p.tile_blocks = (p.T + p.tile_tokens - 1) / p.tile_tokens + min(p.S, p.T);
  static const int smem_rc = (int)cudaFuncSetAttribute(
      ragged_paged_attention_kernel<D, kAlibi, kInt8>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<D>());
  if (smem_rc) return smem_rc;
  const dim3 grid(p.tile_blocks + p.S * p.splits, p.n_kv_heads);
  ragged_paged_attention_kernel<D, kAlibi, kInt8><<<grid, kThreads, smem_bytes<D>(), st>>>(p);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  // The merge is the attention grid's programmatic dependent: it is launched
  // while that grid runs, finds its slot, then waits for it.
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.T, (p.n_heads * (D / 4) + kThreads - 1) / kThreads);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, ragged_paged_attention_merge_kernel<D>, p);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

template <int D>
int launch_any(const Params& p, cudaStream_t st) {
  if (p.kv8) return p.alibi ? launch<D, true, true>(p, st) : launch<D, false, true>(p, st);
  return p.alibi ? launch<D, true, false>(p, st) : launch<D, false, false>(p, st);
}

}  // namespace

// Plain C entry point, loaded with ctypes. Launches the attention kernel and
// the merge on `stream` and returns cudaGetLastError() (0 on success); it
// never synchronises. `scratch` holds S * splits * n_heads * (head_dim + 2)
// floats (the wrapper allocates it); splits and split_len come from the
// wrapper's split plan. `alibi_slopes`: f32 [n_heads] on the device, or
// null (no ALiBi). kv_int8: the pages are int8, each element read as
// bf16(element * k_scale) (K) or bf16(element * v_scale) (V); else bf16
// pages (the scales unused).
extern "C" int scalellm_ragged_paged_attention(
    const void* q, const void* kv_pages, const void* kv_lens, const void* page_indices,
    const void* cu_q_lens, const void* num_seqs, void* out, void* scratch, const void* alibi_slopes,
    int num_tokens, int num_seq_slots, int maxp, int page_size, int n_heads, int n_kv_heads, int head_dim,
    int splits, int split_len, float sm_scale, int window, float soft_cap, int kv_int8, float k_scale,
    float v_scale, void* stream) {
  if (num_tokens == 0) return 0;
  if (n_kv_heads <= 0 || n_heads % n_kv_heads != 0 || n_heads / n_kv_heads > kMaxGroup ||
      num_seq_slots <= 0 || maxp <= 0 || page_size <= 0 || splits <= 0 || split_len <= 0 ||
      split_len % kStage != 0)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.kv = kv_int8 ? nullptr : static_cast<const __nv_bfloat16*>(kv_pages);
  p.kv8 = kv_int8 ? static_cast<const int8_t*>(kv_pages) : nullptr;
  p.k_scale = k_scale;
  p.v_scale = v_scale;
  p.kv_lens = static_cast<const int*>(kv_lens);
  p.table = static_cast<const int*>(page_indices);
  p.cu = static_cast<const int*>(cu_q_lens);
  p.num_seqs = static_cast<const int*>(num_seqs);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.o_part = static_cast<float*>(scratch);
  p.ml_part = reinterpret_cast<float2*>(p.o_part + (size_t)num_seq_slots * splits * n_heads * head_dim);
  p.T = num_tokens;
  p.S = num_seq_slots;
  p.maxp = maxp;
  p.page_size = page_size;
  p.page_shift = (page_size & (page_size - 1)) == 0 ? __builtin_ctz(page_size) : -1;
  p.n_heads = n_heads;
  p.n_kv_heads = n_kv_heads;
  p.group = n_heads / n_kv_heads;
  p.splits = splits;
  p.split_len = split_len;
  p.window = window;
  p.sm_scale = sm_scale;
  p.soft_cap = soft_cap;
  p.scale_log2 = sm_scale * kLog2e;
  p.alibi = static_cast<const float*>(alibi_slopes);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64: return launch_any<64>(p, st);
    case 80: return launch_any<80>(p, st);
    case 128: return launch_any<128>(p, st);
    case 256: return launch_any<256>(p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
