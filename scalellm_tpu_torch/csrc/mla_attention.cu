// MLA latent attention for Hopper (sm_90a): the decode kernel (K9) and the
// ragged prefill kernel (K10) over a K-only latent page cache, bf16 pages,
// f32 online softmax, bf16 tensor-core products (mma.sync m16n8k16).
//
// Replaces scalellm_tpu/ops/mla_attention.py:_mla_decode_kernel (K9, one
// query per sequence, called by mla_decode_attention) and
// :_mla_prefill_kernel (K10, a ragged batch of prefill chunks and decode
// tokens, called by mla_prefill_attention). Plain PyTorch versions:
// scalellm_tpu_torch/ops/mla_attention.py plain_mla_decode,
// plain_mla_prefill, and plain_mla_split_decode for the split-and-merge.
// Both compute DeepSeek's absorbed MLA, which is multi-query attention over
// one shared latent head:
//   - pages [P, page_size, 1, Dc] hold K = [c_kv | k_pe] only; V is the
//     first v_dim (= kv_lora_rank) columns of the same rows, so one staged
//     tile of rows serves both products and V is never loaded twice. Built
//     for DeepSeek-V2's widths only (V2, V2-Lite and V3 alike): Dc = 576,
//     v_dim = 512; the entry points refuse any other;
//   - q [T, H, Dc], scores over all Dc columns (the rope part included),
//     scaled by sm_scale (the caller folds yarn's mscale^2 into it), any H
//     in groups of 16 heads;
//   - K9: row s < S of q is sequence s's only query and attends its first
//     kv_len rows; rows s >= S and sequences with kv_len 0 write zeros;
//   - K10: token i of a chunk of q_len attends rows [0, pos] with pos =
//     kv_len - q_len + i, its absolute position (causal), within kv_len.
//     Each token writes only its own output rows; rows at or past
//     cu_q_lens[num_seqs] write zeros.
//
// What bounds it on an H100: at decode, the latent bytes it reads (a query
// row does 2 * (Dc + v_dim) flops per 2 * Dc bytes of K, 16 heads ~30
// flops a byte, far below the ~295 the card needs to be compute-bound); at
// prefill, with many tokens over one context, the flops. So every latent
// row is read from device memory once per (sequence, head group) or, in a
// prefill chunk, once per q tile; the card is filled with enough blocks to
// keep its memory busy; and both products run on the tensor cores.
//
// Design (the split-KV pattern of csrc/ragged_paged_attention.cu). One
// launch of mla_attention_kernel computes two kinds of blocks, and
// mla_merge_kernel (launched by the same entry point) finishes the split
// rows:
//   - split blocks (slot, split, head group) take a sequence of one token:
//     every slot of K9, the decodes of K10's mixed batch. The slot's latent
//     range is cut into `splits` pieces of split_len rows (whole 64-row
//     steps), which the host sizes from the block table's length, S, the
//     head groups and the SM count (mla_split_plan), never from a device
//     value. The head group's 16 query rows are the mma A operand. A split
//     block writes f32 partials (unnormalised o, the max m in base 2 and
//     the sum l) to scratch the wrapper allocates, or an empty partial (m =
//     -inf, l = 0) when its piece lies past kv_len;
//   - tile blocks (q tile, head group), K10 only, take kTileTokens = 2
//     tokens of one sequence of 2 or more tokens: 32 query rows, one m16
//     tile a token, each with its own causal mask by absolute position. The
//     device maps a tile to its sequence by a scan of the per-sequence tile
//     counts from cu_q_lens; the grid is sized from T and S (ceil(T / 2) +
//     min(S, T) tiles) and walked in reverse, so the last tiles of a chunk,
//     which see the most rows, start first; the spare tiles zero the
//     padding rows. The tile's latent range is walked once for both tokens;
//     the block writes its bf16 rows;
//   - both walk their range in steps of 64 latent rows through a ring of
//     five 32-row slots. Warp 0 fills a slot with one bulk copy (the TMA
//     unit) a latent row, completion counted on the slot's mbarrier; each
//     copy lands in a row padded to 1168 bytes, so ldmatrix (K) and
//     ldmatrix.trans (V) read without bank conflicts; rows past the range
//     are zeroed, so a masked p = 0 never meets garbage. The block table's
//     entries for a step's loads are staged in shared memory a step ahead
//     (4-byte cp.async), so no load waits on a read of the table. The q rows
//     sit in shared memory for the whole walk. (With per-thread 16-byte
//     cp.async into a swizzled ring a step cost as much with one block on
//     the card as with 132: the per-SM stream set it. The bulk copies took
//     K10's mixed step from 0.062 to 0.048 ms: PERF.md, PR 13);
//   - a step's scores are split by N over the 8 warps (8 columns a warp
//     for a split block, 16 for a tile block, one m-tile a warp), each over
//     the whole Dc, so no partial scores meet in shared memory. The rows'
//     maxima meet in shared memory (one barrier); p = 2^(s - m) (base 2,
//     the scale folded in) is rounded to bf16 into a shared P tile (a
//     second barrier), and each warp adds P V into the 64 output columns it
//     owns for every m-tile (the 16 x 512 accumulator of a token is split
//     over the warps by column, 32 registers a thread a token). P cannot
//     stay in registers: the warp that owns an output column needs every
//     latent row's p of the step. Three barriers a 64-row step;
//   - mla_merge_kernel, one thread per 4 columns of a (row, head), K9 a
//     block per q row, K10 a block per slot: merges a split row's partials
//     in split order, over the splits its range touches (their (m, l)
//     staged in shared memory first, so many o loads are in flight), and
//     writes its bf16 row; writes zeros for K9's rows past S and for split
//     rows without KV. It is launched as the attention grid's programmatic
//     dependent, so its launch and slot lookup overlap that grid.
//   - int8 latent pages (kv_cache_dtype="int8") are a template flag. Each
//     latent row is 576 bytes, a multiple of 16, so the same bulk copy
//     moves it, into the upper half of its slot row (bytes 576-1151 of the
//     1168). Once a step's two slots have landed, the block widens them in
//     place, as the stock kernel does: (int8 -> f32) * k_scale rounded to
//     bf16 into the row's chunks (every thread reads its 16-byte pieces of
//     int8 into registers, a barrier, then writes them widened, since a
//     row's bf16 chunks overlap its int8 bytes). V is the widened rows'
//     first 512 columns, as with bf16 pages. Two more barriers a step.
// No float atomics: the same inputs give the same bits on every call.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;               // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kHeads = 16;                  // query heads of a head group: one mma M tile
constexpr int kDc = 576;                    // latent dim: kv_lora_rank 512 + rope dims 64
constexpr int kVd = 512;                    // v_dim: kv_lora_rank
constexpr int kChunks = kDc / 8;            // 16-byte chunks of a latent row
constexpr int kRowElems = kDc + 8;          // a staged latent or q row: 1168 bytes, 16 past the row
constexpr int kSlotRows = 32;               // latent rows of a ring slot
constexpr int kSlotElems = kSlotRows * kRowElems;
constexpr int kStep = 2 * kSlotRows;        // latent rows of a step: two slots
constexpr int kPChunks = kStep / 8;         // 16-byte chunks of a P row
constexpr int kWarpCols = kVd / kWarps;     // output columns a warp owns
constexpr int kWarpN = kWarpCols / 8;       // its n8 tiles
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kTblMax = kStep + 8;         // block-table entries a step's rows can span (page_size >= 1)
constexpr int kMaxSplits = 6144;            // the merge stages (m, l) of a slot's splits: 48 KB
static_assert(kDc % 16 == 0 && kVd % (8 * kWarps) == 0, "widths in mma tiles");

constexpr int kTileTokens = 2;              // BQ: tokens of a tile block
constexpr int kSlots = 5;                   // ring slots

// The block shapes: MT m-tiles (tokens) a block, each warp one m-tile and NT
// n8 tiles of a step's scores; KS independent k chains a tile (a single
// chain of 36 dependent mma would set the step's latency).
template <int MT>
struct Cfg {
  static_assert(MT == 1 || MT == 2, "1 or 2 tokens a block");
  static constexpr int WN = kWarps / MT;      // warps along a step's columns
  static constexpr int NT = kStep / 8 / WN;   // n8 score tiles a warp
  static constexpr int KS = NT == 1 ? 2 : 1;
  static constexpr int kRing = kSlots * kSlotElems * 2;
  static constexpr int kQ = MT * kHeads * kRowElems * 2;
  static constexpr int kP = MT * kHeads * kStep * 2;
  static constexpr int kBars = kSlots * 8;            // one mbarrier a slot
  static constexpr int kRed = MT * kHeads * WN * 4;  // one float a (row, column warp)
  static constexpr int kTbl = 2 * kTblMax * 4;        // a step's table entries, double-buffered
  static constexpr int kBytes = kRing + kQ + kP + kBars + 2 * kRed + kTbl;
};
static_assert(Cfg<kTileTokens>::kBytes + 64 <= 232448, "227 KB of shared memory a block");

struct Params {
  const __nv_bfloat16* q;      // [T, H, kDc]
  const __nv_bfloat16* pages;  // [P, page_size, 1, kDc] (bf16 pages)
  const int8_t* pages8;        // [P, page_size, 1, kDc] (int8 pages; the kInt8 instances only)
  float k_scale;               // int8 pages: element = bf16(int8 * k_scale)
  const int* kv_lens;          // [S]
  const int* table;            // [S, maxp]
  const int* cu;               // [S + 1]; null for K9 (row s is slot s's query)
  const int* num_seqs;         // [1]; null for K9
  __nv_bfloat16* out;          // [T, H, kVd]
  float* o_part;               // [S, splits, H, kVd]
  float2* ml_part;             // [S, splits, H]: (m in base 2, l)
  int T, S, maxp, page_size, n_heads;
  int splits, split_len;       // split blocks: pieces of a slot's latent range
  int tile_blocks;
  float scale_log2;            // sm_scale * log2(e)
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled when !valid (nothing is read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
// 4 bytes global -> shared.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
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

// Element offset of 16-byte chunk `ch` of row `r` of a staged latent or q
// tile. A row takes 1168 bytes (292 words), so the 8 rows that one ldmatrix
// phase reads at one chunk start 4 banks apart: no bank conflicts.
__device__ __forceinline__ int lat(int r, int ch) { return r * kRowElems + (ch << 3); }

// mbarriers in shared memory: a phase completes when `count` arrivals and
// the expected bytes of the bulk copies tracked by it have come in.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}
// Waits for the completion of the phase of parity `parity`; a phase that
// does not complete within 2^26 tries (a lost copy) traps instead of hanging
// the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .u32 n;\nmov.u32 n, 0;\n"
      "WAIT:\nmbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n@p bra DONE;\n"
      "add.u32 n, n, 1;\nsetp.lt.u32 p, n, 67108864;\n@p bra WAIT;\ntrap;\nDONE:\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
// `bytes` contiguous bytes (a multiple of 16, both ends 16-byte aligned)
// into shared memory by the TMA unit, completion counted on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Element offset of 16-byte chunk `ch` of row `r` in rows of C chunks: the
// chunk index is XORed with the row's low 3 bits (C % 8 == 0, and a row is
// a whole number of 128-byte lines), so the 8 rows that one ldmatrix phase
// reads at one chunk lie in 8 different bank groups.
template <int C>
__device__ __forceinline__ int swz(int r, int ch) {
  return r * (C * 8) + ((ch ^ (r & 7)) << 3);
}

// Latent rows [base, base + kSlotRows) into a ring slot: lane l of warp 0
// copies row base + l with one bulk copy (the TMA unit, completion on
// `bar`); every thread zeroes its share of the rows at or past `end`, so a
// masked p = 0 never meets garbage. Row i lies at page table[i /
// page_size], slot i % page_size; with `tbl`, table[pg] is read from tbl[pg
// - tbl_pg0], the entries stage_table() staged in shared memory a step
// earlier. An int8 row lands in bytes [kDc, 2 kDc) of its slot row, for
// widen_step. Called by every thread.
template <bool kInt8>
__device__ __forceinline__ void issue_slot(__nv_bfloat16* dst, uint64_t* bar, const Params& p, const int* table,
                                           const int* tbl, int tbl_pg0, int base, int end) {
  constexpr int kRowBytes = kInt8 ? kDc : kDc * 2;
  const int n = max(0, min(kSlotRows, end - base));
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    if (lane == 0) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the slot's last reads and writes come first
      mbar_arrive_expect_tx(bar, n * kRowBytes);
    }
    __syncwarp();
    if (lane < n) {
      const int pos = base + lane, pg = pos / p.page_size;
      const int page = tbl ? tbl[pg - tbl_pg0] : table[pg];
      const size_t row = (size_t)page * p.page_size + (pos - pg * p.page_size);
      if constexpr (kInt8)
        bulk_load(reinterpret_cast<unsigned char*>(dst + lane * kRowElems) + kDc, p.pages8 + row * kDc, kDc, bar);
      else
        bulk_load(dst + lane * kRowElems, p.pages + row * kDc, kRowBytes, bar);
    }
  }
  for (int c = threadIdx.x; c < (kSlotRows - n) * kChunks; c += kThreads)
    *reinterpret_cast<uint4*>(dst + lat(n + c / kChunks, c % kChunks)) = make_uint4(0u, 0u, 0u, 0u);
}

// A step's two slots of int8 latent rows (issue_slot<true>), widened in
// place into the bf16 rows the products read: element e of a row becomes
// bf16(int8 * k_scale) at chunk e / 8. Every thread reads its 16-byte
// pieces of int8 (16 elements each; rows at or past the range hold zeros),
// then, after a barrier (a row's bf16 chunks overlap its int8 bytes), writes
// each as two bf16 chunks. The caller's next barrier publishes them.
__device__ __forceinline__ void widen_step(__nv_bfloat16* k0, __nv_bfloat16* k1, float k_scale) {
  constexpr int kPieces = kDc / 16;                  // 16-byte int8 pieces a row
  constexpr int kPer = 2 * kSlotRows * kPieces / kThreads;  // a thread's pieces of the step
  static_assert(2 * kSlotRows * kPieces % kThreads == 0, "whole pieces a thread");
  uint4 w[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int u = threadIdx.x + i * kThreads, r = u / kPieces % kSlotRows, c = u % kPieces;
    const __nv_bfloat16* slot = u < kSlotRows * kPieces ? k0 : k1;
    w[i] = *reinterpret_cast<const uint4*>(reinterpret_cast<const unsigned char*>(slot + r * kRowElems) + kDc +
                                           16 * c);
  }
  __syncthreads();  // every piece read before any chunk over it is written
  const auto el = [&](uint32_t word, int b) { return (float)(int8_t)(word >> (8 * b)) * k_scale; };
  const auto pair = [&](uint32_t word, int b) { return pack_bf16(el(word, b), el(word, b + 1)); };
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int u = threadIdx.x + i * kThreads, r = u / kPieces % kSlotRows, c = u % kPieces;
    __nv_bfloat16* row = (u < kSlotRows * kPieces ? k0 : k1) + r * kRowElems;
    *reinterpret_cast<uint4*>(row + lat(0, 2 * c)) =
        make_uint4(pair(w[i].x, 0), pair(w[i].x, 2), pair(w[i].y, 0), pair(w[i].y, 2));
    *reinterpret_cast<uint4*>(row + lat(0, 2 * c + 1)) =
        make_uint4(pair(w[i].z, 0), pair(w[i].z, 2), pair(w[i].w, 0), pair(w[i].w, 2));
  }
}

// The table entries of the pages that hold rows [row0, row0 + kStep)
// below `end` into tbl (at most kTblMax), in the current cp.async group: the
// loads of the step after next find them in shared memory, so no step's
// loads wait on a read of the block table.
__device__ __forceinline__ void stage_table(int* tbl, const Params& p, const int* table, int row0, int end) {
  if (row0 >= end) return;
  const int pg0 = row0 / p.page_size;
  const int n = (min(row0 + kStep, end) - 1) / p.page_size - pg0 + 1;
  if ((int)threadIdx.x < n) cp_async4(tbl + threadIdx.x, table + pg0 + threadIdx.x);
}

// The block's running state: this warp's 64 output columns of every m-tile
// (rows g and g + 8 of the mma C layout), and each row's max (base 2) and,
// after the walk, its sum.
template <int MT>
struct State {
  float o[MT][kWarpN][4];
  float m[MT][2];
  float l[MT][2];
};

// One 64-row step of a walk over two staged slots (k0: rows 0-31, k1: rows
// 32-63 of the step, whose first row is position `base`). hi_own: the end
// of the visible range of this warp's m-tile. l_own: this thread's share of
// its m-tile's row sums.
template <int MT>
__device__ __forceinline__ void attend_step(const __nv_bfloat16* k0, const __nv_bfloat16* k1,
                                            const __nv_bfloat16* qs, __nv_bfloat16* ps, float* red_m,
                                            State<MT>& st, float (&l_own)[2], int base, int hi_own,
                                            float scale_log2) {
  using C = Cfg<MT>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3,
            mat = lane >> 3;
  const int wm = warp / C::WN, wn = warp % C::WN;
  const int c0 = wn * C::NT * 8;  // this warp's first score column in the step
  const __nv_bfloat16* ks = c0 < kSlotRows ? k0 : k1;
  const int kr = c0 & (kSlotRows - 1);

  // S = Q K^T over all of Dc: K rows are the B operand's columns.
  float s[C::NT][C::KS][4];
#pragma unroll
  for (int n = 0; n < C::NT; ++n)
#pragma unroll
    for (int k = 0; k < C::KS; ++k) s[n][k][0] = s[n][k][1] = s[n][k][2] = s[n][k][3] = 0.f;
  if constexpr (C::NT == 1) {
    // Two k steps a load of K: chains over even and odd k steps.
#pragma unroll 3
    for (int kk = 0; kk < kDc / 16; kk += 2) {
      uint32_t a0[4], a1[4], b[4];
      ldmatrix_x4(a0, qs + lat(wm * kHeads + (lane & 15), 2 * kk + (lane >> 4)));
      ldmatrix_x4(a1, qs + lat(wm * kHeads + (lane & 15), 2 * kk + 2 + (lane >> 4)));
      ldmatrix_x4(b, ks + lat(kr + (lane & 7), 2 * kk + mat));
      mma_bf16(s[0][0], a0, b[0], b[1]);
      mma_bf16(s[0][1], a1, b[2], b[3]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) s[0][0][e] += s[0][1][e];
  } else {
#pragma unroll 2
    for (int kk = 0; kk < kDc / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, qs + lat(wm * kHeads + (lane & 15), 2 * kk + (lane >> 4)));
#pragma unroll
      for (int n = 0; n < C::NT; n += 2) {
        uint32_t b[4];
        ldmatrix_x4(b, ks + lat(kr + (n + (mat >> 1)) * 8 + (lane & 7), 2 * kk + (mat & 1)));
        mma_bf16(s[n][0], a, b[0], b[1]);
        mma_bf16(s[n + 1][0], a, b[2], b[3]);
      }
    }
  }

  // Scale (base 2), causal and length mask; the rows' maxima over this
  // warp's columns meet those of the m-tile's other warps.
  const int pos0 = base + c0;
  const bool whole = pos0 + C::NT * 8 <= hi_own;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < C::NT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[n][0][e] * scale_log2;
      if (!whole && pos0 + n * 8 + 2 * t + (e & 1) >= hi_own) x = -INFINITY;
      s[n][0][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
  if (t == 0) {
    red_m[(wm * kHeads + g) * C::WN + wn] = mx[0];
    red_m[(wm * kHeads + g + 8) * C::WN + wn] = mx[1];
  }
  __syncthreads();

  // Every warp forms every m-tile's new maxima (for its accumulator), the
  // same values in the same order.
  float alpha[MT][2], base_own[2] = {0.f, 0.f}, alpha_own[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < MT; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float m = st.m[j][r];
#pragma unroll
      for (int w = 0; w < C::WN; ++w) m = fmaxf(m, red_m[(j * kHeads + g + 8 * r) * C::WN + w]);
      const float b = m == -INFINITY ? 0.f : m;  // a row with nothing visible yet
      alpha[j][r] = exp2_approx(st.m[j][r] - b);  // 0 while the row was empty
      st.m[j][r] = m;
      if (j == wm) {
        base_own[r] = b;
        alpha_own[r] = alpha[j][r];
      }
    }
  }

  // p = 2^(s - m), rounded to bf16 into the shared P tile of this m-tile.
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < C::NT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float pe = exp2_approx(s[n][0][e] - base_own[e >> 1]);  // masked: 2^-inf = 0
      s[n][0][e] = pe;
      sum[e >> 1] += pe;
    }
    const int ch = c0 / 8 + n;
    *reinterpret_cast<uint32_t*>(ps + swz<kPChunks>(wm * kHeads + g, ch) + 2 * t) =
        pack_bf16(s[n][0][0], s[n][0][1]);
    *reinterpret_cast<uint32_t*>(ps + swz<kPChunks>(wm * kHeads + g + 8, ch) + 2 * t) =
        pack_bf16(s[n][0][2], s[n][0][3]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l_own[r] = l_own[r] * alpha_own[r] + sum[r];
  __syncthreads();

  // O = O * alpha + P V over this warp's 64 columns of every m-tile; V rows
  // through ldmatrix.trans, each fragment shared by the m-tiles.
#pragma unroll
  for (int j = 0; j < MT; ++j) {
#pragma unroll
    for (int n = 0; n < kWarpN; ++n) {
      st.o[j][n][0] *= alpha[j][0];
      st.o[j][n][1] *= alpha[j][0];
      st.o[j][n][2] *= alpha[j][1];
      st.o[j][n][3] *= alpha[j][1];
    }
  }
#pragma unroll
  for (int kk = 0; kk < kStep / 16; ++kk) {
    const __nv_bfloat16* vs = kk < 2 ? k0 : k1;
    uint32_t a[MT][4];
#pragma unroll
    for (int j = 0; j < MT; ++j)
      ldmatrix_x4(a[j], ps + swz<kPChunks>(j * kHeads + (lane & 15), 2 * kk + (lane >> 4)));
    const int vr = (kk & 1) * 16 + (mat & 1) * 8 + (lane & 7);
#pragma unroll
    for (int n = 0; n < kWarpN; n += 2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, vs + lat(vr, warp * kWarpN + n + (mat >> 1)));
#pragma unroll
      for (int j = 0; j < MT; ++j) {
        mma_bf16(st.o[j][n], a[j], b[0], b[1]);
        mma_bf16(st.o[j][n + 1], a[j], b[2], b[3]);
      }
    }
  }
}

// Walks latent rows [begin, end) of the context behind `table` for the
// query rows of MT tokens (rows row0 .. row0 + n_tok - 1 of q, heads
// [h0, h0 + 16)): token j sees the rows below min(first_hi + j, end).
// Leaves st with the unnormalised o, the maxima and the row sums. Uniform
// across the block; needs end > begin. kInt8: int8 pages, each step's
// slots widened (widen_step) before its products.
template <int MT, bool kInt8>
__device__ void walk(const Params& p, const int* table, int row0, int n_tok, int h0, int begin, int end,
                     int first_hi, unsigned char* smem, State<MT>& st) {
  using C = Cfg<MT>;
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + C::kRing);
  __nv_bfloat16* ps = reinterpret_cast<__nv_bfloat16*>(smem + C::kRing + C::kQ);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kRing + C::kQ + C::kP);  // [kSlots]
  float* red_m = reinterpret_cast<float*>(smem + C::kRing + C::kQ + C::kP + C::kBars);
  float* red_l = red_m + MT * kHeads * C::WN;
  int* tbl = reinterpret_cast<int*>(red_l + MT * kHeads * C::WN);  // [2][kTblMax]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wm = warp / C::WN, wn = warp % C::WN;
  const int rows = min(kHeads, p.n_heads - h0);

#pragma unroll
  for (int j = 0; j < MT; ++j) {
#pragma unroll
    for (int n = 0; n < kWarpN; ++n) st.o[j][n][0] = st.o[j][n][1] = st.o[j][n][2] = st.o[j][n][3] = 0.f;
    st.m[j][0] = st.m[j][1] = -INFINITY;
    st.l[j][0] = st.l[j][1] = 0.f;
  }
  float l_own[2] = {0.f, 0.f};

  if (threadIdx.x < kSlots) mbar_init(full + threadIdx.x, 1);
  __syncthreads();  // the mbarriers are initialised before any copy counts on them
  // The q rows (missing tokens and heads as zeros).
  for (int c = threadIdx.x; c < MT * kHeads * kChunks; c += kThreads) {
    const int r = c / kChunks, ch = c - r * kChunks;
    const int j = r / kHeads, hh = r % kHeads;
    const bool valid = j < n_tok && hh < rows;
    const __nv_bfloat16* src = valid ? p.q + ((size_t)(row0 + j) * p.n_heads + h0 + hh) * kDc + ch * 8 : p.q;
    cp_async16(qs + lat(r, ch), src, valid);
  }
  const int n_steps = (end - begin + kStep - 1) / kStep;
  const int n_slots = 2 * n_steps;
  // The loop's loads of step i read rows from win(i) on, their table
  // entries staged in tbl[i & 1] one step ahead (step 0's here).
  auto win = [&](int i) { return begin + (2 * i + kSlots - 2) * kSlotRows; };
  stage_table(tbl, p, table, win(0), end);
  cp_async_commit();
#pragma unroll
  for (int sl = 0; sl < kSlots - 2; ++sl)
    if (sl < n_slots)
      issue_slot<kInt8>(ring + sl * kSlotElems, full + sl, p, table, nullptr, 0, begin + sl * kSlotRows, end);
  const int hi_own = min(first_hi + wm, end);
  for (int i = 0; i < n_steps; ++i) {
    // Slot sl's use sl / kSlots completes the phase of that parity.
    mbar_wait(full + (2 * i) % kSlots, ((2 * i) / kSlots) & 1);
    mbar_wait(full + (2 * i + 1) % kSlots, ((2 * i + 1) / kSlots) & 1);
    cp_async_wait<0>();  // q, and step i's table entries
    __syncthreads();     // step i landed; every warp is done with step i - 1
    if constexpr (kInt8)
      widen_step(ring + ((2 * i) % kSlots) * kSlotElems, ring + ((2 * i + 1) % kSlots) * kSlotElems, p.k_scale);
    const int* tbl_i = tbl + (i & 1) * kTblMax;
    const int pg0 = win(i) / p.page_size;
#pragma unroll
    for (int k = 0; k < 2; ++k) {  // into step i - 1's slots
      const int sl = 2 * i + kSlots - 2 + k;
      if (sl < n_slots)
        issue_slot<kInt8>(ring + (sl % kSlots) * kSlotElems, full + sl % kSlots, p, table, tbl_i, pg0,
                          begin + sl * kSlotRows, end);
    }
    stage_table(tbl + ((i + 1) & 1) * kTblMax, p, table, win(i + 1), end);  // step i + 1's entries
    cp_async_commit();
    if constexpr (kInt8) __syncthreads();  // the widened rows are in place
    attend_step<MT>(ring + ((2 * i) % kSlots) * kSlotElems, ring + ((2 * i + 1) % kSlots) * kSlotElems, qs, ps,
                    red_m, st, l_own, begin + i * kStep, hi_own, p.scale_log2);
  }

  // Row sums: the quad's lanes, then the m-tile's column warps.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_own[r] += __shfl_xor_sync(0xffffffffu, l_own[r], 1);
    l_own[r] += __shfl_xor_sync(0xffffffffu, l_own[r], 2);
  }
  if (t == 0) {
    red_l[(wm * kHeads + g) * C::WN + wn] = l_own[0];
    red_l[(wm * kHeads + g + 8) * C::WN + wn] = l_own[1];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < MT; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = 0.f;
#pragma unroll
      for (int w = 0; w < C::WN; ++w) l += red_l[(j * kHeads + g + 8 * r) * C::WN + w];
      st.l[j][r] = l;
    }
  }
}

// Slot s is finished by split blocks and the merge when it is a real
// sequence of one token. Sets its q row and KV length.
// s < S. Every load is issued before any branch: one round trip.
__device__ __forceinline__ bool split_slot(const Params& p, int s, int& row, int& kv_len) {
  kv_len = p.kv_lens[s];
  if (p.cu == nullptr) {  // K9: row s is slot s's query
    row = s;
    return s < p.T;
  }
  const int n_seqs = p.num_seqs[0], c0 = p.cu[s], c1 = p.cu[s + 1];
  row = c0;
  return s < min(max(n_seqs, 0), p.S) && c1 - c0 == 1 && c0 < p.T;
}

template <bool kInt8>
__device__ void split_block(const Params& p, int x, int hg, unsigned char* smem) {
  const int s = x / p.splits, sp = x % p.splits;
  int row, kv_len;
  if (!split_slot(p, s, row, kv_len)) return;  // the merge never reads it
  const int h0 = hg * kHeads, rows = min(kHeads, p.n_heads - h0);
  const size_t part = ((size_t)s * p.splits + sp) * p.n_heads + h0;
  const int begin = sp * p.split_len;
  const int end = min(min(kv_len, p.maxp * p.page_size), begin + p.split_len);
  if (end <= begin) {  // the piece lies past kv_len: an empty partial
    if (threadIdx.x < rows) p.ml_part[part + threadIdx.x] = make_float2(-INFINITY, 0.f);
    return;
  }
  State<1> st;
  walk<1, kInt8>(p, p.table + (size_t)s * p.maxp, row, 1, h0, begin, end, end, smem, st);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int hh = g + 8 * r;
    if (hh >= rows) continue;
    float* dst = p.o_part + (part + hh) * kVd + warp * kWarpCols + 2 * t;
#pragma unroll
    for (int n = 0; n < kWarpN; ++n)
      *reinterpret_cast<float2*>(dst + n * 8) = make_float2(st.o[0][n][2 * r], st.o[0][n][2 * r + 1]);
    if (warp == 0 && t == 0) p.ml_part[part + hh] = make_float2(st.m[0][r], st.l[0][r]);
  }
}

// Tile block b, in reverse order: the last tiles of a chunk, which see the
// most rows, start first. Blocks past the last tile zero the padding rows
// (at or past cu_q_lens[num_seqs]), BQ rows each: there are enough of them,
// since the grid has ceil(T / BQ) + min(S, T) tile blocks.
template <bool kInt8>
__device__ void tile_block(const Params& p, int b, int hg, unsigned char* smem) {
  constexpr int BQ = kTileTokens;
  __shared__ int found[5];  // sequence (-1: none), tile within it or spare tile, q_start, q_len, kv_len
  b = p.tile_blocks - 1 - b;
  const int n_real = min(max(p.num_seqs[0], 0), p.S);
  if (threadIdx.x < 32) {
    // Warp 0 scans the per-sequence tile counts (sequences of 2 or more
    // tokens) for the sequence that holds tile b.
    const int lane = threadIdx.x;
    int before = 0, seq = -1, tile = 0, q0 = 0, ql = 0, kl = 0;  // before: tiles of the slots already scanned
    for (int s0 = 0; s0 < n_real; s0 += 32) {
      const int s = s0 + lane;
      const int c0 = s < n_real ? p.cu[s] : 0, c1 = s < n_real ? p.cu[s + 1] : 0;
      const int kv = s < n_real ? p.kv_lens[s] : 0;
      const int q_len = c1 - c0;
      const int own = q_len >= 2 ? (q_len + BQ - 1) / BQ : 0;
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
        q0 = __shfl_sync(0xffffffffu, c0, first);
        ql = __shfl_sync(0xffffffffu, q_len, first);
        kl = __shfl_sync(0xffffffffu, kv, first);
        break;
      }
      before += __shfl_sync(0xffffffffu, incl, 31);
    }
    if (lane == 0) {
      found[0] = seq;
      found[1] = seq < 0 ? b - before : tile;
      found[2] = q0;
      found[3] = ql;
      found[4] = kl;
    }
  }
  __syncthreads();
  const int s = found[0];
  const int h0 = hg * kHeads, rows = min(kHeads, p.n_heads - h0);
  if (s < 0) {  // a spare tile: zero BQ padding rows of this head group
    const int r0 = p.cu[n_real] + found[1] * BQ;
    const int n_rows = max(0, min(BQ, p.T - r0));
    for (int c = threadIdx.x; c < n_rows * rows * (kVd / 8); c += kThreads) {
      const int r = c / (rows * (kVd / 8)), rest = c % (rows * (kVd / 8));
      *reinterpret_cast<uint4*>(p.out + ((size_t)(r0 + r) * p.n_heads + h0 + rest / (kVd / 8)) * kVd +
                                (rest % (kVd / 8)) * 8) = make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }

  const int q_start = found[2], q_len = found[3], kv_len = found[4];
  const int tok0 = found[1] * BQ;
  const int n_tok = min(BQ, q_len - tok0);
  const int pos0 = kv_len - q_len + tok0;  // absolute position of the tile's first token
  const int end = min(pos0 + n_tok, min(kv_len, p.maxp * p.page_size));
  State<BQ> st;
  if (end > 0) {
    walk<BQ, kInt8>(p, p.table + (size_t)s * p.maxp, q_start + tok0, n_tok, h0, 0, end, pos0 + 1, smem, st);
  } else {  // nothing visible: zeros
#pragma unroll
    for (int j = 0; j < BQ; ++j) {
#pragma unroll
      for (int n = 0; n < kWarpN; ++n) st.o[j][n][0] = st.o[j][n][1] = st.o[j][n][2] = st.o[j][n][3] = 0.f;
      st.l[j][0] = st.l[j][1] = 0.f;
    }
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < BQ; ++j) {
    if (j >= n_tok) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int hh = g + 8 * r;
      if (hh >= rows) continue;
      const float inv = st.l[j][r] > 0.f ? 1.f / st.l[j][r] : 0.f;
      __nv_bfloat16* dst =
          p.out + ((size_t)(q_start + tok0 + j) * p.n_heads + h0 + hh) * kVd + warp * kWarpCols + 2 * t;
#pragma unroll
      for (int n = 0; n < kWarpN; ++n)
        *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) =
            __floats2bfloat162_rn(st.o[j][n][2 * r] * inv, st.o[j][n][2 * r + 1] * inv);
    }
  }
}

// Block (x, head group): x < tile_blocks is a tile block of BQ tokens, the
// rest are split blocks (slot, split) = ((x - tile_blocks) / splits, % splits).
template <bool kInt8>
__global__ void __launch_bounds__(kThreads, 1) mla_attention_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  griddep_launch();  // the merge may start; it waits for this grid before it reads
  const int x = blockIdx.x, hg = blockIdx.y;
  if (x < p.tile_blocks)
    tile_block<kInt8>(p, x, hg, smem);
  else
    split_block<kInt8>(p, x - p.tile_blocks, hg, smem);
}

// Block (x, head), 4 columns a thread. K9: q row x (x < T); a row past S
// writes zeros. K10: slot x (x < S), whose row it finishes if the slot is a
// split slot (tile rows are their tile blocks', padding rows the spare tile
// blocks'). A split row merges its slot's partials in split order, over the
// splits that hold some of its range (the others are empty); a split row
// without KV writes zeros. The partials' (m, l) are staged in shared memory
// first, so the o loads of many splits are in flight together.
__global__ void __launch_bounds__(kVd / 4) mla_merge_kernel(const Params p) {
  extern __shared__ float2 ml_s[];  // [splits]
  const int x = blockIdx.x, h = blockIdx.y;
  int row = x, kv_len = 0;
  const bool split = (p.cu == nullptr ? x < p.S : true) && split_slot(p, x, row, kv_len);
  // Every block waits, so that this grid ends after the attention grid and
  // the kernels behind it see its rows.
  griddep_wait();
  if (!split && p.cu != nullptr) return;
  const int d = threadIdx.x * 4;
  float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
  float l = 0.f;
  if (split) {
    const int hi = min(kv_len, p.maxp * p.page_size);
    const int n_sp = hi > 0 ? (hi - 1) / p.split_len + 1 : 0;
    const size_t part0 = (size_t)x * p.splits * p.n_heads + h;  // split sp: + sp * n_heads
    for (int sp = threadIdx.x; sp < n_sp; sp += blockDim.x) ml_s[sp] = p.ml_part[part0 + (size_t)sp * p.n_heads];
    __syncthreads();
    float m = -INFINITY;
    for (int sp = 0; sp < n_sp; ++sp) m = fmaxf(m, ml_s[sp].x);
    const float mb = m == -INFINITY ? 0.f : m;
#pragma unroll 16
    for (int sp = 0; sp < n_sp; ++sp) {
      const float2 ml = ml_s[sp];
      const float4 v = *reinterpret_cast<const float4*>(p.o_part + (part0 + (size_t)sp * p.n_heads) * kVd + d);
      const float w = exp2_approx(ml.x - mb);
      o.x += w * v.x;
      o.y += w * v.y;
      o.z += w * v.z;
      o.w += w * v.w;
      l += w * ml.y;
    }
  }
  const float inv = l > 0.f ? 1.f / l : 0.f;
  __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(p.out + ((size_t)row * p.n_heads + h) * kVd + d);
  dst[0] = __floats2bfloat162_rn(o.x * inv, o.y * inv);
  dst[1] = __floats2bfloat162_rn(o.z * inv, o.w * inv);
}

template <bool kInt8>
int launch(const Params& p, cudaStream_t st) {
  constexpr int kSmem = Cfg<kTileTokens>::kBytes;
  static_assert(Cfg<1>::kBytes <= kSmem, "the tile blocks' layout is the larger");
  static const int smem_rc = (int)cudaFuncSetAttribute(mla_attention_kernel<kInt8>,
                                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (smem_rc) return smem_rc;
  const dim3 grid(p.tile_blocks + p.S * p.splits, (p.n_heads + kHeads - 1) / kHeads);
  const int smem = p.tile_blocks ? kSmem : Cfg<1>::kBytes;
  mla_attention_kernel<kInt8><<<grid, kThreads, smem, st>>>(p);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  // The merge is the attention grid's programmatic dependent: it is launched
  // while that grid runs, finds its slot, then waits for it.
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.cu == nullptr ? p.T : p.S, p.n_heads);
  cfg.blockDim = dim3(kVd / 4);
  cfg.dynamicSmemBytes = p.splits * sizeof(float2);
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, mla_merge_kernel, p);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

int launch_any(const Params& p, cudaStream_t st) {
  return p.pages8 ? launch<true>(p, st) : launch<false>(p, st);
}

bool common_ok(int n_heads, int latent_dim, int v_dim, int num_seqs, int maxp, int page_size, int splits,
               int split_len) {
  return n_heads > 0 && n_heads <= 65535 && latent_dim == kDc && v_dim == kVd && num_seqs > 0 && maxp > 0 &&
         page_size > 0 && splits > 0 && splits <= kMaxSplits && split_len > 0 && split_len % kStep == 0;
}

Params make_params(const void* q, const void* k_pages, const void* kv_lens, const void* page_indices,
                   const void* cu_q_lens, const void* num_seqs, void* out, void* scratch, int T, int S,
                   int maxp, int page_size, int n_heads, int splits, int split_len, float sm_scale,
                   int latent_int8, float k_scale) {
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.pages = latent_int8 ? nullptr : static_cast<const __nv_bfloat16*>(k_pages);
  p.pages8 = latent_int8 ? static_cast<const int8_t*>(k_pages) : nullptr;
  p.k_scale = k_scale;
  p.kv_lens = static_cast<const int*>(kv_lens);
  p.table = static_cast<const int*>(page_indices);
  p.cu = static_cast<const int*>(cu_q_lens);
  p.num_seqs = static_cast<const int*>(num_seqs);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.o_part = static_cast<float*>(scratch);
  p.ml_part = reinterpret_cast<float2*>(p.o_part + (size_t)S * splits * n_heads * kVd);
  p.T = T;
  p.S = S;
  p.maxp = maxp;
  p.page_size = page_size;
  p.n_heads = n_heads;
  p.splits = splits;
  p.split_len = split_len;
  p.tile_blocks = 0;
  p.scale_log2 = sm_scale * kLog2e;
  return p;
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each launches the attention
// grid and its merge on `stream` and returns a CUDA error code (0 on
// success); neither synchronises. latent_dim and v_dim must be 576 and 512.
// `scratch` holds S * splits * n_heads * (v_dim + 2) floats (the wrapper
// allocates it); splits and split_len come from the wrapper's
// mla_split_plan, split_len a multiple of 64. latent_int8: the pages are
// int8, each element read as bf16(element * k_scale); else bf16 pages (the
// scale unused).
extern "C" int scalellm_mla_decode(const void* q, const void* k_pages, const void* kv_lens,
                                   const void* page_indices, void* out, void* scratch, int num_rows,
                                   int num_seqs, int maxp, int page_size, int n_heads, int latent_dim,
                                   int v_dim, int splits, int split_len, float sm_scale, int latent_int8,
                                   float k_scale, void* stream) {
  if (num_rows == 0) return 0;
  if (!common_ok(n_heads, latent_dim, v_dim, num_seqs, maxp, page_size, splits, split_len) ||
      num_rows < num_seqs)
    return (int)cudaErrorInvalidValue;
  const Params p = make_params(q, k_pages, kv_lens, page_indices, nullptr, nullptr, out, scratch, num_rows,
                               num_seqs, maxp, page_size, n_heads, splits, split_len, sm_scale, latent_int8,
                               k_scale);
  return launch_any(p, reinterpret_cast<cudaStream_t>(stream));
}

extern "C" int scalellm_mla_prefill(const void* q, const void* k_pages, const void* kv_lens,
                                    const void* page_indices, const void* cu_q_lens, const void* num_seqs,
                                    void* out, void* scratch, int num_tokens, int num_seq_slots, int maxp,
                                    int page_size, int n_heads, int latent_dim, int v_dim, int splits,
                                    int split_len, float sm_scale, int latent_int8, float k_scale,
                                    void* stream) {
  if (num_tokens == 0) return 0;
  if (!common_ok(n_heads, latent_dim, v_dim, num_seq_slots, maxp, page_size, splits, split_len))
    return (int)cudaErrorInvalidValue;
  Params p = make_params(q, k_pages, kv_lens, page_indices, cu_q_lens, num_seqs, out, scratch, num_tokens,
                         num_seq_slots, maxp, page_size, n_heads, splits, split_len, sm_scale, latent_int8, k_scale);
  // Sequences of 2 or more tokens hold at most T / kTileTokens + S tiles.
  p.tile_blocks = (num_tokens + kTileTokens - 1) / kTileTokens + min(num_seq_slots, num_tokens);
  return launch_any(p, reinterpret_cast<cudaStream_t>(stream));
}
