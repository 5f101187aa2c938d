// The small-M tensor-core mainloop of the weight-only quantized kernels for
// Hopper (sm_90a), and the asynchronous-copy helpers it shares with the
// K3/K4 tile kernel (quant_matmul.cu).
//
// Users: quant_gemv.cu (K12a gemv, scalellm_tpu/ops/quant_matmul.py:304
// _gemv_kernel), quant_mlp.cu (K11, scalellm_tpu/ops/quant_mlp.py:78
// _mlp_kernel, both of its matmuls) and moe_quant.cu (K7/K8, the routed
// experts: a job's weight rows start at its expert's first row of a stacked
// [E N, K] map, its x box at the expert's first token row, and int8's
// channel scale is applied after the whole-K sum, so the job has no scales);
// and, on the same ring with int8 activations and integer products (the
// W4A8 mainloop at the end of this file), quant_matmul.cu (K2 w4a8, :360
// _w4a8_kernel) and quant_gemv.cu (K12b w4a8g, :466 _w4a8_gemv_kernel).
// Layouts as in quant_matmul.cu: x bf16 [M, K]; qweight [N, K/2] int4 or
// [N, K] int8, K-contiguous; scales f32 or bf16 [K/G, N]; zeros s8 [K/G, N]
// or none.
//
// What it computes, for the R weight rows of a block and M <= 64 tokens:
// per span of K (128 where G % 128 == 0, else 32) an f32 dot of the bf16
// tokens with the integer weights, folded into the row's f32 sum as
// (dot - xsum * zero) * scale at the span's end; xsum is the f32 sum of x
// over the span, from a pre-pass (prep_kernel). The order of the fold
// follows the span order of the warp's K; a block whose warps split K adds
// their sums in slice order. Deterministic: no atomics.
//
// What bounds it on an H100: the weight bytes. At M = 16 a (4096, 28672)
// int4 projection reads 59 MB of weights and 3.7 MB of scales, 18.9 us at
// 3.35 TB/s, against 3.8 GFLOP of tensor work (4 us at 989 TFLOP/s); in
// practice the unpacking of the weights (the integer pipes) and the rate at
// which the ring streams them. The design keeps the bytes streaming and
// puts every multiply on the tensor cores:
//   - the transposed product out^T[rows, tokens] = W[rows, K] x^T with
//     mma.sync m16n8k16 (bf16, f32 accumulate): the weights are the A
//     operand, unpacked in registers, 16 rows a warp; the tokens are the B
//     operand, n = 8 a tile, up to NT = 8 tiles. Each weight is unpacked
//     once per call at every M <= 64. mma.sync rather than wgmma: at these M
//     the tensor time is not the limit, and a wgmma on a path ptxas takes
//     for divergent, or with its A registers rewritten while it runs, is
//     serialized (PERF.md, the tile kernel's findings);
//   - the A fragments by ldmatrix from a 128-byte-swizzled TMA tile of
//     packed weights: lane (g, t) receives word t of a row's 16 bytes, K
//     8t..8t+7 (int4) or 4t..4t+3 (int8), which the fragment takes as its
//     k slots 2t, 2t+1, 2t+8, 2t+9 of one or two k16 steps; x is read with
//     the same permutation of K (one 16- or 8-byte load of a token's row in
//     a dense [tokens][32 K] or [tokens][16 K] tile), so the product is
//     unchanged and no shared-memory read has a bank conflict. int4 unpacks
//     by quant_unpack.cuh's unpack_int4_step (13 instructions a k16 step:
//     unpack_int4_frag's bit placement with one logic op a register), int8
//     by its int8_step (the f32 2^23 bit placement: no int-to-float
//     converts, whose quarter rate held int8 back);
//   - a ring of up to 8 stages in shared memory, as deep as the shared
//     memory of the blocks an SM holds allows, filled by one producer warp
//     with TMA alone (the stage's x as one 3-D box of 32- or 16-K pieces,
//     the weights as 128-byte boxes, the staged sums of x as one box),
//     full/empty mbarriers, up to 8 consumer warps. The consumers read
//     their rows' scales and zero points straight from global memory, the
//     producer having prefetched the stage's into L2 (4-byte copies of the
//     scale windows by the producer held the ring back);
//   - a block owns R = 16 RW rows over all of K: its consumer warps are RW
//     row warps times KS K slices (a slice takes every KS-th 128-K chunk
//     of a stage), RW KS <= 8. The wrapper picks KS so that N / R fills
//     the SMs (small_m_slices); with one slice gemv picks RW (4-8) so that
//     the SMs share N evenly (sm_row_warps).
// Each warp's 16 rows are two halves of 8: rows row_a + 8 w + g and row_b +
// 8 w + g (g = lane / 4), which lets K11 put a gate row and its up row in
// the same thread.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "quant_act.cuh"
#include "quant_unpack.cuh"

namespace scalellm_quant {
namespace {

// ------------------------------------------------------------ async copies

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// mbarriers in shared memory: a phase completes when `count` arrivals and
// the expected bytes of the asynchronous copies tracked by it have come in.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}
// An arrival once this thread's earlier cp.async copies have landed.
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
// Waits for the completion of the phase of parity `parity`, spinning inside
// one asm block (no branch the compiler could take for divergent). A phase
// that does not complete within 2^26 tries (a lost arrival) traps instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .u32 n;\nmov.u32 n, 0;\n"
      "WAIT:\nmbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n@p bra DONE;\n"
      "add.u32 n, n, 1;\nsetp.lt.u32 p, n, 67108864;\n@p bra WAIT;\ntrap;\nDONE:\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
// TMA: the box at (c0, c1) (innermost first) of a 2-D tensor map into
// shared memory, completion counted in bytes on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_addr(bar))
      : "memory");
}

// The same for a 3-D tensor map.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1, int c2,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], "
      "[%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_addr(bar))
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

// The box at (c0, c1) of a 2-D tensor map into L2 (no shared memory).
__device__ __forceinline__ void tma_prefetch_2d(const CUtensorMap* map, int c0, int c1) {
  asm volatile("cp.async.bulk.prefetch.tensor.2d.L2.global [%0, {%1, %2}];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
               "r"(c0), "r"(c1)
               : "memory");
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// wgmma (the K3/K4 tile kernel, quant_matmul.cu; the grouped GEMM,
// grouped_matmul.cu): the fence before a warpgroup's products, their commit
// and the wait for all but N of the committed groups.
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pins the accumulators at this point of the program, so that the compiler
// moves no access to them across an asynchronous wgmma's issue or wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]));
}
// The same for A fragments in registers: keeps them live (unchanged) until
// the wgmma that reads them has completed.
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i]));
}

// Descriptor of a K-major bf16 operand in shared memory with the 128-byte
// swizzle: rows of 64 values (128 bytes), 8-row groups 1024 bytes apart
// (SBO), the tile 1024-byte aligned; the k16 step ks starts 32 * ks bytes in.
__device__ __forceinline__ uint64_t sw128_desc(const void* tile, int ks) {
  const uint32_t addr = smem_addr(tile) + 32 * ks;
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// cuTensorMapEncodeTiled, looked up through the runtime (no link to
// libcuda): builds the TMA descriptors of x and of the weights.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A row-major [rows, cols] tensor of `bytes`-wide elements, boxes of
// [box_rows, box_cols]; reads past its end come back as zeros.
bool tensor_map(CUtensorMap* map, const void* base, CUtensorMapDataType type, int bytes, int rows, int cols,
                int box_rows, int box_cols, CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr || reinterpret_cast<uintptr_t>(base) % 16 != 0) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(base), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A [rows, cols] tensor of bf16 as [cols / piece] pieces of [rows, piece]:
// one box of [box_rows, piece] x `box_pieces` lands as box_pieces dense
// [box_rows][piece] tiles, one TMA for many pieces. Reads past its end come
// back as zeros.
bool piece_map(CUtensorMap* map, const void* base, int rows, int cols, int piece, int box_rows, int box_pieces) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr || reinterpret_cast<uintptr_t>(base) % 16 != 0 || cols % piece != 0) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)piece, (cuuint64_t)rows, (cuuint64_t)(cols / piece)};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2, (cuuint64_t)piece * 2};
  const cuuint32_t box[3] = {(cuuint32_t)piece, (cuuint32_t)box_rows, (cuuint32_t)box_pieces};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ------------------------------------------------------------ pre-pass

constexpr int kPrepThreads = kActThreads;

// One block per row, where the call asks for it: the RMSNorm prologue (xn =
// bf16(x * rsqrt(mean(x^2) + eps) * gamma), computed once per row rather
// than in every block) and, for weights with zero points, the f32 sums of
// the (normed) x over each span of `span` K (32 or 128), xsum[span, row]: a
// warp a span, each lane adding its K lane, lane + 32, ... in order, then a
// shuffle tree. xsum's rows are ld floats long (ld >= M).
__global__ void __launch_bounds__(kPrepThreads) prep_kernel(
    const bf16* __restrict__ x, const void* __restrict__ gamma, int gamma_bf16, float eps,
    bf16* __restrict__ xn, float* __restrict__ xsum, int M, int K, int span, int ld) {
  __shared__ float red[kPrepThreads / 32];
  griddep_launch();  // a kernel launched behind it may start streaming its weights
  const int row = blockIdx.x;
  const bf16* xr = x + (size_t)row * K;
  float inv = 1.f;
  if (gamma != nullptr) {
    float ss = 0.f;
    for (int k = threadIdx.x; k < K; k += kPrepThreads) {
      const float v = __bfloat162float(xr[k]);
      ss += v * v;
    }
    inv = __frsqrt_rn(block_reduce(ss, false, red) / (float)K + eps);
    for (int k = threadIdx.x; k < K; k += kPrepThreads)
      xn[(size_t)row * K + k] =
          __float2bfloat16_rn(__bfloat162float(xr[k]) * inv * load_f32_or_bf16(gamma, k, gamma_bf16));
  }
  if (xsum != nullptr) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int sp = warp; sp < K / span; sp += kPrepThreads / 32) {
      float s = 0.f;
      for (int k = span * sp + lane; k < span * (sp + 1); k += 32) {
        float v = __bfloat162float(xr[k]);
        if (gamma != nullptr)
          v = __bfloat162float(__float2bfloat16_rn(v * inv * load_f32_or_bf16(gamma, k, gamma_bf16)));
        s += v;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) xsum[(size_t)sp * ld + row] = s;
    }
  }
}

// ------------------------------------------------------------ small-M mainloop

constexpr int kSmWarps = 8;                     // consumer warps a block, at most
constexpr int kSmThreads = 32 * kSmWarps + 32;  // and one producer warp
constexpr int kSmMaxStages = 8;
constexpr int kSmChunkK = 128;  // the unit of a warp's K: one span of 128 or four of 32

__host__ __device__ inline int sm_min(int a, int b) { return a < b ? a : b; }
__host__ __device__ inline int sm_round(int v, int to) { return (v + to - 1) / to * to; }

// One ring stage of a job: `cps` chunks of 128 K (a slice takes every KS-th
// one), byte offsets within the stage. x: stage_k / xk dense tiles of [M
// tokens][xk K] of xb-byte values, room left for 8 NT tokens: bf16 (xb 2)
// with xk the K of one 16-byte weight column (32 int4, 16 int8), or the
// W4A8 mainloop's int8 (xb 1) with xk 32, one m16n8k32 step, all 8 NT rows
// of a piece copied. Weights: two
// halves of rh = 8 * row warps rows, each in 128-byte boxes (128-byte
// swizzle). Then the sums of x over the stage's spans, [xs_rows][8 NT] of
// 4 bytes.
struct SmStage {
  int rh, cps, xk, xs_rows;
  int x_off, w_off, xs_off, bytes;
};

// The stage's x is [pieces][M][xk]: the box has exactly M token rows, and a
// token tile's rows past M read whatever follows (the next piece, the
// weights), which only reaches the output columns of tokens past M, never
// written. The layout below leaves room for the 8 NT rows.
__host__ __device__ inline SmStage sm_stage(int bits, int nt, int rw, int ks, int span, int parts, int wide = 1,
                                            int xb = 2) {
  SmStage s;
  s.rh = 8 * rw;
  const int base = (bits == 4 ? 2 : 1) * wide;  // chunks of `wide` 128-byte weight boxes
  s.cps = ks > base ? ks : base;
  s.xk = xb == 1 || bits == 4 ? 32 : 16;
  const int stage_k = kSmChunkK * s.cps;
  s.xs_rows = stage_k / span * parts;
  s.x_off = 0;
  s.w_off = sm_round(stage_k * 8 * nt * xb, 1024);
  s.xs_off = s.w_off + 2 * s.rh * stage_k * bits / 8;
  s.bytes = sm_round(s.xs_off + s.xs_rows * 8 * nt * 4, 1024);
  return s;
}

// One job: R = 2 rh rows of one weight matrix over all of its K. K need
// only be a multiple of 16 bytes of weights: a last chunk past K reads the
// zeros TMA fills in (x and weights alike) and folds no span past K.
struct SmJob {
  const CUtensorMap* xmap;   // B operand, bf16 [M, K] as pieces of xk K (piece_map), boxes of M rows, a stage
  const CUtensorMap* wmap;   // qweight, u8 [rows, K * bits / 8], boxes [rh, 128], 128-byte swizzle
  const CUtensorMap* xsmap;  // sums of x, f32 [(K / span) * parts, 8 NT], boxes [xs_rows, 8 NT]; null: symmetric
  const void* scales;        // [K / G, ld]; null: every scale 1
  const int8_t* zeros;       // [K / G, ld] or null
  int ld;                    // the scales' row length: the weight's N
  int row_a, row_b;          // first weight row of each half (of the scales; of wmap less w_row0)
  int valid_a, valid_b;      // rows of each half below N (0 .. rh)
  int K, G, span, parts;
  int rw, ks;                // row warps, K slices (rw * ks consumer warps, at most 8)
  SmStage st;
  int w_row0 = 0;            // wmap's row of the scales' row 0 (an expert's first row)
  int x_row = 0;             // the x box's first token row
  // The W4A8 mainloop's x and sums, already in the stage layout (act_quant_kernel):
  // xq [K / 32][8 NT][32] s8 and xs [K / 128 * 2][8 NT] of 4 bytes, one bulk copy each a stage.
  const uint8_t* xq = nullptr;
  const uint8_t* xs = nullptr;
};

// The producer warp: every stage of the job into the ring, all of it by
// TMA (one box of x, one or two weight boxes a half, one box of the sums of
// x), and the stage's scales and zero points prefetched into L2 for the
// consumers. g is the running stage count of the block (ring slot g %
// stages, its phase g / stages). S8 (the W4A8 mainloop; a block's first and
// only job, behind the pre-pass that writes x and its sums): x and the sums
// come by one bulk copy each from the pre-pass's stage layout, and the
// weights of the first `stages` stages go out before the wait for the
// pre-pass, their x after it.
template <int NT, int BITS, bool S8 = false>
__device__ __forceinline__ void sm_produce(const SmJob& j, uint8_t* ring, int slot_bytes, int stages, uint64_t* full,
                                           uint64_t* empty, int& g, int M, int scales_bf16, int lane) {
  const SmStage& s = j.st;
  const int stage_k = kSmChunkK * s.cps;
  const int n_st = (j.K + stage_k - 1) / stage_k;
  const int es = scales_bf16 ? 2 : 4;
  const int wbox = s.rh * 128;
  const int nwb_half = stage_k * BITS / 8 / 128;
  constexpr int kPad = 8 * NT;
  const int x_bytes = stage_k * M * 2, xs_bytes = s.xs_rows * kPad * 4;
  const int halves = (j.valid_a > 0) + (j.valid_b > 0);
  // The bytes of stage t: x, the weight boxes, the sums of x (S8: the
  // stage's own K, kn, of x and of the sums, 2 rows a 128-K span).
  auto expect = [&](int kn, int nwb, int slot) {
    const int bytes = S8 ? kn * kPad + halves * nwb * wbox + kn / 64 * kPad * 4
                         : x_bytes + halves * nwb * wbox + (j.xsmap != nullptr ? xs_bytes : 0);
    mbar_arrive_expect_tx(&full[slot], bytes);
  };
  // Stage t's weight boxes and scale prefetches; with `first`, after the
  // expected bytes of the whole stage.
  auto weights = [&](int t, int slot, bool first) {
    uint8_t* st = ring + (size_t)slot * slot_bytes;
    const int k0 = t * stage_k;
    const int kn = sm_min(stage_k, j.K - k0);  // short at the end of a K that is no multiple of the stage
    const int nwb = (kn * BITS / 8 + 127) / 128;
    if (first && lane == 0) expect(kn, nwb, slot);
    __syncwarp();
    if (lane < 2 * nwb) {
      const int h = lane >= nwb, b = lane - h * nwb;
      if ((h ? j.valid_b : j.valid_a) > 0)
        tma_load_2d(st + s.w_off + (h * nwb_half + b) * wbox, j.wmap, k0 * BITS / 8 + 128 * b,
                    j.w_row0 + (h ? j.row_b : j.row_a), &full[slot]);
    }
    // The stage's scale and zero-point rows into L2 (a 128-byte line a lane),
    // where the consumers read them.
    const int g0 = k0 / j.G, nw = j.scales != nullptr ? (k0 + kn - 1) / j.G - g0 + 1 : 0;
    for (int i = lane; i < 2 * nw; i += 32) {
      const int h = i & 1;
      const int valid = h ? j.valid_b : j.valid_a;
      if (valid <= 0) continue;
      const size_t e = (size_t)(g0 + (i >> 1)) * j.ld + (h ? j.row_b : j.row_a);
      const char* p = static_cast<const char*>(j.scales) + e * es;
      for (int off = 0; off < valid * es; off += 128) prefetch_l2(p + off);
      prefetch_l2(p + valid * es - 1);
      if (j.zeros != nullptr) {
        prefetch_l2(j.zeros + e);
        prefetch_l2(j.zeros + e + valid - 1);
      }
    }
  };
  const int ahead = S8 ? sm_min(stages, n_st) : 0;
  if (S8) {
    for (int t = 0; t < ahead; ++t) weights(t, (g + t) % stages, true);
    griddep_wait();
  }
  for (int t = 0; t < n_st; ++t, ++g) {
    const int slot = g % stages;
    if (g >= stages) mbar_wait(&empty[slot], (g / stages - 1) & 1);
    uint8_t* st = ring + (size_t)slot * slot_bytes;
    const int k0 = t * stage_k;
    const int kn = sm_min(stage_k, j.K - k0);
    const int nwb = (kn * BITS / 8 + 127) / 128;
    if (lane == 0) {
      if (t >= ahead) expect(kn, nwb, slot);
      if (S8) {
        bulk_load(st + s.x_off, j.xq + (size_t)k0 * kPad, kn * kPad, &full[slot]);
        bulk_load(st + s.xs_off, j.xs + (size_t)k0 / 64 * kPad * 4, kn / 64 * kPad * 4, &full[slot]);
      } else {
        tma_load_3d(st + s.x_off, j.xmap, 0, j.x_row, k0 / s.xk, &full[slot]);
        if (j.xsmap != nullptr) tma_load_2d(st + s.xs_off, j.xsmap, 0, k0 / j.span * j.parts, &full[slot]);
      }
    }
    if (t >= ahead) weights(t, slot, false);
  }
}

// The first `stages` stages' weight boxes of a job into L2: issued ahead of
// a wait for the activations (they do not depend on them).
template <int BITS>
__device__ __forceinline__ void sm_prefetch_weights(const SmJob& j, int stages, int lane) {
  const int stage_k = kSmChunkK * j.st.cps;
  const int n_st = sm_min(stages, (j.K + stage_k - 1) / stage_k);
  const int nwb = stage_k * BITS / 8 / 128;
  for (int i = lane; i < 2 * nwb * n_st; i += 32) {
    const int t = i / (2 * nwb), h = (i / nwb) & 1, b = i % nwb;
    if ((h ? j.valid_b : j.valid_a) > 0)
      tma_prefetch_2d(j.wmap, t * stage_k * BITS / 8 + 128 * b, j.w_row0 + (h ? j.row_b : j.row_a));
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n" : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(addr));
  return v;
}
__device__ __forceinline__ uint2 lds64(uint32_t addr) {
  uint2 v;
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n" : "=r"(v.x), "=r"(v.y) : "r"(addr));
  return v;
}
__device__ __forceinline__ float2 lds64f(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(addr));
  return v;
}

// A consumer warp: its rows (row warp `warp % rw`) over its slice of K
// (`warp / rw`) of every stage of the job, the span sums folded into acc:
// acc[n][0..1] are row 8 w + g of half a for tokens 8 n + 2 t, + 1;
// acc[n][2..3] the same tokens of row 8 w + g of half b (g = lane / 4, t =
// lane % 4). The scales
// and zero points of the thread's two rows are read from global memory (the
// producer brought them into L2), the group followed by comparison as K
// grows (no division in the loop).
template <int NT, int BITS, bool SPAN32>
__device__ __forceinline__ void sm_consume(const SmJob& j, const uint8_t* ring, int slot_bytes, int stages,
                                           uint64_t* full, uint64_t* empty, int& g, int M, int warp, int lane,
                                           int scales_bf16, float (&acc)[NT][4]) {
  constexpr int kSpan = SPAN32 ? 32 : 128;
  constexpr int kSteps = kSpan / 16;  // k16 steps of a span
  constexpr int kSpans = kSmChunkK / kSpan;
  const SmStage& s = j.st;
  const int rw = warp % j.rw, slice = warp / j.rw;
  const int gid = lane >> 2, tig = lane & 3;
  const int r = 8 * rw + gid;  // the thread's row in each half
  const bool ok_a = r < j.valid_a, ok_b = r < j.valid_b;
  const int stage_k = kSmChunkK * s.cps;
  const int n_st = (j.K + stage_k - 1) / stage_k;
  const uint32_t xbox = M * s.xk * 2;  // a piece of x: M token rows
  const int nwb_half = stage_k * BITS / 8 / 128;
  const bool asym = j.zeros != nullptr;
  const bool unit = j.scales == nullptr;
  const int es = scales_bf16 ? 2 : 4;
  const __nv_bfloat162 off = __float2bfloat162_rn(136.f);
  const uint32_t mask = 0x000F000Fu, magic = 0x43084308u;  // unpack_int4_step's constants
  // ldmatrix: lane l gives row l % 8 of matrix l / 8 = (half, column) (a, q),
  // (b, q), (a, q + 1), (b, q + 1); its 16-byte column is swizzled by row.
  const int lm_half = (lane >> 3) & 1, lm_col = lane >> 4, lm_row = lane & 7;
  // The group of the next span and the K where the group after it starts;
  // the rows' scale and zero-point element offsets in that group.
  int grp_end = j.G;
  size_t e_a = (size_t)j.row_a + r, e_b = (size_t)j.row_b + r;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;

  for (int t = 0; t < n_st; ++t, ++g) {
    const int slot = g % stages;
    const int k0 = t * stage_k;
    const int n_ck = (sm_min(stage_k, j.K - k0) + kSmChunkK - 1) / kSmChunkK;
    mbar_wait(&full[slot], (g / stages) & 1);
    const uint32_t st = smem_addr(ring) + (uint32_t)(slot * slot_bytes);
    for (int c = slice; c < n_ck; c += j.ks) {
      const int kc = k0 + kSmChunkK * c;
      float sa[kSpans], sb[kSpans], za[kSpans], zb[kSpans];
#pragma unroll
      for (int h = 0; h < kSpans; ++h) {
        while (kc + kSpan * h >= grp_end) {
          grp_end += j.G;
          e_a += j.ld;
          e_b += j.ld;
        }
        sa[h] = sb[h] = unit ? 1.f : 0.f;
        za[h] = zb[h] = 0.f;
        const bool live = !unit && kc + kSpan * h < j.K;  // a span past K folds a zero dot, times 0
        if (live && es == 2) {
          if (ok_a) sa[h] = __bfloat162float(static_cast<const bf16*>(j.scales)[e_a]);
          if (ok_b) sb[h] = __bfloat162float(static_cast<const bf16*>(j.scales)[e_b]);
        } else if (live) {
          if (ok_a) sa[h] = static_cast<const float*>(j.scales)[e_a];
          if (ok_b) sb[h] = static_cast<const float*>(j.scales)[e_b];
        }
        if (asym && live) {
          if (ok_a) za[h] = (float)j.zeros[e_a];
          if (ok_b) zb[h] = (float)j.zeros[e_b];
        }
      }
      // The chunk's weight columns: int4 box c / 2, columns 4 (c % 2) ..
      // +3 (32 K each); int8 box c, columns 0..7 (16 K each).
      const int box = BITS == 4 ? c >> 1 : c;
      const int col0 = BITS == 4 ? 4 * (c & 1) : 0;
      const uint32_t wrow = st + s.w_off + (lm_half * nwb_half + box) * s.rh * 128 + (8 * rw + lm_row) * 128;
      const uint32_t xc = st + s.x_off + (uint32_t)(c * (kSmChunkK / s.xk)) * xbox;
      const uint32_t xs_chunk = st + s.xs_off + (kSmChunkK * c / kSpan) * j.parts * 8 * NT * 4;
      float cs[NT][4];  // the dot of the span in progress
      uint32_t wr[4], wr4[4];
      uint4 xq[NT];  // int4: a token tile's x for the current column (two k16 steps)
#pragma unroll
      for (int k = 0; k < 8; ++k) {  // the chunk's k16 steps
        if (k % kSteps == 0) {
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int i = 0; i < 4; ++i) cs[n][i] = 0.f;
        }
        uint32_t a[4];
        uint32_t b[NT][2];
        if constexpr (BITS == 4) {
          // One ldmatrix covers two columns (64 K, four k16 steps) of both
          // halves: word t of a row's column is its K 8t..8t+7, the k slots
          // 2t, 2t+1, 2t+8, 2t+9 of two steps. One 16-byte x load a token
          // tile covers a column: [x(8t..8t+1), x(8t+2..+3), x(8t+4..+5),
          // x(8t+6..+7)], the same K in the same slots.
          if (k % 4 == 0) {
            ldmatrix_x4(wrow + (((col0 + k / 2 + lm_col) ^ lm_row) << 4), wr);
#pragma unroll
            for (int i = 0; i < 4; ++i) wr4[i] = wr[i] >> 4;
          }
          const int p = (k / 2) & 1, e = k & 1;  // column within the pair, step within the column
          unpack_int4_step(wr[2 * p], wr4[2 * p], wr[2 * p + 1], wr4[2 * p + 1], e, mask, magic, off, a);
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            if (e == 0) xq[n] = lds128(xc + (k / 2) * xbox + (8 * n + gid) * 64 + tig * 16);
            b[n][0] = e ? xq[n].z : xq[n].x;
            b[n][1] = e ? xq[n].w : xq[n].y;
          }
        } else {
          // Two columns (two k16 steps) an ldmatrix; a k16 step's x is a
          // token's 4t..4t+3.
          if (k % 2 == 0) ldmatrix_x4(wrow + (((k + lm_col) ^ lm_row) << 4), wr);
          const int p = k & 1;
          int8_step(wr[2 * p], wr[2 * p + 1], a);
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const uint2 xv = lds64(xc + k * xbox + (8 * n + gid) * 32 + tig * 8);
            b[n][0] = xv.x;
            b[n][1] = xv.y;
          }
        }
#pragma unroll
        for (int n = 0; n < NT; ++n) mma_bf16(cs[n], a[0], a[1], a[2], a[3], b[n][0], b[n][1]);
        if (k % kSteps == kSteps - 1) {
          // The span ends: acc += (dot - xsum * z) * s.
          const int h = k / kSteps;
          const float(&dot)[NT][4] = cs;
          if (asym) {
            const uint32_t xs = xs_chunk + h * j.parts * 8 * NT * 4;
#pragma unroll
            for (int n = 0; n < NT; ++n) {
              float2 x2 = lds64f(xs + (8 * n + 2 * tig) * 4);
              for (int q = 1; q < j.parts; ++q) {
                const float2 y = lds64f(xs + (q * 8 * NT + 8 * n + 2 * tig) * 4);
                x2.x += y.x;
                x2.y += y.y;
              }
              acc[n][0] += (dot[n][0] - x2.x * za[h]) * sa[h];
              acc[n][1] += (dot[n][1] - x2.y * za[h]) * sa[h];
              acc[n][2] += (dot[n][2] - x2.x * zb[h]) * sb[h];
              acc[n][3] += (dot[n][3] - x2.y * zb[h]) * sb[h];
            }
          } else {
#pragma unroll
            for (int n = 0; n < NT; ++n) {
              acc[n][0] += dot[n][0] * sa[h];
              acc[n][1] += dot[n][1] * sa[h];
              acc[n][2] += dot[n][2] * sb[h];
              acc[n][3] += dot[n][3] * sb[h];
            }
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);  // this warp is done with the stage
  }
}

// The consumer warps' barrier (the producer warp does not take part).
__device__ __forceinline__ void sm_consumer_sync(int consumers) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(32 * consumers) : "memory");
}

// With K slices: the slices' sums added in slice order into slice 0's warps,
// through `red` ((ks - 1) * rw * NT * 4 * 32 floats).
template <int NT>
__device__ __forceinline__ void sm_reduce_slices(float (&acc)[NT][4], float* red, int rw_count, int ks_count, int warp, int lane) {
  if (ks_count == 1) return;
  const int rw = warp % rw_count, slice = warp / rw_count;
  auto part = [&](int sl) { return red + (size_t)((sl - 1) * rw_count + rw) * NT * 4 * 32; };
  if (slice > 0) {
    float* p = part(slice);
#pragma unroll
    for (int i = 0; i < NT * 4; ++i) p[i * 32 + lane] = acc[i / 4][i % 4];
  }
  sm_consumer_sync(rw_count * ks_count);
  if (slice == 0) {
    for (int sl = 1; sl < ks_count; ++sl) {
      const float* p = part(sl);
#pragma unroll
      for (int i = 0; i < NT * 4; ++i) acc[i / 4][i % 4] += p[i * 32 + lane];
    }
  }
  sm_consumer_sync(rw_count * ks_count);  // red may be written again by the next job
}

// The ring's shared memory: `stages` slots of slot_bytes (1024-aligned),
// then 2 * max_stages mbarriers, then `red_bytes` of epilogue scratch.
inline int sm_smem_bytes(int stages, int slot_bytes, int red_bytes, int max_stages = kSmMaxStages) {
  return 1024 + stages * slot_bytes + 2 * max_stages * 8 + red_bytes;
}

// The card's SMs (queried once).
inline int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
                                                  cudaSuccess)
      sms = 0;
  }
  return sms;
}

// Stages that fit the shared memory a block may have where `per_sm` blocks
// share an SM (at least 2, at most max_stages).
inline int sm_stages(int slot_bytes, int red_bytes, int per_sm, int max_stages = kSmMaxStages) {
  const int budget = 228 * 1024 / per_sm - 1024 - 1024 - 2 * max_stages * 8 - red_bytes;
  const int n = budget / slot_bytes;
  return n < 2 ? 2 : (n > max_stages ? max_stages : n);
}

// Ring, barriers and scratch in the dynamic shared memory; barriers
// initialised (full: the producer's expect_tx arrival, then the TMA bytes;
// empty: one arrival per consumer warp, `consumers` of them).
struct SmRing {
  uint8_t* ring;
  uint64_t* full;
  uint64_t* empty;
  float* red;
};

__device__ __forceinline__ SmRing sm_ring(uint8_t* smem_raw, int stages, int slot_bytes, int consumers,
                                          int max_stages = kSmMaxStages) {
  SmRing r;
  r.ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);  // 1024-aligned, still a shared pointer
  r.full = reinterpret_cast<uint64_t*>(r.ring + (size_t)stages * slot_bytes);
  r.empty = r.full + max_stages;
  r.red = reinterpret_cast<float*>(r.empty + max_stages);
  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(&r.full[i], 1);
      mbar_init(&r.empty[i], consumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return r;
}

// The tokens a launch pads M to: 8 NT, NT in {1, 2, 4, 8}.
inline int sm_tiles(int M) { return M <= 8 ? 1 : (M <= 16 ? 2 : (M <= 32 ? 4 : 8)); }

// Row warps of a one-slice block (4 to 8, 64 to 128 rows): where 128 rows
// give at most two blocks an SM (all resident at once), the count whose
// blocks, spread evenly over the SMs, give the busiest SM the fewest rows
// (the larger on a tie: x is read once a block); at the 8B gate_up (N =
// 28672, 132 SMs) 7: 256 blocks of 112 rows, two on all but 8 SMs, where 128
// rows give 224 blocks and leave 40 SMs one. Larger grids run in waves that
// even themselves out: 8.
inline int sm_row_warps(int N) {
  const int sms = sm_count();
  int best = kSmWarps, best_rows = 1 << 30;
  if ((N + 16 * kSmWarps - 1) / (16 * kSmWarps) > 2 * sms) return kSmWarps;
  for (int rw = kSmWarps; rw >= 4 && sms > 0; --rw) {
    const int rows = 16 * rw, blocks = (N + rows - 1) / rows;
    const int busiest = (blocks + sms - 1) / sms * rows;
    if (busiest < best_rows) best = rw, best_rows = busiest;
  }
  return best;
}

// ------------------------------------------------------------ W4A8 mainloop
//
// K2 (quant_matmul.cu, w4a8_kernel) and K12b (quant_gemv.cu, w4a8g_kernel):
// the same ring, with x quantized to int8 by act_quant_kernel (quant_act.cuh)
// and the products on the integer tensor cores, mma.sync m16n8k32 s8 with
// s32 sums. The weights are the A operand: ldmatrix hands lane (g, t) word t
// of a row's 16-byte column, and
//   - int4: the word's 8 nibbles, K 8t..8t+7, give the two A words of the
//     row in one k32 step, (w << 4) & 0xF0F0F0F0 the even K and w &
//     0xF0F0F0F0 the odd K, each as 16 times its signed value (no sign
//     extension; the dot is shifted back by 4, exactly): k slots 4t..4t+3
//     and 16 + 4t..16 + 4t + 3. One 16-byte column is one k32 step.
//   - int8: no unpack: two 16-byte columns are one k32 step, word t of each
//     its k slots 4t..4t+3 and 16 + 4t..16 + 4t + 3.
// xq is stored in the matching K order (act_quant_kernel), so that a token's
// B words for a k32 step are one 8-byte shared load from a dense [8 NT
// tokens][32 K] piece (a stage's pieces and its sums are one bulk copy each
// from the pre-pass's stage layout): the product is unchanged and no shared
// read has a bank conflict.
// Bounds of the s32 sums: a product is at most 16 * 8 * 127 (int4 times
// 16) or 128 * 127 (int8), 16256 either way, and a sum runs over at most
// one span of 128 K (K <= 32768 would still stay below 2^31).
// Each warp folds the dot of every 128-K span (inside one group: G % 128 ==
// 0) into f32 at the span's end, with xsum, the span's int32 sum of xq, and
// sx, its activation scale, both from the stage's box of sums ([2 spans][8
// NT], row 2 sp the sums, 2 sp + 1 the scales):
//   K2 (KBLOCK): tot += (dot - xsum * z) * s over the warp's spans of a
//     k-block, acc += tot * sx at the k-block's end (the TPU kernel's
//     per-group sums times the k-block's scale);
//   K12b: acc += (dot - xsum * z) * s * sx, span by span.
// A block whose warps split K adds their sums in slice order. Deterministic.
template <int NT, int BITS, bool KBLOCK>
__device__ __forceinline__ void sm_consume_s8(const SmJob& j, const uint8_t* ring, int slot_bytes, int stages,
                                              uint64_t* full, uint64_t* empty, int& g, int warp, int lane,
                                              int scales_bf16, int block_k, float (&acc)[NT][4]) {
  const SmStage& s = j.st;
  const int rw = warp % j.rw, slice = warp / j.rw;
  const int gid = lane >> 2, tig = lane & 3;
  const int r = 8 * rw + gid;  // the thread's row in each half
  const bool ok_a = r < j.valid_a, ok_b = r < j.valid_b;
  const int stage_k = kSmChunkK * s.cps;
  const int n_st = (j.K + stage_k - 1) / stage_k;
  constexpr uint32_t xbox = 8 * NT * 32;  // a 32-K piece of xq: the 8 NT token rows
  const int nwb_half = stage_k * BITS / 8 / 128;
  const bool asym = j.zeros != nullptr;
  const uint32_t mask = 0xF0F0F0F0u;
  // ldmatrix: lane l gives row l % 8 of matrix l / 8 = (half, column) (a, q),
  // (b, q), (a, q + 1), (b, q + 1); its 16-byte column is swizzled by row.
  const int lm_half = (lane >> 3) & 1, lm_col = lane >> 4, lm_row = lane & 7;
  // The group of the next span and the K where the group after it starts;
  // the rows' scale and zero-point element offsets in that group; the K
  // where this warp's k-block ends (K2).
  int grp_end = j.G, kb_end = block_k;
  size_t e_a = (size_t)j.row_a + r, e_b = (size_t)j.row_b + r;
  float tot[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = tot[n][i] = 0.f;

  for (int t = 0; t < n_st; ++t, ++g) {
    const int slot = g % stages;
    const int k0 = t * stage_k;
    const int n_ck = sm_min(stage_k, j.K - k0) / kSmChunkK;
    mbar_wait(&full[slot], (g / stages) & 1);
    const uint32_t st = smem_addr(ring) + (uint32_t)(slot * slot_bytes);
    for (int c = slice; c < n_ck; c += j.ks) {
      const int kc = k0 + kSmChunkK * c;
      while (kc >= grp_end) {
        grp_end += j.G;
        e_a += j.ld;
        e_b += j.ld;
      }
      float sa = 0.f, sb = 0.f;
      int za = 0, zb = 0;
      if (scales_bf16) {
        if (ok_a) sa = __bfloat162float(static_cast<const bf16*>(j.scales)[e_a]);
        if (ok_b) sb = __bfloat162float(static_cast<const bf16*>(j.scales)[e_b]);
      } else {
        if (ok_a) sa = static_cast<const float*>(j.scales)[e_a];
        if (ok_b) sb = static_cast<const float*>(j.scales)[e_b];
      }
      if (asym) {
        if (ok_a) za = j.zeros[e_a];
        if (ok_b) zb = j.zeros[e_b];
      }
      // The chunk's weight columns: int4 box c / 2, columns 4 (c % 2) ..
      // +3 (32 K each); int8 box c, columns 0..7 (16 K each).
      const int box = BITS == 4 ? c >> 1 : c;
      const int col0 = BITS == 4 ? 4 * (c & 1) : 0;
      const uint32_t wrow = st + s.w_off + (lm_half * nwb_half + box) * s.rh * 128 + (8 * rw + lm_row) * 128;
      const uint32_t xc = st + s.x_off + (uint32_t)(4 * c) * xbox + gid * 32 + tig * 8;
      int d[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) d[n][i] = 0;
      uint32_t wr[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {  // the chunk's k32 steps
        uint32_t a[4];
        if constexpr (BITS == 4) {
          // One ldmatrix covers two columns (two k32 steps) of both halves.
          if (k % 2 == 0) ldmatrix_x4(wrow + (((col0 + k + lm_col) ^ lm_row) << 4), wr);
          const int p = k & 1;
          a[0] = (wr[2 * p] << 4) & mask;
          a[1] = (wr[2 * p + 1] << 4) & mask;
          a[2] = wr[2 * p] & mask;
          a[3] = wr[2 * p + 1] & mask;
        } else {
          ldmatrix_x4(wrow + (((2 * k + lm_col) ^ lm_row) << 4), wr);
          a[0] = wr[0];
          a[1] = wr[1];
          a[2] = wr[2];
          a[3] = wr[3];
        }
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const uint2 xv = lds64(xc + k * xbox + n * 256);
          mma_s8(d[n], a[0], a[1], a[2], a[3], xv.x, xv.y);
        }
      }
      // The span ends: (dot - xsum * z) * s, into tot (K2) or, times sx,
      // into acc (K12b). xs: the span's sums of xq, then its scales.
      const uint32_t xs = st + s.xs_off + (uint32_t)(2 * c * 8 * NT + 2 * tig) * 4;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        int dot[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) dot[i] = BITS == 4 ? d[n][i] >> 4 : d[n][i];
        if (asym) {
          const uint2 xsum = lds64(xs + n * 32);
          dot[0] -= (int)xsum.x * za;
          dot[1] -= (int)xsum.y * za;
          dot[2] -= (int)xsum.x * zb;
          dot[3] -= (int)xsum.y * zb;
        }
        if constexpr (KBLOCK) {
          tot[n][0] += (float)dot[0] * sa;
          tot[n][1] += (float)dot[1] * sa;
          tot[n][2] += (float)dot[2] * sb;
          tot[n][3] += (float)dot[3] * sb;
        } else {
          const float2 sx = lds64f(xs + 8 * NT * 4 + n * 32);
          acc[n][0] += (float)dot[0] * sa * sx.x;
          acc[n][1] += (float)dot[1] * sa * sx.y;
          acc[n][2] += (float)dot[2] * sb * sx.x;
          acc[n][3] += (float)dot[3] * sb * sx.y;
        }
      }
      if constexpr (KBLOCK) {
        // This warp's next span (ks chunks on: a stage's chunks and cps are
        // multiples of ks) lies in a later k-block, or past K: acc += tot *
        // sx of this k-block.
        const int next = kc + kSmChunkK * j.ks;
        if (next >= kb_end) {
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const float2 sx = lds64f(xs + 8 * NT * 4 + n * 32);
            acc[n][0] += tot[n][0] * sx.x;
            acc[n][1] += tot[n][1] * sx.y;
            acc[n][2] += tot[n][2] * sx.x;
            acc[n][3] += tot[n][3] * sx.y;
#pragma unroll
            for (int i = 0; i < 4; ++i) tot[n][i] = 0.f;
          }
          while (next >= kb_end) kb_end += block_k;
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);  // this warp is done with the stage
  }
}

// Ring stages of the W4A8 mainloop, at most: a block that has its SM to
// itself keeps more weight bytes in flight (and in flight while the
// pre-pass runs).
constexpr int kSmMaxStagesS8 = 16;

// One block of a W4A8 kernel: the 2 rh weight rows from blockIdx.x * 2 rh
// (rh = 8 rw) for every token over all of K (rw row warps times ks K
// slices, then the producer warp, whose first stages' weights are in flight
// while the pre-pass runs), its K slices' sums added in slice order, then
// bf16 out. xq and xs: the pre-pass's output in the stage layout
// (act_quant_kernel).
template <int BITS, int NT, bool KBLOCK>
__device__ __forceinline__ void sm_w4a8_block(uint8_t* smem_raw, const CUtensorMap* w_map, const int8_t* xq,
                                              const float* xs, const void* scales, int scales_bf16,
                                              const int8_t* zeros, bf16* out, int M, int K, int N, int G,
                                              int block_k, int rw, int ks, int stages, int slot_bytes) {
  const SmRing ring = sm_ring(smem_raw, stages, slot_bytes, rw * ks, kSmMaxStagesS8);
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0), lane = threadIdx.x & 31;
  SmJob j;
  j.xmap = nullptr;
  j.wmap = w_map;
  j.xsmap = nullptr;
  j.xq = reinterpret_cast<const uint8_t*>(xq);
  j.xs = reinterpret_cast<const uint8_t*>(xs);
  j.scales = scales;
  j.zeros = zeros;
  j.ld = N;
  j.rw = rw;
  j.ks = ks;
  const int rh = 8 * rw;
  const int n0 = blockIdx.x * 2 * rh;
  j.row_a = n0;
  j.row_b = n0 + rh;
  j.valid_a = max(0, min(rh, N - j.row_a));
  j.valid_b = max(0, min(rh, N - j.row_b));
  j.K = K;
  j.G = G;
  j.span = kActSpan;
  j.parts = 2;
  j.st = sm_stage(BITS, NT, rw, ks, kActSpan, 2, 1, 1);
  int g = 0;
  if (warp == rw * ks) {  // the producer warp
    sm_produce<NT, BITS, true>(j, ring.ring, slot_bytes, stages, ring.full, ring.empty, g, M, scales_bf16, lane);
    return;
  }
  float acc[NT][4];
  sm_consume_s8<NT, BITS, KBLOCK>(j, ring.ring, slot_bytes, stages, ring.full, ring.empty, g, warp, lane,
                                  scales_bf16, block_k, acc);
  sm_reduce_slices<NT>(acc, ring.red, rw, ks, warp, lane);
  if (warp / rw != 0) return;
  const int r = 8 * (warp % rw) + (lane >> 2), tig = lane & 3;
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

// A W4A8 kernel's type: every (BITS, NT) instantiation of K2's and K12b's
// __global__ wrappers of sm_w4a8_block.
typedef void (*SmW4a8Kernel)(CUtensorMap, const int8_t*, const float*, const void*, int, const int8_t*, bf16*, int,
                             int, int, int, int, int, int, int, int);

// The W4A8 C call of K2 and K12b: act_quant_kernel (a block per row and
// k-block: the RMSNorm where the call has one, xq, the sums and scales per
// span), then the main grid
// `pick(bits, nt)` as its programmatic dependent: one block per 2 rh weight
// rows, rw row warps (sm_row_warps where ks is 1, else 8 / ks), the ring
// as deep as the shared memory of the blocks an SM holds allows (2 blocks
// up to NT = 4 where the grid has more blocks than the card SMs; else one).
// The caller checks the arguments (M <= 64, G % 128 == 0, K % block_k ==
// 0, block_k % G == 0, K <= 32768, ks in {1, 2, 4}). xq: [K / 32][8 NT][32]
// s8; xs: [K / 64][8 NT] f32.
inline int sm_w4a8_call(SmW4a8Kernel (*pick)(int bits, int nt), const void* x, const void* qweight,
                        const void* scales, const void* zeros, const void* rms_gamma, void* xq, void* xs, void* out,
                        int M, int K, int N, int G, int bits, int scales_bf16, int gamma_bf16, int block_k, int ks,
                        float eps, cudaStream_t st) {
  const int nt = sm_tiles(M);
  const int rw = ks == 1 ? sm_row_warps(N) : kSmWarps / ks, rh = 8 * rw;
  const SmStage s = sm_stage(bits, nt, rw, ks, kActSpan, 2, 1, 1);
  const int red = (ks - 1) * rw * nt * 4 * 32 * 4;
  const int blocks = (N + 2 * rh - 1) / (2 * rh);
  const int stages = sm_stages(s.bytes, red, nt <= 4 && blocks > sm_count() ? 2 : 1, kSmMaxStagesS8);
  const SmW4a8Kernel kernel = pick(bits, nt);
  static SmW4a8Kernel smem_set[8] = {};  // instantiations given the large shared memory, once each
  int i = 0;
  while (i < 8 && smem_set[i] != nullptr && smem_set[i] != kernel) ++i;
  if (i < 8 && smem_set[i] == nullptr) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
    if (e != cudaSuccess) return (int)e;
    smem_set[i] = kernel;
  }
  const int act_smem = 3 * block_k;  // bf16 values and int8 values of one k-block
  static bool act_smem_set = false;
  if (act_smem > 48 * 1024 && !act_smem_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(act_quant_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 96 * 1024);
    if (e != cudaSuccess) return (int)e;
    act_smem_set = true;
  }
  CUtensorMap w_map;
  if (!tensor_map(&w_map, qweight, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, N, K * bits / 8, rh, 128,
                  CU_TENSOR_MAP_SWIZZLE_128B) ||
      reinterpret_cast<uintptr_t>(xq) % 16 != 0 || reinterpret_cast<uintptr_t>(xs) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  act_quant_kernel<<<dim3(M, K / block_k), kActThreads, act_smem, st>>>(
      static_cast<const bf16*>(x), rms_gamma, gamma_bf16, eps, static_cast<int8_t*>(xq), static_cast<float*>(xs), K,
      block_k, 8 * nt, bits);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(32 * (rw * ks + 1));
  cfg.dynamicSmemBytes = sm_smem_bytes(stages, s.bytes, red, kSmMaxStagesS8);
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, w_map, static_cast<const int8_t*>(xq),
                                           static_cast<const float*>(xs), scales, scales_bf16,
                                           static_cast<const int8_t*>(zeros), static_cast<bf16*>(out), M, K, N, G,
                                           block_k, rw, ks, stages, s.bytes);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

}  // namespace
}  // namespace scalellm_quant
