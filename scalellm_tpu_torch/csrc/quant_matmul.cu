// Weight-only INT4/INT8 matmuls with fused dequantization for Hopper (sm_90a).
//
// Replaces the Pallas kernels of scalellm_tpu/ops/quant_matmul.py:
//   scalellm_quant_matmul_w4a8    <- _w4a8_kernel    (:360)
//   scalellm_quant_matmul_group   <- _group_kernel   (:259)
//   scalellm_quant_matmul_dequant <- _dequant_kernel (:519)
// and, as a feature of all three, the RMSNorm prologue _fused_rms/_rms_wrap
// (:238, :250). The layer-stacked weight stream _stream_kernel (:995), which
// the TPU models run around those bodies, does three things, each with its
// counterpart here:
//   the dynamic layer offset into the stacked tensor -> the qweight, scales
//     and zeros pointers of the call are that layer's own;
//   the depth-3 DMA ring of weight tiles -> the TMA rings of w4a8_kernel
//     (quant_small_m.cuh's W4A8 mainloop) and tile_kernel;
//   the norm computed once per call, ahead of the streamed tiles ->
//     act_quant_kernel (w4a8; quant_act.cuh) and prep_kernel (group,
//     dequant; quant_small_m.cuh).
// Plain PyTorch versions: scalellm_tpu_torch/ops/quant_matmul.py.
//
// Layout (the port's own; scalellm_tpu_torch/ops/quant_matmul.py converts):
//   x        bf16 [M, K]
//   qweight  int4: u8 [N, K/2], K-contiguous; byte j of row n holds K=2j in
//            bits 0-3 and K=2j+1 in bits 4-7, each a SIGNED nibble (two's
//            complement, the checkpoint's unsigned value minus 8).
//            int8: s8 [N, K].
//   scales   f32 or bf16 [K/G, N];  zeros  s8 [K/G, N] or null (symmetric)
//   out      bf16 [M, N]
// K-contiguous weights let one 16-byte load of a thread hold 32 (int4) or 16
// (int8) consecutive K of one output column, which is what the tensor core's
// "col" B fragment wants.
//
// What each computes:
//   w4a8: x (after the optional RMSNorm, rounded to bf16) is quantized to
//     int8 per (row, k-block of block_k): sx = max(absmax, 1e-10) * (1/127),
//     xq = clip(rint(x / sx), -127, 127). Per 128-K span (the weight group
//     at G = 128) an int8 x int8 dot with int32 sums; (dot - xsum * zero) *
//     group scale, summed over the k-block's spans in f32, times sx, summed
//     over k-blocks. M <= 64, G % 128 == 0.
//   group: per weight group a bf16 x bf16(q) dot with f32 sums, then
//     (dot - xsum * zero) * scale, summed over groups in f32.
//   dequant: w = bf16(bf16(q - zero) * bf16(scale)), one bf16 dot over all
//     of K with f32 sums. The two roundings to bf16 are what separates it
//     from `group`.
//
// What bounds them on an H100. Decode (w4a8, M <= 64): the weight bytes.
// A (4096 x 4096) INT4 projection is 8.4 MB of weights and 0.5 MB of
// scales, 2.7 us at 3.35 TB/s, against 2*M*K*N = 2.1 GFLOP at M = 64, 1.1 us
// at the int8 rate. Prefill (dequant, M = 512): 2*512*K*N flops at 989
// TFLOP/s against the same bytes: (4096, 4096) is 17 us of tensor-core time
// against 4 us of bytes, so operations bound it from M of about 150 up. In
// practice the tile kernel is bound by neither: each weight is unpacked to
// bf16 once per token tile, on the integer pipes, and that (with the wgmma
// a warpgroup cannot overlap with its own unpacking) sets its time.
//
// Design, simple first:
//   w4a8: the W4A8 mainloop of quant_small_m.cuh (shared with K12b): a
//     pre-pass (act_quant_kernel, quant_act.cuh, a block per row and k-block) normalises
//     and quantizes x once into scratch, in the K order of the mainloop's A
//     fragments, with each span's int32 sum of xq and activation scale; the
//     main grid, launched as its programmatic dependent, has its first
//     stages' weights in flight before it waits for the pre-pass. out^T =
//     W xq^T on mma.sync m16n8k32 s8: the weights are the 16-row A operand
//     (int4 nibbles used as 16 times their value by two masks, int8 as they
//     are), the int8 tokens the n = 8 B operand, both from a TMA ring that
//     one producer warp keeps full; K split over a block's warps where N is
//     small, their sums added in slice order.
//   group / dequant (tile_kernel): the transposed product, out^T[rows,
//     tokens] = W[rows, K] x^T, so that the weights are wgmma's 64-row A
//     operand, unpacked (and for dequant scaled, with both bf16 roundings)
//     in registers, and x is the B operand in shared memory; one kernel
//     covers a 16-token decode call (a 32-token tile) and a 512-token
//     prefill (128-token tiles). A block is WGS consumer warpgroups of 64
//     weight rows each and one producer warp. The producer keeps a 4-stage
//     ring of 64-K stages full: x by TMA with the 128-byte swizzle that the
//     wgmma descriptor reads, the packed weights by TMA (32- or 64-byte
//     swizzle, so 8 rows read at once hit distinct banks), the stage's
//     scales and zero points (and group's sums of x) by 4-byte cp.async;
//     mbarriers "full" and "empty" per stage. A consumer reads a stage's
//     packed weights from shared memory and unpacks its A fragments (int4:
//     a thread's bytes gathered by byte-permutes, then two weights by one
//     byte-permute and one logic op), then issues
//     wgmma.mma_async m64nNk16 (N = the token tile) with nothing between
//     its fence and its wait that ptxas would take for divergent, and
//     waits; the warpgroups overlap one another's unpacking and products.
//     group folds (dot - sum(x) * z) * s into the f32 accumulator after
//     every 32-K span (the dot of a span starts at 0), with the sums of x
//     per span from the pre-pass. Tiles (weight rows x tokens): the wrapper
//     picks 64 x 32 / 64 x 64 up to M = 64, and above that the shape whose
//     waves over the SMs cost least (at the 8B shapes 128 x 128, or
//     192 x 128 for dequant where N is large). x crosses L2 ceil(N / rows)
//     times and the weights ceil(M / tokens) times: 0.86 GB at the 8B
//     gate_up (M = 512, 192 x 128) against 2.35 GB with the 64 x 64 tiles
//     of the first kernel. The epilogue writes the tile through shared
//     memory as rows of out. The RMSNorm prologue runs in prep_kernel,
//     once per row, into a bf16 scratch copy of x that the TMA then reads.
// Measured limits (H100, chip_smoke.py): the tile kernel is bound by the
// consumers' unpacking, not by bytes or tensor time: a deeper ring changes
// nothing, and the unpacking of a stage outlasts its products. Later work:
// a cheaper unpack (fewer integer ops a weight), a larger token tile (fewer
// unpackings a weight) within the 168 registers a thread has. w4a8: see
// quant_small_m.cuh and PERF.md.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "quant_act.cuh"
#include "quant_small_m.cuh"
#include "quant_unpack.cuh"

namespace {

using scalellm_quant::bf16x2_bits;
using scalellm_quant::bf16x2_from_bits;
using scalellm_quant::fence_regs;
using scalellm_quant::int8_pair;
using scalellm_quant::kPrepThreads;
using scalellm_quant::kSmThreads;
using scalellm_quant::load_f32_or_bf16;
using scalellm_quant::mbar_arrive;
using scalellm_quant::mbar_arrive_cp_async;
using scalellm_quant::mbar_arrive_expect_tx;
using scalellm_quant::mbar_init;
using scalellm_quant::mbar_wait;
using scalellm_quant::pack_bf16x2;
using scalellm_quant::prep_kernel;
using scalellm_quant::sm_w4a8_block;
using scalellm_quant::smem_addr;
using scalellm_quant::SmW4a8Kernel;
using scalellm_quant::sw128_desc;
using scalellm_quant::tensor_map;
using scalellm_quant::tma_load_2d;
using scalellm_quant::unpack_int4_frag;
using scalellm_quant::wgmma_commit;
using scalellm_quant::wgmma_fence;
using scalellm_quant::wgmma_wait;

typedef __nv_bfloat16 bf16;

// ------------------------------------------------------------ w4a8 (K2)

// The W4A8 mainloop of quant_small_m.cuh with K2's fold: the k-block's
// span sums times its activation scale. NT: token tiles of 8 (1, 2, 4, 8).
template <int BITS, int NT>
__global__ void __launch_bounds__(kSmThreads, NT <= 4 ? 2 : 1) w4a8_kernel(
    const __grid_constant__ CUtensorMap w_map, const int8_t* __restrict__ xq, const float* __restrict__ xs,
    const void* __restrict__ scales, int scales_bf16, const int8_t* __restrict__ zeros, bf16* __restrict__ out, int M,
    int K, int N, int G, int block_k, int rw, int ks, int stages, int slot_bytes) {
  extern __shared__ uint8_t smem_raw[];
  sm_w4a8_block<BITS, NT, true>(smem_raw, &w_map, xq, xs, scales, scales_bf16, zeros, out, M, K, N, G,
                                block_k, rw, ks, stages, slot_bytes);
}

SmW4a8Kernel w4a8_kernel_for(int bits, int nt) {
  switch (nt) {
    case 1: return bits == 4 ? w4a8_kernel<4, 1> : w4a8_kernel<8, 1>;
    case 2: return bits == 4 ? w4a8_kernel<4, 2> : w4a8_kernel<8, 2>;
    case 4: return bits == 4 ? w4a8_kernel<4, 4> : w4a8_kernel<8, 4>;
    default: return bits == 4 ? w4a8_kernel<4, 8> : w4a8_kernel<8, 8>;
  }
}

// ------------------------------------------------------------ group / dequant

constexpr int kBK = 64;      // K per ring stage: one 128-byte row (a swizzle atom) of the x tile
constexpr int kStages = 4;   // depth of the shared-memory ring

// Asynchronous copy global -> shared of 4 bytes: the first src_bytes are
// read and the rest of the destination is zero-filled.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes)
               : "memory");
}

// wgmma: D[64 x N] (+)= A[64 x 16] B[16 x N], A from registers (per warp the
// mma.sync m16n8k16 A fragment of its 16 rows), B from shared memory through
// a descriptor. scale_d 0 starts the sum at 0.
__device__ __forceinline__ void wgmma_m64n32(float (&d)[16], const uint32_t (&a)[4], uint64_t desc,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n64(float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], const uint32_t (&a)[4], uint64_t desc,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}


template <int BT>
__device__ __forceinline__ void wgmma_tokens(float (&d)[BT / 2], const uint32_t (&a)[4], uint64_t desc,
                                             int scale_d) {
  if constexpr (BT == 32) wgmma_m64n32(d, a, desc, scale_d);
  else if constexpr (BT == 64) wgmma_m64n64(d, a, desc, scale_d);
  else wgmma_m64n128(d, a, desc, scale_d);
}

template <bool FIRST, class T>
__device__ __forceinline__ T& pick(T& a, T& b) {
  if constexpr (FIRST) return a;
  else return b;
}

// A block: WGS warpgroups, each owning 64 of the block's weight rows
// (output columns), all of them over BT tokens.
template <int BITS, int WGS, int BT>
struct TileShape {
  static constexpr int kConsumers = 128 * WGS;    // the consumer warpgroups
  static constexpr int kThreads = kConsumers + 32;  // and one producer warp
  static constexpr int kRows = 64 * WGS;
  static constexpr int kRowBytes = BITS == 4 ? kBK / 2 : kBK;  // one weight row of a stage
  static constexpr int kXBytes = BT * 128;  // a multiple of 1024: the weights follow aligned
  static constexpr int kWBytes = kRows * kRowBytes;
  static constexpr int kSBytes = kRows * 4 + 16;  // one group's scales, from a 4-byte aligned start
  static constexpr int kZBytes = kRows + 16;      // one group's zero points, likewise
  static constexpr int kXsBytes = BT * 4;         // group: one 32-K span's sums of x
  static constexpr int kStageBytes =
      (kXBytes + kWBytes + 2 * (kSBytes + kZBytes + kXsBytes) + 1023) / 1024 * 1024;
  static constexpr int kOutLd = kRows + 8;  // bf16 stride of the epilogue's [BT][kRows] tile
  static constexpr int kRingBytes = kStages * kStageBytes;
  static constexpr int kOutBytes = BT * kOutLd * 2;
  static constexpr int kBarOffset = kRingBytes > kOutBytes ? kRingBytes : kOutBytes;
  static constexpr int kSmem = kBarOffset + 2 * kStages * 8 + 1024;
};

// DEQUANT false: `group`, true: `dequant`. The transposed product:
// out^T[rows, tokens] = W[rows, K] x^T, the weights as the 64-row operand.
// grid (ceil(M / BT), ceil(N / kRows)): the token tiles of one weight tile
// are neighbours in launch order, so a weight tile crosses device memory
// once and x (small) stays in L2. xsum (group with zero points) is the
// pre-pass's f32 [K/32, M] sums of x per 32-K span.
template <bool DEQUANT, int BITS, int WGS, int BT>
__global__ void __launch_bounds__(128 * WGS + 32, 1) tile_kernel(
    const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap w_map,
    const void* __restrict__ scales, int scales_bf16, const int8_t* __restrict__ zeros,
    const float* __restrict__ xsum, bf16* __restrict__ out, int M, int K, int N, int G) {
  using S = TileShape<BITS, WGS, BT>;
  constexpr int kAcc = BT / 2;  // the accumulators a thread holds
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~static_cast<uintptr_t>(1023));

  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);  // uniform, as the compiler can see
  const int gid = lane >> 2, tig = lane & 3;
  const int m0 = blockIdx.x * BT, n0 = blockIdx.y * S::kRows;
  const bool asym = zeros != nullptr;
  const int es = scales_bf16 ? 2 : 4;
  const int n_kt = (K + kBK - 1) / kBK;
  // Scale windows a stage stages: one per 32-K span where G is not a
  // multiple of 64 (span h's group is (k0 + 32 h) / G), else one.
  const int ngs = G % kBK ? 2 : 1;
  const int n_valid = min(S::kRows, N - n0);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S::kBarOffset);  // stage landed
  uint64_t* empty = full + kStages;                                     // stage consumed
  // This thread's first weight row (block-local); the fragment's second row
  // is 8 further.
  const int rbase = (warp >> 2) * 64 + (warp & 3) * 16 + gid;

  // One group's scales (or zero points) of the block's rows, as bytes from
  // the 4-byte word that holds the first: 4-byte copies, the tail of the
  // last zero-filled, nothing read past row N.
  auto window_start = [&](const void* base, int esz, int g) {
    return reinterpret_cast<uintptr_t>(base) + ((size_t)g * N + n0) * esz;
  };
  auto copy_window = [&](const void* base, int esz, int g, const uint8_t* dst) {
    const uintptr_t first = window_start(base, esz, g);
    const uintptr_t end = first + (uintptr_t)n_valid * esz;
    const uintptr_t lo = first & ~static_cast<uintptr_t>(3);
    const int words = (int)((end - lo + 3) >> 2);
    for (int i = lane; i < words; i += 32) {
      const uintptr_t a = lo + 4 * (uintptr_t)i;
      const int left = (int)(end - a);
      cp_async4(smem_addr(dst + 4 * i), reinterpret_cast<const void*>(a), left < 4 ? left : 4);
    }
  };
  auto scales_of = [&](const uint8_t* st, int j) { return st + S::kXBytes + S::kWBytes + j * S::kSBytes; };
  auto zeros_of = [&](const uint8_t* st, int j) {
    return st + S::kXBytes + S::kWBytes + 2 * S::kSBytes + j * S::kZBytes;
  };
  auto xsum_of = [&](const uint8_t* st, int h) {
    return reinterpret_cast<const float*>(st + S::kXBytes + S::kWBytes + 2 * (S::kSBytes + S::kZBytes) +
                                          h * S::kXsBytes);
  };
  // Stage kt of the ring, issued by the producer warp: the x tile (BT rows
  // of 64 K, TMA with the 128-byte swizzle: 16-byte chunk c of row t at
  // chunk c ^ (t % 8)) and the weight tile (kRows rows of kRowBytes, TMA with
  // the 32- or 64-byte swizzle, so that 8 rows read at once hit distinct
  // banks), both zero-filled past M, N and K; then the scales and zero points
  // of its groups by cp.async. full[s] completes when all of it has landed.
  auto load_stage = [&](int kt) {
    const int s = kt % kStages;
    uint8_t* st = ring + s * S::kStageBytes;
    const int k0 = kt * kBK;
    if (lane == 0) {
      mbar_arrive_expect_tx(&full[s], S::kXBytes + S::kWBytes);
      tma_load_2d(st, &x_map, k0, m0, &full[s]);
      tma_load_2d(st + S::kXBytes, &w_map, BITS == 4 ? k0 / 2 : k0, n0, &full[s]);
    }
    for (int j = 0; j < ngs && k0 + 32 * j < K; ++j) {
      const int g = (k0 + 32 * j) / G;
      copy_window(scales, es, g, scales_of(st, j));
      if (asym) copy_window(zeros, 1, g, zeros_of(st, j));
    }
    if (!DEQUANT && asym) {  // group's sums of x over the stage's two spans, tokens past M zero
      for (int h = 0; h < 2 && k0 + 32 * h < K; ++h)
        for (int i = lane; i < BT; i += 32) {
          const bool ok = m0 + i < M;
          cp_async4(smem_addr(xsum_of(st, h) + i), ok ? xsum + (size_t)(k0 / 32 + h) * M + m0 + i : xsum,
                    ok ? 4 : 0);
        }
    }
    mbar_arrive_cp_async(&full[s]);
  };

  float acc[kAcc];
  float cg[kAcc];  // group: the dot of the span in progress (dequant: unused)
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = cg[i] = 0.f;

  // Per stage, this thread's rows r = rbase + 8 h: dequant's bf16 scale (as
  // f32) and zero point of the group of the stage's first 32-K span (lo)
  // and, where G is not a multiple of 64, of its second (hi: k16 steps 2
  // and 3); group's scale and zero point of the span being folded.
  float s_lo[2], s_hi[2], z_lo[2], z_hi[2];
  auto read_rows = [&](const uint8_t* st, int j, int g, float (&s)[2], float (&z)[2], bool round) {
    const uint8_t* sw = scales_of(st, j) + (window_start(scales, es, g) & 3);
    const int8_t* zw = reinterpret_cast<const int8_t*>(zeros_of(st, j) + (window_start(zeros, 1, g) & 3));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = rbase + 8 * h;
      float v = scales_bf16 ? __bfloat162float(reinterpret_cast<const bf16*>(sw)[r])
                            : reinterpret_cast<const float*>(sw)[r];
      s[h] = round ? __bfloat162float(__float2bfloat16_rn(v)) : v;
      z[h] = asym ? (float)zw[r] : 0.f;
    }
  };

  // group: after each 32-K span h of a stage, acc += (dot - sum(x) * z) * s
  // with the span's dot, the pre-pass's sums of x over the span (staged
  // with the stage: tokens 8q + 2 tig + e of this thread) and the scale and
  // zero point of the span's group: the same sum over the group as one fold
  // per group.
  auto fold_span = [&](const uint8_t* st, int h, bool valid) {
    if constexpr (!DEQUANT) {
      const float* xsh = xsum_of(st, h);
#pragma unroll
      for (int q = 0; q < BT / 8; ++q) {
        float2 x2 = make_float2(0.f, 0.f);
        if (asym && valid) x2 = *reinterpret_cast<const float2*>(xsh + 8 * q + 2 * tig);
        acc[4 * q + 0] += (cg[4 * q + 0] - x2.x * z_lo[0]) * s_lo[0];
        acc[4 * q + 1] += (cg[4 * q + 1] - x2.y * z_lo[0]) * s_lo[0];
        acc[4 * q + 2] += (cg[4 * q + 2] - x2.x * z_lo[1]) * s_lo[1];
        acc[4 * q + 3] += (cg[4 * q + 3] - x2.y * z_lo[1]) * s_lo[1];
      }
    }
  };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 33);        // the producer's expect_tx and its 32 lanes' cp.async arrivals
      mbar_init(&empty[s], 4 * WGS);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * WGS) {  // the producer warp keeps the ring full
    for (int kt = 0; kt < n_kt; ++kt) {
      if (kt >= kStages) mbar_wait(&empty[kt % kStages], (kt / kStages - 1) & 1);
      load_stage(kt);
    }
    return;
  }

  // The consumers. A stage is unpacked whole into registers, then its
  // products are issued with no branch between the fence and the wait (a
  // wgmma on a divergent path, or a register of a wgmma written while it
  // runs, makes ptxas serialize every wgmma of the kernel); the warpgroups
  // overlap one another's unpacking and products.
  uint32_t a[4][4];  // the A fragments of k16 steps 0-3
  constexpr int kPieces = BITS == 4 ? 2 : 4;
  uint4 wv[2][kPieces];  // the stage's packed weights of this thread's rows
  float(&target)[kAcc] = pick<DEQUANT>(acc, cg);  // what the products add to
  auto issue = [&](const uint8_t* st, int ks, bool zero) {
    wgmma_tokens<BT>(target, a[ks], sw128_desc(st, ks), zero ? 0 : 1);
  };
  auto complete = [&](int ks_lo, int ks_hi) {  // the issued products have landed in target
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(target);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      if (ks >= ks_lo && ks < ks_hi) fence_regs(a[ks]);
  };

  for (int kt = 0; kt < n_kt; ++kt) {
    mbar_wait(&full[kt % kStages], (kt / kStages) & 1);
    const uint8_t* st = ring + (kt % kStages) * S::kStageBytes;
    const uint8_t* wt = st + S::kXBytes;
    const int k0 = kt * kBK;
    const int n_ks = min(4, (K - k0) / 16);  // 2 in the last stage where K % 64 == 32
    const bool two = ngs > 1 && n_ks > 2;  // a window for the second span (G % 64 != 0)
    if constexpr (DEQUANT) {
      read_rows(st, 0, k0 / G, s_lo, z_lo, true);
      if (two) read_rows(st, 1, (k0 + 32) / G, s_hi, z_hi, true);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = rbase + 8 * h;
#pragma unroll
      for (int c = 0; c < kPieces; ++c) {
        const int pos = BITS == 4 ? c ^ ((r >> 2) & 1) : c ^ ((r >> 1) & 3);
        wv[h][c] = *reinterpret_cast<const uint4*>(wt + r * S::kRowBytes + (pos << 4));
      }
    }
    // int4: per group of the stage (lo / hi) and row, the bf16 unpack offset
    // (136, or 136 + z for dequant) and dequant's bf16 scale.
    __nv_bfloat162 off[2][2], sc[2][2];
    if constexpr (BITS == 4) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        off[0][h] = __float2bfloat162_rn(136.f + (DEQUANT ? z_lo[h] : 0.f));
        sc[0][h] = __float2bfloat162_rn(s_lo[h]);
        off[1][h] = two ? __float2bfloat162_rn(136.f + (DEQUANT ? z_hi[h] : 0.f)) : off[0][h];
        sc[1][h] = two ? __float2bfloat162_rn(s_hi[h]) : sc[0][h];
      }
    }
    auto unpack = [&](int ks) {  // the A fragments of k16 step ks
      const int gi = (ks >= 2 && two) ? 1 : 0;  // the stage's group of this step
      uint32_t(&f)[4] = a[ks];
      if constexpr (BITS == 4) {
        // Byte tig of each half of this k16 step's 8 bytes in rows r0 and
        // r1: the fragment's k 2 tig, 2 tig + 1 and 8 + 2 tig, 9 + 2 tig.
        const uint32_t sel = tig | ((tig + 4) << 4);
        const uint4 w = wv[0][ks >> 1], v = wv[1][ks >> 1];
        const uint32_t p = __byte_perm((ks & 1) ? w.z : w.x, (ks & 1) ? v.z : v.x, sel);
        const uint32_t q = __byte_perm((ks & 1) ? w.w : w.y, (ks & 1) ? v.w : v.y, sel);
        // (selects, not a register array indexed at run time)
        unpack_int4_frag(__byte_perm(p, q, 0x5410), gi ? off[1][0] : off[0][0], gi ? off[1][1] : off[0][1], f);
        if (DEQUANT) {
          const __nv_bfloat162 c0 = gi ? sc[1][0] : sc[0][0], c1 = gi ? sc[1][1] : sc[0][1];
#pragma unroll
          for (int e = 0; e < 4; ++e) f[e] = bf16x2_bits(__hmul2(bf16x2_from_bits(f[e]), (e & 1) ? c1 : c0));
        }
      } else {
        const float s0 = gi ? s_hi[0] : s_lo[0], s1 = gi ? s_hi[1] : s_lo[1];
        const float z0 = gi ? z_hi[0] : z_lo[0], z1 = gi ? z_hi[1] : z_lo[1];
        const uint32_t sel = (2 * tig) | ((2 * tig + 1) << 4);
        const uint4 w = wv[0][ks], v = wv[1][ks];
        f[0] = int8_pair<DEQUANT>(__byte_perm(w.x, w.y, sel), s0, z0, asym);
        f[1] = int8_pair<DEQUANT>(__byte_perm(v.x, v.y, sel), s1, z1, asym);
        f[2] = int8_pair<DEQUANT>(__byte_perm(w.z, w.w, sel), s0, z0, asym);
        f[3] = int8_pair<DEQUANT>(__byte_perm(v.z, v.w, sel), s1, z1, asym);
      }
      // K past the end (a zero-filled tile, but dequant's (0 - z) * s of a
      // group that does not exist): no contribution.
#pragma unroll
      for (int e = 0; e < 4; ++e) f[e] = ks < n_ks ? f[e] : 0u;
    };
    if constexpr (DEQUANT) {
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) unpack(ks);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) issue(st, ks, false);
      complete(0, 4);
    } else {
      // group: one 32-K span at a time (its two k16 steps' fragments live),
      // which leaves the registers for the second accumulator.
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int span = k0 / 32 + h;
        const bool valid = 32 * span < K;
        unpack(2 * h);
        unpack(2 * h + 1);
        wgmma_fence();
        issue(st, 2 * h, true);
        issue(st, 2 * h + 1, false);
        complete(2 * h, 2 * h + 2);
        read_rows(st, ngs > 1 ? h : 0, (32 * span) / G, s_lo, z_lo, false);
#pragma unroll
        for (int e = 0; e < 2; ++e) s_lo[e] = valid ? s_lo[e] : 0.f;
        fold_span(st, h, valid);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[kt % kStages]);  // this warp is done with the stage
  }

  // Epilogue: the transposed tile through shared memory (the ring is free
  // once every consumer warp is past its last stage: every load has landed),
  // then rows of out in 16-byte stores where N allows.
  asm volatile("bar.sync 1, %0;\n" ::"n"(S::kConsumers) : "memory");
  bf16* os = reinterpret_cast<bf16*>(ring);
#pragma unroll
  for (int q = 0; q < BT / 8; ++q)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rbase + (i >> 1) * 8, t = 8 * q + 2 * tig + (i & 1);
      os[t * S::kOutLd + r] = __float2bfloat16_rn(acc[4 * q + i]);
    }
  asm volatile("bar.sync 1, %0;\n" ::"n"(S::kConsumers) : "memory");
  const int t_valid = min(BT, M - m0);
  const bool vec = N % 8 == 0;
  for (int i = tid; i < BT * (S::kRows / 8); i += S::kConsumers) {
    const int t = i / (S::kRows / 8), c = (i % (S::kRows / 8)) * 8;
    if (t >= t_valid || c >= n_valid) continue;
    bf16* dst = out + (size_t)(m0 + t) * N + n0 + c;
    const bf16* src = os + t * S::kOutLd + c;
    if (vec && c + 8 <= n_valid) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 8 && c + e < n_valid; ++e) dst[e] = src[e];
    }
  }
}

template <bool DEQUANT, int BITS, int WGS, int BT>
int launch_tile_shape(const bf16* x, const void* qweight, const void* scales, const void* zeros,
                      const float* xsum, void* out, int M, int K, int N, int G, int scales_bf16,
                      cudaStream_t st) {
  using S = TileShape<BITS, WGS, BT>;
  const auto kernel = tile_kernel<DEQUANT, BITS, WGS, BT>;
  static bool smem_set = false;  // once per instantiation
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  const dim3 grid((M + BT - 1) / BT, (N + S::kRows - 1) / S::kRows);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  CUtensorMap x_map, w_map;
  if (!tensor_map(&x_map, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, M, K, BT, kBK, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map(&w_map, qweight, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, N, BITS == 4 ? K / 2 : K, S::kRows,
                  S::kRowBytes, BITS == 4 ? CU_TENSOR_MAP_SWIZZLE_32B : CU_TENSOR_MAP_SWIZZLE_64B))
    return (int)cudaErrorInvalidValue;
  kernel<<<grid, S::kThreads, S::kSmem, st>>>(x_map, w_map, scales, scales_bf16, static_cast<const int8_t*>(zeros),
                                               xsum, static_cast<bf16*>(out), M, K, N, G);
  return (int)cudaGetLastError();
}

// tile: the block shape the wrapper chose (ops/quant_matmul.py TILES, as
// (weight rows, tokens)): 0 (64, 32), 1 (64, 64), 2 (128, 64), 3 (128, 128)
// and, for dequant, 4 (192, 128). A warpgroup owns 64 rows: 128 rows a
// warpgroup (128 accumulators) and the fragments of a stage do not fit the
// 168 registers a thread has beside a producer warp, and ptxas then
// serializes the wgmma (group holds a second accumulator: it unpacks one
// 32-K span at a time).
template <bool DEQUANT, int BITS>
int launch_tile_bits(const bf16* x, const void* qweight, const void* scales, const void* zeros,
                     const float* xsum, void* out, int M, int K, int N, int G, int scales_bf16,
                     int tile, cudaStream_t st) {
#define SCALELLM_TILE(WGS, BT) \
  launch_tile_shape<DEQUANT, BITS, WGS, BT>(x, qweight, scales, zeros, xsum, out, M, K, N, G, scales_bf16, st)
  switch (tile) {
    case 0: return SCALELLM_TILE(1, 32);
    case 1: return SCALELLM_TILE(1, 64);
    case 2: return SCALELLM_TILE(2, 64);
    case 3: return SCALELLM_TILE(2, 128);
    case 4: if constexpr (DEQUANT) return SCALELLM_TILE(3, 128); break;
  }
#undef SCALELLM_TILE
  return (int)cudaErrorInvalidValue;
}

template <bool DEQUANT>
int launch_tile(const void* x, const void* qweight, const void* scales, const void* zeros,
                const void* rms_gamma, void* xn, void* xsum, void* out, int M, int K, int N, int G,
                int bits, int scales_bf16, int gamma_bf16, float rms_eps, int tile, cudaStream_t st) {
  if (M <= 0 || N <= 0) return 0;
  const bool need_xsum = !DEQUANT && zeros != nullptr;
  if ((bits != 4 && bits != 8) || G <= 0 || K % G != 0 || G % 32 != 0 || K % 32 != 0 ||
      N % 2 != 0 || (rms_gamma != nullptr && xn == nullptr) || (need_xsum && xsum == nullptr))
    return (int)cudaErrorInvalidValue;
  if (rms_gamma != nullptr || need_xsum) {
    prep_kernel<<<M, kPrepThreads, 0, st>>>(
        static_cast<const bf16*>(x), rms_gamma, gamma_bf16, rms_eps,
        rms_gamma != nullptr ? static_cast<bf16*>(xn) : nullptr,
        need_xsum ? static_cast<float*>(xsum) : nullptr, M, K, 32, M);
    const int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
  }
  const bf16* xin = static_cast<const bf16*>(rms_gamma != nullptr ? xn : x);
  const float* xs = need_xsum ? static_cast<const float*>(xsum) : nullptr;
  return bits == 4
             ? launch_tile_bits<DEQUANT, 4>(xin, qweight, scales, zeros, xs, out, M, K, N, G, scales_bf16, tile, st)
             : launch_tile_bits<DEQUANT, 8>(xin, qweight, scales, zeros, xs, out, M, K, N, G, scales_bf16, tile, st);
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each launches on `stream` and
// returns cudaGetLastError() (0 on success); none synchronises or allocates.

// xq s8 [K / 32, M padded to 8, 16, 32 or 64, 32] and xs f32 [K / 64, M
// padded] (xq in 32-K pieces, and per 128-K span the int32 sums of xq and
// the activation scales, as the ring's stages take them) are scratch the
// caller allocates; k_slices: the K slices of a block (1, 2 or 4; the
// wrapper's small_m_slices). M <= 64, G % 128 == 0, block_k a multiple of G
// that divides K, K <= 32768; x and qweight 16-byte aligned (TMA).
extern "C" int scalellm_quant_matmul_w4a8(
    const void* x, const void* qweight, const void* scales, const void* zeros,
    const void* rms_gamma, void* xq, void* xs, void* out, int M, int K, int N,
    int group_size, int bits, int scales_bf16, int gamma_bf16, int block_k, int k_slices, float rms_eps,
    void* stream) {
  if (M <= 0 || N <= 0) return 0;
  const int G = group_size;
  if ((bits != 4 && bits != 8) || M > 64 || G <= 0 || G % 128 != 0 || K % G != 0 || block_k <= 0 ||
      block_k % G != 0 || K % block_k != 0 || K > 32 * 1024 || (k_slices != 1 && k_slices != 2 && k_slices != 4))
    return (int)cudaErrorInvalidValue;
  return scalellm_quant::sm_w4a8_call(w4a8_kernel_for, x, qweight, scales, zeros, rms_gamma, xq, xs, out, M, K, N,
                                      G, bits, scales_bf16, gamma_bf16, block_k, k_slices, rms_eps,
                                      reinterpret_cast<cudaStream_t>(stream));
}

// xn bf16 [M, K] (with rms_gamma) and xsum f32 [K / 32, M] (group with
// zeros) are scratch the caller allocates; tile is the block shape the
// caller chose (launch_tile_bits).
extern "C" int scalellm_quant_matmul_group(
    const void* x, const void* qweight, const void* scales, const void* zeros,
    const void* rms_gamma, void* xn, void* xsum, void* out, int M, int K, int N, int group_size,
    int bits, int scales_bf16, int gamma_bf16, int tile, float rms_eps, void* stream) {
  return launch_tile<false>(x, qweight, scales, zeros, rms_gamma, xn, xsum, out, M, K, N, group_size,
                            bits, scales_bf16, gamma_bf16, rms_eps, tile,
                            reinterpret_cast<cudaStream_t>(stream));
}

extern "C" int scalellm_quant_matmul_dequant(
    const void* x, const void* qweight, const void* scales, const void* zeros,
    const void* rms_gamma, void* xn, void* xsum, void* out, int M, int K, int N, int group_size,
    int bits, int scales_bf16, int gamma_bf16, int tile, float rms_eps, void* stream) {
  return launch_tile<true>(x, qweight, scales, zeros, rms_gamma, xn, xsum, out, M, K, N, group_size,
                           bits, scales_bf16, gamma_bf16, rms_eps, tile,
                           reinterpret_cast<cudaStream_t>(stream));
}
