// Routed quantized-expert matmuls for Hopper (sm_90a): K7 and K8.
//
// Replace the Pallas kernels of scalellm_tpu/ops/moe_quant.py:
//   scalellm_moe_quant_decode       <- _decode_kernel      (:121, pallas_call :541)
//   scalellm_moe_quant_decode_pair  <- _decode_kernel_pair (:236, pallas_call :406)
// Plain PyTorch versions: scalellm_tpu_torch/ops/moe_quant.py
// (plain_grouped_quant_matmul, plain_grouped_quant_matmul_pair).
//
// Contract (the port's layout; ops/moe_quant.py converts):
//   xs       bf16 [R, K]: the routed rows of a decode-sized step;
//   active   i32 [A]: the experts to multiply, padded with -1;
//   starts, sizes  i32 [E]: expert e owns rows [starts[e], starts[e] +
//            sizes[e]). Taken as given: after the sort-by-expert dispatch
//            starts is the exclusive cumsum of sizes, in the T=1 layout row j
//            belongs to top-k slot j's expert and the rows are not sorted;
//   qweight  int4: u8 [E, N, K/2], K-contiguous, byte j of a row holding K=2j
//            in bits 0-3 and K=2j+1 in bits 4-7 as signed nibbles (the byte
//            order of ops/quant_matmul.py's kernel layout, per expert);
//            int8: s8 [E, N, K];
//   scales   int4: bf16 [E, K/G, N], one per (expert, k-group, column);
//            int8: f32 [E, N], one per (expert, column);
//   out      f32 [R, N]: xs_rows . dequant(W_e) for the rows of every active
//            expert, 0 on every other row.
// What each computes, as the TPU kernel does:
//   int4: per group of G k-rows a bf16 x bf16 dot with f32 sums (the nibbles
//     are exact in bf16), times that group's bf16 scale, summed over groups;
//   int8: the bf16 x bf16(q) dot over all of K, times the channel's f32 scale.
// The pair entry point (K8) does this for gate and up in one launch: each
// block reads its rows of xs once and multiplies them by both weights.
//
// What bounds it on an H100: the bytes of the active experts' weights, read
// once. At DeepSeek-V2-Lite's decode step (8 sequences padded to 16 tokens,
// 6 experts each: 96 rows, about 40 of the 64 experts active) the int4 gate
// and up weights of an active expert are 2 x 1.44 MB and its scales 2 x 45
// KB: about 119 MB a K8 call, 0.036 ms at 3.35 TB/s; down about 62 MB,
// 0.019 ms. The flops (2 x 96 x 2048 x 1408 a projection) are 0.0006 ms.
//
// Design, simple first, on K6's device-side schedule (grouped_matmul.cu):
//   - grid (active slot, N in 128 columns): a block whose slot is -1, or
//     whose expert has no rows, exits at once, so an inactive expert's
//     weights are never read. No host sync plans the launch;
//   - 4 warps, each 32 output columns (four n8 tiles); a block walks its
//     expert's rows in 16-row tiles (one mma.sync m16n8k16 M tile), so one
//     weight tile serves all the expert's rows at decode (a decode step has
//     at most 16 rows an expert; more rows re-read the tile from L2);
//   - per k step a lane loads 16 bytes (4 bytes for int4 with G % 128 != 0)
//     of each of its four weight columns and the same K of its two rows of
//     xs straight from global memory, and both operands use one permutation
//     of K inside the step (K6's trick), so no shared memory or shuffle. A
//     step never straddles a group, so the group's f32 partial sums are
//     scaled when the group ends; the group's scales are loaded with its
//     first step's weights. All the blocks of a decode call are resident at
//     once, so the loads of different warps overlap; no register ring;
//   - int4 -> bf16 by bit placement (quant_unpack.cuh, shared with K4);
//     int8 -> bf16 through f32 (exact for |q| <= 127);
//   - every output row is zeroed first by one cudaMemsetAsync on the stream,
//     so rows outside every group are 0, then each block stores its rows.
//
// Known limits, later work: no shared-memory staging, TMA or wgmma; int4
// needs G % 32 == 0 (G % 128 == 0 for the 16-byte loads), int8 K % 64 == 0,
// and N % 8 == 0 (the wrapper refuses the rest).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "quant_unpack.cuh"

namespace {

using scalellm_quant::bf16x2_bits;
using scalellm_quant::bf16x2_from_bits;
using scalellm_quant::mma_bf16;
using scalellm_quant::unpack_int4x8;

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 128;  // 4 warps
constexpr int kBlockN = 128;   // output columns per block
constexpr int kWarpN = 32;     // output columns per warp: four n8 tiles

// The weights, scales and outputs of one launch: gate and up for the pair.
struct Projections {
  const uint8_t* qweight[2];
  const void* scales[2];
  float* out[2];
};

// `WORDS` 32-bit words from p (16-byte aligned for 4 words), or zeros.
template <int WORDS>
__device__ __forceinline__ void load_words(uint32_t (&dst)[WORDS], const void* p, bool ok) {
  static_assert(WORDS == 1 || WORDS == 4, "1 or 4 words");
  if constexpr (WORDS == 4) {
    const uint4 v = ok ? __ldg(reinterpret_cast<const uint4*>(p)) : make_uint4(0u, 0u, 0u, 0u);
    dst[0] = v.x;
    dst[1] = v.y;
    dst[2] = v.z;
    dst[3] = v.w;
  } else {
    dst[0] = ok ? __ldg(reinterpret_cast<const uint32_t*>(p)) : 0u;
  }
}

// BITS: 4 or 8. KL: consecutive K a lane holds per k step (a step is 4 * KL
// of K). P: projections (1 = K7, 2 = K8).
template <int BITS, int KL, int P>
__global__ void __launch_bounds__(kThreads)
moe_quant_kernel(const bf16* __restrict__ xs, Projections proj, const int* __restrict__ active,
                 const int* __restrict__ starts, const int* __restrict__ sizes, int R, int K, int N,
                 int E, int G) {
  constexpr int KS = 4 * KL;                          // K per step
  constexpr int BW = BITS == 4 ? KL / 8 : KL / 4;     // weight words a lane loads per column and step
  constexpr int HW = KL / 2;                          // bf16 pairs a lane holds per row/column and step
  constexpr int AV = KL / 8;                          // 16-byte pieces of one row of xs per step
  constexpr int STEP_BYTES = BITS == 4 ? KS / 2 : KS; // weight bytes of one column per step
  constexpr int LANE_BYTES = BITS == 4 ? KL / 2 : KL; // of which this lane's

  const int e = active[blockIdx.x];
  if (e < 0 || e >= E) return;
  const int row_begin = max(starts[e], 0);
  const int row_end = min(starts[e] + max(sizes[e], 0), R);
  if (row_begin >= row_end) return;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const int n_warp = blockIdx.y * kBlockN + warp * kWarpN;
  if (n_warp >= N) return;  // no barrier follows

  const size_t row_bytes = BITS == 4 ? (size_t)K / 2 : (size_t)K;
  const int n_steps = K / KS;
  const int group_steps = BITS == 4 ? G / KS : n_steps;
  const int n_groups = BITS == 4 ? K / G : 1;

  // This lane's weight column in each n8 tile (B operand) and its pair of
  // output columns (C fragment). N % 8 == 0, so a tile is valid or not.
  const uint8_t* b_ptr[P][4];
  bool tile_ok[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    tile_ok[j] = n_warp + j * 8 < N;
    const size_t n = tile_ok[j] ? (size_t)(n_warp + j * 8 + g) : (size_t)n_warp;
#pragma unroll
    for (int p = 0; p < P; ++p)
      b_ptr[p][j] = proj.qweight[p] + ((size_t)e * N + n) * row_bytes + c * LANE_BYTES;
  }

  for (int row0 = row_begin; row0 < row_end; row0 += 16) {
    const int r_lo = row0 + g, r_hi = row0 + g + 8;
    const bool ok_lo = r_lo < row_end, ok_hi = r_hi < row_end;
    const bf16* a_lo = xs + (size_t)(ok_lo ? r_lo : row0) * K + c * KL;
    const bf16* a_hi = xs + (size_t)(ok_hi ? r_hi : row0) * K + c * KL;

    float acc[P][4][4], part[P][4][4];
    uint32_t sc[P][4];  // int4: the group's two bf16 scales of this lane's columns
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sc[p][j] = 0u;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[p][j][i] = part[p][j][i] = 0.f;
      }

    for (int s = 0; s < n_steps; ++s) {
      const int k0 = s * KS;
      uint32_t a[2][HW];
#pragma unroll
      for (int v = 0; v < AV; ++v) {
        uint32_t lo[4], hi[4];
        load_words<4>(lo, a_lo + k0 + 8 * v, ok_lo);
        load_words<4>(hi, a_hi + k0 + 8 * v, ok_hi);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[0][4 * v + i] = lo[i];
          a[1][4 * v + i] = hi[i];
        }
      }
      uint32_t raw[P][4][BW];
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int j = 0; j < 4; ++j) load_words<BW>(raw[p][j], b_ptr[p][j] + (size_t)s * STEP_BYTES, tile_ok[j]);
      if (BITS == 4 && s % group_steps == 0) {
        const size_t grp = (size_t)e * n_groups + s / group_steps;
#pragma unroll
        for (int p = 0; p < P; ++p)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const bf16* sp = static_cast<const bf16*>(proj.scales[p]) + grp * N + n_warp + j * 8 + 2 * c;
            sc[p][j] = tile_ok[j] ? __ldg(reinterpret_cast<const uint32_t*>(sp)) : 0u;
          }
      }

#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t b[HW];
          if constexpr (BITS == 4) {
            const __nv_bfloat162 offset = __float2bfloat162_rn(136.f);
#pragma unroll
            for (int w = 0; w < BW; ++w) {
              uint32_t four[4];
              unpack_int4x8(raw[p][j][w], offset, four);
#pragma unroll
              for (int i = 0; i < 4; ++i) b[4 * w + i] = four[i];
            }
          } else {
#pragma unroll
            for (int w = 0; w < BW; ++w) {
              const uint32_t q = raw[p][j][w];
              b[2 * w] = bf16x2_bits(__floats2bfloat162_rn((float)(int8_t)(q & 0xFFu),
                                                           (float)(int8_t)((q >> 8) & 0xFFu)));
              b[2 * w + 1] = bf16x2_bits(__floats2bfloat162_rn((float)(int8_t)((q >> 16) & 0xFFu),
                                                               (float)(int8_t)(q >> 24)));
            }
          }
          // mma m takes this lane's K 4m..4m+3 of the step, for A and B
          // alike; int4 sums into the group's partial sums.
#pragma unroll
          for (int m = 0; m < KL / 4; ++m) {
            if constexpr (BITS == 4)
              mma_bf16(part[p][j], a[0][2 * m], a[1][2 * m], a[0][2 * m + 1], a[1][2 * m + 1], b[2 * m], b[2 * m + 1]);
            else
              mma_bf16(acc[p][j], a[0][2 * m], a[1][2 * m], a[0][2 * m + 1], a[1][2 * m + 1], b[2 * m], b[2 * m + 1]);
          }
        }

      if (BITS == 4 && (s + 1) % group_steps == 0) {
#pragma unroll
        for (int p = 0; p < P; ++p)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const __nv_bfloat162 s2 = bf16x2_from_bits(sc[p][j]);
            const float s_lo = __low2float(s2), s_hi = __high2float(s2);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              acc[p][j][i] += part[p][j][i] * ((i & 1) ? s_hi : s_lo);
              part[p][j][i] = 0.f;
            }
          }
      }
    }

#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!tile_ok[j]) continue;
        const int col = n_warp + j * 8 + 2 * c;
        float2 s = make_float2(1.f, 1.f);
        if (BITS == 8) s = __ldg(reinterpret_cast<const float2*>(static_cast<const float*>(proj.scales[p]) + (size_t)e * N + col));
        if (ok_lo) *reinterpret_cast<float2*>(proj.out[p] + (size_t)r_lo * N + col) = make_float2(acc[p][j][0] * s.x, acc[p][j][1] * s.y);
        if (ok_hi) *reinterpret_cast<float2*>(proj.out[p] + (size_t)r_hi * N + col) = make_float2(acc[p][j][2] * s.x, acc[p][j][3] * s.y);
      }
  }
}

template <int P>
int launch(const void* xs, Projections proj, const void* active, const void* starts, const void* sizes,
           int R, int K, int N, int E, int A, int G, int bits, cudaStream_t st) {
  if (R < 0 || K <= 0 || N <= 0 || N % 8 || E <= 0 || A < 0) return (int)cudaErrorInvalidValue;
  if (bits == 4 ? (G <= 0 || G % 32 || K % G) : (bits != 8 || K % 64)) return (int)cudaErrorInvalidValue;
  for (int p = 0; p < P; ++p) {
    const cudaError_t err = cudaMemsetAsync(proj.out[p], 0, (size_t)R * N * sizeof(float), st);
    if (err != cudaSuccess) return (int)err;
  }
  if (R == 0 || A == 0) return (int)cudaGetLastError();
  const dim3 grid(A, (N + kBlockN - 1) / kBlockN);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
#define SCALELLM_MOE_QUANT_LAUNCH(BITS, KL)                                                   \
  moe_quant_kernel<BITS, KL, P><<<grid, kThreads, 0, st>>>(                                   \
      static_cast<const bf16*>(xs), proj, static_cast<const int*>(active),                    \
      static_cast<const int*>(starts), static_cast<const int*>(sizes), R, K, N, E, G)
  if (bits == 8) SCALELLM_MOE_QUANT_LAUNCH(8, 16);
  else if (G % 128 == 0) SCALELLM_MOE_QUANT_LAUNCH(4, 32);
  else SCALELLM_MOE_QUANT_LAUNCH(4, 8);
#undef SCALELLM_MOE_QUANT_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each zeroes its outputs and
// launches on `stream`, returns cudaGetLastError() (0 on success), and
// neither synchronises nor allocates. G is the int4 group size (ignored for
// bits = 8); A the number of active slots.
extern "C" int scalellm_moe_quant_decode(const void* xs, const void* qweight, const void* scales,
                                         const void* active, const void* starts, const void* sizes,
                                         void* out, int R, int K, int N, int E, int A, int G, int bits,
                                         void* stream) {
  Projections proj = {{static_cast<const uint8_t*>(qweight), nullptr}, {scales, nullptr},
                      {static_cast<float*>(out), nullptr}};
  return launch<1>(xs, proj, active, starts, sizes, R, K, N, E, A, G, bits,
                   reinterpret_cast<cudaStream_t>(stream));
}

extern "C" int scalellm_moe_quant_decode_pair(const void* xs, const void* qweight_gate,
                                              const void* scales_gate, const void* qweight_up,
                                              const void* scales_up, const void* active,
                                              const void* starts, const void* sizes, void* out_gate,
                                              void* out_up, int R, int K, int N, int E, int A, int G,
                                              int bits, void* stream) {
  Projections proj = {{static_cast<const uint8_t*>(qweight_gate), static_cast<const uint8_t*>(qweight_up)},
                      {scales_gate, scales_up},
                      {static_cast<float*>(out_gate), static_cast<float*>(out_up)}};
  return launch<2>(xs, proj, active, starts, sizes, R, K, N, E, A, G, bits,
                   reinterpret_cast<cudaStream_t>(stream));
}
