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
//   int4: per span of K (128 where G % 128 == 0, so one group at G = 128;
//     else 32) a bf16 x bf16 dot with f32 sums (the nibbles are exact in
//     bf16), times the span's group's bf16 scale, added in span order;
//   int8: the bf16 x bf16(q) dot over all of K (its 128-K spans added in
//     order), times the channel's f32 scale.
// The pair entry point (K8) does this for gate and up in one launch.
//
// What bounds it on an H100: the bytes of the active experts' weights, read
// once. At DeepSeek-V2-Lite's decode step (8 sequences padded to 16 tokens,
// 6 experts each: 96 rows, about 40 of the 64 experts active) the int4 gate
// and up weights of an active expert are 2 x 1.44 MB and its scales 2 x 45
// KB: about 119 MB a K8 call, 0.036 ms at 3.35 TB/s; down about 62 MB,
// 0.019 ms. The flops (2 x 96 x 2048 x 1408 a projection) are 0.0006 ms.
// At T=1 (one token, 6 experts) K8 reads 17-35 MB, 5-10 us of memory
// time, so the launch's fixed costs (the first loads' latency, the ring's
// fill) weigh as much as the stream.
//
// Design: the small-M mainloop of quant_small_m.cuh, one expert at a time.
//   - the transposed product out^T[rows of W_e, tokens of e] = W_e x_e^T:
//     the expert's weight rows are the 16-row mma.sync A operand, unpacked
//     in registers (int4: unpack_int4_step; int8: int8_step, no converts),
//     the expert's rows of xs the n = 8 B operand, so each weight is read
//     from device memory once a call and a T=1 call wastes no A rows;
//   - a work item is (active slot, projection, 128 weight rows): 8 row
//     warps and a producer warp that feeds a TMA ring (up to 8 stages of
//     256 bytes of each weight row: two 128-byte boxes of one row run
//     stream faster on an H100 than one, or than three). One 2-D tensor map
//     a projection over [E N, K bytes]: the item's rows start at e N, read
//     on the device from active[slot]. x is one 3-D box a stage starting at
//     the expert's first row: 8 NT rows (NT = 1 where R <= 8, else 2),
//     zero-filled past R; rows of another expert inside the box are
//     computed and not stored. An expert with more rows walks them in
//     boxes of 8 NT, its weights read again (from L2). The scales are read
//     by the consumers after the producer's L2 prefetch;
//   - the grid is one block an item up to two blocks an SM, then two an SM
//     that walk the items with a stride, streaming them through one ring
//     (the next item's stages load while the last one's are multiplied): at
//     the decode step 64 slots x 22 items (K8), of which about 37 x 22 have
//     rows. An item whose slot is -1, or whose expert has no rows, is
//     skipped before any load, a block with no item exits. No host sync:
//     the grid comes from shapes (A, N). At T=1 K8 has 132 items, K7 96
//     (96-row items, which would give K7 132 blocks, were no faster);
//   - gate and up are items of one grid; each reads the expert's rows of xs
//     from L2 (a few KB), never from device memory per projection;
//   - every warp owns its rows over all of K (no K slices): the folds follow
//     the span order alone, and no atomics, so the same bits on every call;
//   - rows outside every active expert's group are zeroed by the blocks of
//     slot 0's items (each its own columns), in the same launch: no memset
//     (two memsets cost a K8 call at T=1 about 7 us).
//
// Limits: int4 needs G % 32 == 0, int8 K % 64 == 0 (K % 16 for TMA's
// 16-byte rows; a last chunk past K reads zeros), N % 8 == 0, 16-byte
// aligned operands (the wrapper refuses the rest).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "quant_small_m.cuh"

namespace {

using scalellm_quant::kSmChunkK;
using scalellm_quant::kSmThreads;
using scalellm_quant::kSmWarps;
using scalellm_quant::piece_map;
using scalellm_quant::sm_consume;
using scalellm_quant::sm_produce;
using scalellm_quant::sm_ring;
using scalellm_quant::sm_smem_bytes;
using scalellm_quant::sm_stage;
using scalellm_quant::sm_stages;
using scalellm_quant::SmJob;
using scalellm_quant::SmRing;
using scalellm_quant::SmStage;
using scalellm_quant::tensor_map;

typedef __nv_bfloat16 bf16;

constexpr int kRowWarps = kSmWarps;  // 8 row warps: 128 weight rows a work item
constexpr int kWide = 2;             // a stage holds 256 bytes of each weight row (two 128-byte boxes)

// The weights, scales and outputs of one launch: gate and up for the pair.
struct Projections {
  const uint8_t* qweight[2];
  const void* scales[2];
  float* out[2];
};

// Rows of out no active expert owns, zeroed in columns [c0, c1) of each
// projection: a warp a row, its lanes testing the active slots.
__device__ __forceinline__ void zero_uncovered(const Projections& proj, int P, const int* active,
                                               const int* starts, const int* sizes, int R, int N, int E,
                                               int A, int c0, int c1) {
  const int warps = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < R; r += warps) {
    bool covered = false;
    for (int a = lane; a < A; a += 32) {
      const int e = active[a];
      if (e >= 0 && e < E) covered |= r >= starts[e] && r < starts[e] + max(sizes[e], 0);
    }
    if (__any_sync(0xffffffffu, covered)) continue;
    for (int p = 0; p < P; ++p)
      for (int c = c0 + lane; c < c1; c += 32) proj.out[p][(size_t)r * N + c] = 0.f;
  }
}

// One work item of a launch: rows [n0, n0 + 2 rh) of projection p of the
// expert in slot `slot`; false where the slot is -1 or the expert has no
// rows in [0, R).
struct Item {
  int p, n0, e, row_begin, row_end;
};

__device__ __forceinline__ bool item_of(int i, int nb, int P, int rh, const int* active, const int* starts,
                                        const int* sizes, int R, int E, Item& it) {
  const int slot = i / (nb * P);
  it.p = (i / nb) % P;
  it.n0 = (i % nb) * 2 * rh;
  it.e = active[slot];
  if (it.e < 0 || it.e >= E) return false;
  it.row_begin = max(starts[it.e], 0);
  it.row_end = min(starts[it.e] + max(sizes[it.e], 0), R);
  return it.row_begin < it.row_end;
}

// A block takes items blockIdx.x, + gridDim.x, ... through one ring; for
// each, each box of 8 NT token rows over all of K. 8 row warps (the
// consumers), then the producer warp.
template <int BITS, int NT, bool SPAN32>
__global__ void __launch_bounds__(kSmThreads, 2) moe_quant_kernel(
    const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap w_map0,
    const __grid_constant__ CUtensorMap w_map1, Projections proj, const int* __restrict__ active,
    const int* __restrict__ starts, const int* __restrict__ sizes, int R, int K, int N, int E, int A, int G,
    int P, int stages, int slot_bytes) {
  extern __shared__ uint8_t smem_raw[];
  constexpr int rw = kRowWarps, rh = 8 * rw;
  const int nb = (N + 2 * rh - 1) / (2 * rh), items = A * P * nb;
  // Slot 0's items of projection 0 zero the rows no active expert owns.
  for (int i = blockIdx.x; i < nb; i += gridDim.x)
    zero_uncovered(proj, P, active, starts, sizes, R, N, E, A, i * 2 * rh, min((i + 1) * 2 * rh, N));
  Item it;
  int i0 = blockIdx.x;
  while (i0 < items && !item_of(i0, nb, P, rh, active, starts, sizes, R, E, it)) i0 += gridDim.x;
  if (i0 >= items) return;  // block-uniform: no barrier has been passed

  const SmRing ring = sm_ring(smem_raw, stages, slot_bytes, rw);
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0), lane = threadIdx.x & 31;
  constexpr int kBox = 8 * NT;  // token rows of an x box
  SmJob j;
  j.xmap = &x_map;
  j.xsmap = nullptr;
  j.zeros = nullptr;
  j.ld = N;
  j.K = K;
  j.G = BITS == 4 ? G : K;
  j.span = SPAN32 ? 32 : 128;
  j.parts = 1;
  j.rw = rw;
  j.ks = 1;
  j.st = sm_stage(BITS, NT, rw, 1, j.span, 1, kWide);
  // The item's rows and weights; int4's [K / G, N] scales of the expert
  // (int8: none in the loop, the channel scale multiplies the whole-K sum).
  auto job = [&](const Item& t) {
    j.wmap = t.p ? &w_map1 : &w_map0;
    j.scales = BITS == 4 ? static_cast<const void*>(static_cast<const bf16*>(proj.scales[t.p]) +
                                                    (size_t)t.e * (K / G) * N)
                         : nullptr;
    j.row_a = t.n0;
    j.row_b = t.n0 + rh;
    j.valid_a = max(0, min(rh, N - j.row_a));
    j.valid_b = max(0, min(rh, N - j.row_b));
    j.w_row0 = t.e * N;
  };
  int g = 0;  // the block's running ring stage, the same in producer and consumers
  if (warp == rw) {  // the producer warp
    for (int i = i0; i < items; i += gridDim.x) {
      if (!item_of(i, nb, P, rh, active, starts, sizes, R, E, it)) continue;
      job(it);
      for (int r0 = it.row_begin; r0 < it.row_end; r0 += kBox) {
        j.x_row = r0;
        sm_produce<NT, BITS>(j, ring.ring, slot_bytes, stages, ring.full, ring.empty, g, kBox, 1, lane);
      }
    }
    return;
  }
  const int r = 8 * warp + (lane >> 2), tig = lane & 3;  // this thread's row of each half
  float acc[NT][4];
  for (int i = i0; i < items; i += gridDim.x) {
    if (!item_of(i, nb, P, rh, active, starts, sizes, R, E, it)) continue;
    job(it);
    const bool ok_a = r < j.valid_a, ok_b = r < j.valid_b;
    float s_a = 1.f, s_b = 1.f;
    if (BITS == 8) {
      const float* sc = static_cast<const float*>(proj.scales[it.p]) + (size_t)it.e * N;
      if (ok_a) s_a = sc[j.row_a + r];
      if (ok_b) s_b = sc[j.row_b + r];
    }
    float* out = proj.out[it.p];
    for (int r0 = it.row_begin; r0 < it.row_end; r0 += kBox) {
      j.x_row = r0;
      sm_consume<NT, BITS, SPAN32>(j, ring.ring, slot_bytes, stages, ring.full, ring.empty, g, kBox, warp, lane,
                                   1, acc);
      // acc[n][e]: row a's token 8 n + 2 tig + e of the box, acc[n][2 + e]: row b's.
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int t = r0 + 8 * n + 2 * tig + q;
          if (t >= it.row_end) continue;
          if (ok_a) out[(size_t)t * N + j.row_a + r] = acc[n][q] * s_a;
          if (ok_b) out[(size_t)t * N + j.row_b + r] = acc[n][2 + q] * s_b;
        }
    }
  }
}

template <int BITS, int NT, bool SPAN32>
int launch_moe(const void* xs, Projections proj, int P, const void* active, const void* starts, const void* sizes,
               int R, int K, int N, int E, int A, int G, cudaStream_t st) {
  const auto kernel = moe_quant_kernel<BITS, NT, SPAN32>;
  const SmStage s = sm_stage(BITS, NT, kRowWarps, 1, SPAN32 ? 32 : 128, 1, kWide);
  const long long items = (long long)A * P * ((N + 2 * s.rh - 1) / (2 * s.rh));
  const int sms = scalellm_quant::sm_count();
  const long long blocks = sms > 0 && items > 2LL * sms ? 2LL * sms : items;
  const int stages = sm_stages(s.bytes, 0, 2);
  static bool smem_set = false;  // once per instantiation
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  // x: the stage's pieces of [8 NT rows, xk K] in one box; weights: [rh
  // rows, 128 bytes] of the stacked [E N, K bytes], 128-byte swizzle.
  CUtensorMap x_map, w_map[2];
  if (!piece_map(&x_map, xs, R, K, s.xk, 8 * NT, kSmChunkK * s.cps / s.xk)) return (int)cudaErrorInvalidValue;
  for (int p = 0; p < 2; ++p)
    if (!tensor_map(&w_map[p], proj.qweight[p < P ? p : 0], CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, E * N, K * BITS / 8,
                    s.rh, 128, CU_TENSOR_MAP_SWIZZLE_128B))
      return (int)cudaErrorInvalidValue;
  if (items > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kSmThreads, sm_smem_bytes(stages, s.bytes, 0), st>>>(
      x_map, w_map[0], w_map[1], proj, static_cast<const int*>(active), static_cast<const int*>(starts),
      static_cast<const int*>(sizes), R, K, N, E, A, G, P, stages, s.bytes);
  return (int)cudaGetLastError();
}

int launch(const void* xs, Projections proj, int P, const void* active, const void* starts, const void* sizes,
           int R, int K, int N, int E, int A, int G, int bits, cudaStream_t st) {
  if (R < 0 || K <= 0 || N <= 0 || N % 8 || E <= 0 || A < 0) return (int)cudaErrorInvalidValue;
  if (bits == 4 ? (G <= 0 || G % 32 || K % G) : (bits != 8 || K % 64)) return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaGetLastError();
  if (A == 0) {  // no slot, so no block to zero the rows
    for (int p = 0; p < P; ++p) {
      const cudaError_t err = cudaMemsetAsync(proj.out[p], 0, (size_t)R * N * sizeof(float), st);
      if (err != cudaSuccess) return (int)err;
    }
    return (int)cudaGetLastError();
  }
#define SCALELLM_MOE_LAUNCH(BITS, NT, SPAN32) \
  return launch_moe<BITS, NT, SPAN32>(xs, proj, P, active, starts, sizes, R, K, N, E, A, G, st)
  const bool two = R > 8;  // NT = 2: the decode step's experts of up to 16 rows in one box
  if (bits == 8) {
    if (two) SCALELLM_MOE_LAUNCH(8, 2, false);
    SCALELLM_MOE_LAUNCH(8, 1, false);
  }
  if (G % 128 == 0) {
    if (two) SCALELLM_MOE_LAUNCH(4, 2, false);
    SCALELLM_MOE_LAUNCH(4, 1, false);
  }
  if (two) SCALELLM_MOE_LAUNCH(4, 2, true);
  SCALELLM_MOE_LAUNCH(4, 1, true);
#undef SCALELLM_MOE_LAUNCH
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each writes every row of its
// outputs (0 outside every active expert's group) and launches on `stream`,
// returns cudaGetLastError() (0 on success), and neither synchronises nor
// allocates. G is the int4 group size (ignored for bits = 8); A the number
// of active slots.
extern "C" int scalellm_moe_quant_decode(const void* xs, const void* qweight, const void* scales,
                                         const void* active, const void* starts, const void* sizes,
                                         void* out, int R, int K, int N, int E, int A, int G, int bits,
                                         void* stream) {
  Projections proj = {{static_cast<const uint8_t*>(qweight), nullptr}, {scales, nullptr},
                      {static_cast<float*>(out), nullptr}};
  return launch(xs, proj, 1, active, starts, sizes, R, K, N, E, A, G, bits, reinterpret_cast<cudaStream_t>(stream));
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
  return launch(xs, proj, 2, active, starts, sizes, R, K, N, E, A, G, bits, reinterpret_cast<cudaStream_t>(stream));
}
