// Grouped GEMM for Hopper (sm_90a): expert-sorted bf16 rows times each
// row's expert weights, f32 out, bf16 tensor-core products (wgmma) with f32
// accumulation.
//
// Replaces the stock megablox `gmm` Pallas kernel that
// scalellm_tpu/layers/moe.py:_grouped_matmul calls on a TPU (K6; the routed
// experts of every MoE layer, and of the quantized ones on steps too large
// for the decode kernels, after expert_dequant.cu). Plain PyTorch version:
// scalellm_tpu_torch/ops/grouped_matmul.py:plain_grouped_matmul. Contract:
//   - xs [R, K] bf16, rows sorted by expert: rows [off_e, off_e + sizes[e])
//     belong to expert e, off_e = sizes[0] + ... + sizes[e - 1];
//   - w [E, N, K] bf16, each expert's [K -> N] weight in torch's [out, in]
//     layout (K contiguous);
//   - group_sizes i32[E] on the device (no host sync to plan the launch);
//   - out [R, N] f32. Rows at or past sum(sizes) are not written (the
//     caller masks them) and never read.
//
// What bounds it on an H100: the weight bytes of the experts that have rows,
// 5.8 MB per expert and projection at DeepSeek-V2-Lite's widths, read once.
// At decode (a step of 8 tokens padded to 16, x 6 experts = 96 rows) some 40
// of the 64 experts have rows: 231 MB, 0.069 ms at 3.35 TB/s; at prefill
// (3072 rows) all 64, 0.11 ms, against 0.018 ms of tensor work at 989
// TFLOP/s, as long as each weight tile is multiplied with all of its
// expert's rows while it is on chip.
//
// Design: the transposed product out^T[rows of W_e, tokens of e] = W_e
// x_e^T with wgmma (both operands from shared memory), so that the weights
// are the 64-row A operand and an expert's few tokens the narrow B operand:
//   - a work item is (token tile of one expert, 64 WGS weight rows): a
//     token tile is BT rows of xs from the expert's first row (the block
//     shape picked by the wrapper from R / E alone: 64 x 16 at decode, 128
//     x 64 at prefill), so an expert of 1-3 decode rows costs one 16-token
//     tile and its weights cross device memory once; the tile's x box also
//     reads the next expert's rows, or zeros past R, whose outputs are
//     never stored;
//   - the schedule is read from group_sizes on the device by one warp (a
//     prefix sum of rows, then of tiles, into shared memory); an item finds
//     its expert by a binary search there. Items are ordered token tile
//     major, so an expert's second token tile follows its first by one row
//     of weight tiles and finds them in L2;
//   - a persistent grid (from R, N, E and the SM count: no host sync; 3
//     blocks an SM of one consumer warpgroup, or one of two) whose blocks
//     walk the items with a stride through one TMA ring: one producer
//     thread loads each 128-K stage as two 64-K boxes of weights ([64 WGS,
//     64] of a [E N, K] tensor map at row e N + n0) and two of x ([BT,
//     64]), all with the 128-byte swizzle that the wgmma descriptors read,
//     the weights marked evict-first in L2 and x evict-last (xs is read
//     again by every weight tile); full/empty mbarriers; the consumer
//     warpgroups each issue eight m64nBTk16 wgmma a stage and wait for
//     them (no branch between fence and wait: ptxas serializes a wgmma on a
//     path it takes for divergent, so every value that steers the loop is
//     broadcast by __shfl_sync). The next item's stages load while the
//     last one's epilogue runs. In diagnostic runs on an H100 (PERF.md, PR
//     11) two boxes a stage and the eviction hints were each faster than
//     without, and keeping one stage's products in flight (wait_group 1)
//     was not;
//   - the epilogue goes through shared memory (a [BT][64] f32 tile a
//     warpgroup), then 16-byte stores of whole output rows; a token row is
//     stored only if it lies inside the item's expert (a row past it
//     belongs to another expert's item).
// No split-K and no atomics: the same bits on every call. Needs K % 32 == 0
// and N % 8 == 0 (the wrapper refuses the rest; TMA zero-fills the last
// stage past K in both operands) and 16-byte aligned operands.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "quant_small_m.cuh"

namespace {

using scalellm_quant::fence_regs;
using scalellm_quant::mbar_arrive;
using scalellm_quant::mbar_arrive_expect_tx;
using scalellm_quant::mbar_init;
using scalellm_quant::mbar_wait;
using scalellm_quant::sm_count;
using scalellm_quant::smem_addr;
using scalellm_quant::sw128_desc;
using scalellm_quant::tensor_map;
using scalellm_quant::wgmma_commit;
using scalellm_quant::wgmma_fence;
using scalellm_quant::wgmma_wait;

constexpr int kBK = 64;     // K per box: one 128-byte row of a tile (the swizzle atom)
constexpr int kBoxes = 2;   // boxes a stage: 256 bytes of each weight row (faster than 128 on an H100)
constexpr int kStageK = kBK * kBoxes;
constexpr int kMaxStages = 8;
constexpr int kOutLd = 68;                 // f32 stride of a warpgroup's epilogue tile: conflict-free stores
constexpr int kSmemPerSm = 228 * 1024;     // an SM's shared memory, 1 KB of it reserved per block
constexpr int kSmemPerBlock = 227 * 1024;  // the most one block may have

// TMA with an L2 eviction policy (createpolicy): the box at (c0, c1) of a
// 2-D tensor map into shared memory, completion counted in bytes on `bar`.
__device__ __forceinline__ void tma_load_2d_hint(void* dst, const CUtensorMap* map, int c0, int c1, uint64_t* bar,
                                                 uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint [%0], [%1, {%2, "
      "%3}], [%4], %5;\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_addr(bar)), "l"(policy)
      : "memory");
}


// The accumulator operands of a wgmma, 8 at a time.
#define SCALELLM_D8(d, i)                                                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), \
      "+f"(d[i + 7])
#define SCALELLM_D32(d) SCALELLM_D8(d, 0), SCALELLM_D8(d, 8), SCALELLM_D8(d, 16), SCALELLM_D8(d, 24)

// D[64 x BT] (+)= A[64 x 16] B[16 x BT], both from shared memory through
// descriptors (K-major, no transpose); scale_d 0 starts the sum at 0.
__device__ __forceinline__ void wgmma_n16(float (&d)[8], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : SCALELLM_D8(d, 0)
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : SCALELLM_D32(d)
      : "l"(a), "l"(b), "r"(scale_d));
}

template <int BT>
__device__ __forceinline__ void wgmma_tokens(float (&d)[BT / 2], uint64_t a, uint64_t b, int scale_d) {
  if constexpr (BT == 16) wgmma_n16(d, a, b, scale_d);
  else wgmma_n64(d, a, b, scale_d);
}

// A block: WGS consumer warpgroups of 64 weight rows each, one producer
// warp; BT tokens a work item; kPerSm blocks an SM.
template <int WGS, int BT>
struct GmmShape {
  static constexpr int kRows = 64 * WGS;
  static constexpr int kConsumers = 128 * WGS;
  static constexpr int kThreads = kConsumers + 32;
  static constexpr int kWBox = kRows * 128;       // a box of weights: kRows x 64 K
  static constexpr int kXBox = BT * 128;          // a box of x: BT x 64 K
  static constexpr int kWBytes = kBoxes * kWBox;  // a stage's weights
  static constexpr int kXBytes = kBoxes * kXBox;  // a stage's x
  static constexpr int kStageBytes = (kWBytes + kXBytes + 1023) / 1024 * 1024;
  static constexpr int kOutBytes = WGS * BT * kOutLd * 4;
  static constexpr int kPerSm = WGS == 1 ? 3 : 1;
};

// The block's schedule in shared memory, from group_sizes, by one warp:
// row_first[e] = min(off_e, R) (row_first[E] = min(sum, R)), and
// tile_first[e] = the number of BT-row tiles of the experts before e
// (tile_first[E] = all of them). Sizes below 0 count as 0. Each lane takes
// ceil(E / 32) consecutive experts; two warp prefix sums.
__device__ __forceinline__ void schedule(const int* __restrict__ sizes, int R, int E, int bt, int* row_first,
                                         int* tile_first, int lane) {
  const int per = (E + 31) / 32, e0 = min(lane * per, E), e1 = min(e0 + per, E);
  long long rows = 0;
  for (int e = e0; e < e1; ++e) rows += max(sizes[e], 0);
  long long inc = rows;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long v = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += v;
  }
  long long off = inc - rows;
  int tiles = 0;
  for (int e = e0; e < e1; ++e) {
    const int r0 = (int)min(off, (long long)R);
    off += max(sizes[e], 0);
    const int r1 = (int)min(off, (long long)R);
    row_first[e] = r0;
    tile_first[e] = tiles;
    tiles += (r1 - r0 + bt - 1) / bt;
  }
  int tinc = tiles;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, tinc, o);
    if (lane >= o) tinc += v;
  }
  for (int e = e0; e < e1; ++e) tile_first[e] += tinc - tiles;
  if (lane == 31) {
    row_first[E] = (int)min(inc, (long long)R);
    tile_first[E] = tinc;
  }
}

// Work item i: token tile t = i / n_tiles (of expert e: its rows [row0,
// row_end)) times weight rows [n0, n0 + rows) of that expert.
struct Item {
  int e, row0, row_end, n0;
};

__device__ __forceinline__ Item item_at(int i, int n_tiles, int rows, int bt, const int* row_first,
                                        const int* tile_first, int E) {
  const int t = i / n_tiles;
  int lo = 0, hi = E;  // tile_first[lo] <= t < tile_first[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (tile_first[mid] <= t) lo = mid;
    else hi = mid;
  }
  Item it;
  it.e = lo;
  it.row0 = row_first[lo] + (t - tile_first[lo]) * bt;
  it.row_end = min(row_first[lo + 1], it.row0 + bt);
  it.n0 = (i - t * n_tiles) * rows;
  return it;
}

// The item as lane 0 sees it, so that the compiler knows every field to be
// warp-uniform (the consumers' loops steer wgmma).
__device__ __forceinline__ Item uniform(Item it) {
  it.e = __shfl_sync(0xffffffffu, it.e, 0);
  it.row0 = __shfl_sync(0xffffffffu, it.row0, 0);
  it.row_end = __shfl_sync(0xffffffffu, it.row_end, 0);
  it.n0 = __shfl_sync(0xffffffffu, it.n0, 0);
  return it;
}

template <int WGS, int BT>
__global__ void __launch_bounds__(GmmShape<WGS, BT>::kThreads, GmmShape<WGS, BT>::kPerSm) grouped_matmul_kernel(
    const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap w_map,
    const int* __restrict__ group_sizes, float* __restrict__ out, int R, int K, int N, int E, int stages) {
  using S = GmmShape<WGS, BT>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);  // 1024-aligned
  float* epi = reinterpret_cast<float*>(ring + (size_t)stages * S::kStageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(epi + WGS * BT * kOutLd);
  uint64_t* empty = full + kMaxStages;
  int* row_first = reinterpret_cast<int*>(empty + kMaxStages);  // [E + 1]
  int* tile_first = row_first + E + 1;                           // [E + 1]

  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0), lane = threadIdx.x & 31;
  if (warp == 0) schedule(group_sizes, R, E, BT, row_first, tile_first, lane);
  if (warp == 1 && lane == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);                 // the producer's expect_tx arrival, then the TMA bytes
      mbar_init(&empty[s], S::kConsumers / 32);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int n_tiles = (N + S::kRows - 1) / S::kRows;
  const int items = __shfl_sync(0xffffffffu, tile_first[E] * n_tiles, 0);
  const int n_kt = (K + kStageK - 1) / kStageK;

  if (warp == S::kConsumers / 32) {  // the producer warp: lane 0 loads every stage of every item
    if (lane != 0) return;
    int g = 0;
    // The weights stream through L2 once (evict first); xs is read again
    // by every weight tile of its token tiles (evict last).
    uint64_t w_pol, x_pol;
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(w_pol));
    asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(x_pol));
    for (int i = blockIdx.x; i < items; i += gridDim.x) {
      const Item it = item_at(i, n_tiles, S::kRows, BT, row_first, tile_first, E);
      for (int kt = 0; kt < n_kt; ++kt, ++g) {
        const int slot = g % stages;
        if (g >= stages) mbar_wait(&empty[slot], (g / stages - 1) & 1);
        uint8_t* st = ring + (size_t)slot * S::kStageBytes;
        mbar_arrive_expect_tx(&full[slot], S::kWBytes + S::kXBytes);
        for (int b = 0; b < kBoxes; ++b) {
          tma_load_2d_hint(st + b * S::kWBox, &w_map, kt * kStageK + b * kBK, it.e * N + it.n0, &full[slot], w_pol);
          tma_load_2d_hint(st + S::kWBytes + b * S::kXBox, &x_map, kt * kStageK + b * kBK, it.row0, &full[slot],
                           x_pol);
        }
      }
    }
    return;
  }

  // The consumers: warpgroup wg owns weight rows [64 wg, 64 wg + 64) of the
  // item; thread (warp w of the group, lane g * 4 + t) holds, in acc[4 q +
  // j], row 16 w + g + 8 (j / 2) for token 8 q + 2 t + j % 2.
  const int wg = warp >> 2, wtid = threadIdx.x & 127;
  const int r_base = 16 * (warp & 3) + (lane >> 2), t_base = 2 * (lane & 3);
  float* os = epi + wg * BT * kOutLd;
  float acc[BT / 2];
#pragma unroll
  for (int i = 0; i < BT / 2; ++i) acc[i] = 0.f;
  int g = 0;
  for (int i = blockIdx.x; i < items; i += gridDim.x) {
    const Item it = uniform(item_at(i, n_tiles, S::kRows, BT, row_first, tile_first, E));
    for (int kt = 0; kt < n_kt; ++kt, ++g) {
      const int slot = g % stages;
      mbar_wait(&full[slot], (g / stages) & 1);
      const uint8_t* st = ring + (size_t)slot * S::kStageBytes;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4 * kBoxes; ++ks)
        wgmma_tokens<BT>(acc, sw128_desc(st + (ks / 4) * S::kWBox + wg * 64 * 128, ks % 4),
                         sw128_desc(st + S::kWBytes + (ks / 4) * S::kXBox, ks % 4), (kt | ks) != 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot]);  // this warp is done with the stage
    }
    // Epilogue: the warpgroup's [BT tokens][64 rows] tile through shared
    // memory (its previous tile has been read by every warp of the group),
    // then 16-byte stores of the token rows that lie inside the expert.
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
#pragma unroll
    for (int q = 0; q < BT / 8; ++q)
#pragma unroll
      for (int j = 0; j < 4; ++j) os[(8 * q + t_base + (j & 1)) * kOutLd + r_base + 8 * (j >> 1)] = acc[4 * q + j];
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    const int tokens = it.row_end - it.row0;
    const int col0 = it.n0 + 64 * wg, cols = min(64, N - col0);
    for (int c = wtid; c < BT * 16; c += 128) {
      const int t = c >> 4, q = (c & 15) * 4;
      if (t < tokens && q < cols)
        *reinterpret_cast<float4*>(out + (size_t)(it.row0 + t) * N + col0 + q) =
            *reinterpret_cast<const float4*>(os + t * kOutLd + q);
    }
  }
}

template <int WGS, int BT>
int launch_shape(const void* xs, const void* w, const void* group_sizes, void* out, int R, int K, int N, int E,
                 cudaStream_t st) {
  using S = GmmShape<WGS, BT>;
  const auto kernel = grouped_matmul_kernel<WGS, BT>;
  // Shared memory: the 1024-byte alignment's slack, the ring, the
  // epilogue tiles, the barriers and the schedule; as many stages as the
  // kPerSm blocks of an SM leave room for.
  const int fixed = 1024 + S::kOutBytes + 2 * kMaxStages * 8 + 2 * (E + 1) * 4;
  const int stages = min(kMaxStages, (kSmemPerSm / S::kPerSm - 1024 - fixed) / S::kStageBytes);
  if (stages < 2) return (int)cudaErrorInvalidValue;  // too many experts for the schedule's shared memory
  const int smem = fixed + stages * S::kStageBytes;
  static bool smem_set = false;  // once per instantiation
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemPerBlock);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  // x: boxes [BT rows, 64 K] of xs; weights: boxes [64 WGS rows, 64 K] of
  // the experts stacked as [E N, K]; both 128-byte swizzled, zeros past the
  // ends.
  CUtensorMap x_map, w_map;
  if (!tensor_map(&x_map, xs, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, R, K, BT, kBK, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map(&w_map, w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, E * N, K, S::kRows, kBK,
                  CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  // At most ceil(R / BT) + min(E, R) token tiles (each expert adds at most
  // one partial tile), each over ceil(N / rows) weight tiles; the grid is
  // that, or kPerSm blocks an SM that walk the items.
  const long long items = ((long long)(R + BT - 1) / BT + (E < R ? E : R)) * ((N + S::kRows - 1) / S::kRows);
  const int sms = sm_count();
  const long long cap = sms > 0 ? (long long)S::kPerSm * sms : items;
  const long long blocks = items < cap ? items : cap;
  kernel<<<(unsigned)blocks, S::kThreads, smem, st>>>(x_map, w_map, static_cast<const int*>(group_sizes),
                                                      static_cast<float*>(out), R, K, N, E, stages);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. `tile` picks the block shape
// (ops/grouped_matmul.py TILES, as (weight rows, tokens)): 0 (64, 16), 1
// (128, 64). Launches on `stream` and returns a
// CUDA error code (0 on success); it never synchronises.
extern "C" int scalellm_grouped_matmul(const void* xs, const void* w, const void* group_sizes, void* out, int R,
                                       int K, int N, int E, int tile, void* stream) {
  if (R == 0 || N == 0) return 0;
  if (R < 0 || K <= 0 || K % 32 || N < 0 || N % 8 || E <= 0 || (long long)E * N > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (tile) {
    case 0: return launch_shape<1, 16>(xs, w, group_sizes, out, R, K, N, E, st);
    case 1: return launch_shape<2, 64>(xs, w, group_sizes, out, R, K, N, E, st);
  }
  return (int)cudaErrorInvalidValue;
}
