// Grouped GEMM for Hopper (sm_90a): expert-sorted bf16 rows times each
// row's expert weights, f32 out, bf16 tensor-core products (mma.sync
// m16n8k16) with f32 accumulation.
//
// Replaces the stock megablox `gmm` Pallas kernel that
// scalellm_tpu/layers/moe.py:_grouped_matmul calls on a TPU (K6; the routed
// experts of every MoE layer). Plain PyTorch version:
// scalellm_tpu_torch/ops/grouped_matmul.py:plain_grouped_matmul. Contract:
//   - xs [R, K] bf16, rows sorted by expert: rows [off_e, off_e + sizes[e])
//     belong to expert e, off_e = sizes[0] + ... + sizes[e - 1];
//   - w [E, N, K] bf16, each expert's [K -> N] weight in torch's [out, in]
//     layout (K contiguous: the mma "col" B operand as it lies);
//   - group_sizes i32[E] on the device (no host sync to plan the launch);
//   - out [R, N] f32. Rows at or past sum(sizes) are not written (the
//     caller masks them) and never read.
//
// What bounds it on an H100: the weight bytes of the experts that have rows,
// about 5.8 MB per expert and projection at DeepSeek-V2-Lite's widths. At
// decode (a step of 8 tokens padded to 16, x 6 experts = 96 rows) some 40 of
// the 64 experts have rows; at prefill (3072 rows) all of them, and the
// flops (0.018 ms) stay below the bytes (0.11 ms) as long as each weight
// tile is reused across an expert's rows.
//
// Design: a device-side schedule like megablox's group metadata. The grid's
// x dimension is an upper bound on the number of row tiles, ceil(R / BM) +
// min(E, R): block x walks group_sizes to find the x-th tile, which lies
// inside one expert (a tile never straddles two experts: it is split at the
// expert boundary and its rows past the boundary are masked). Blocks past
// the last tile exit at once, and an expert with no rows owns no tile, so
// its weights are never loaded. The y dimension covers N in 128 columns.
//   - BM = 16 rows (one m16 tile) when rows are sparse (decode), 64 rows
//     (four m16 tiles sharing each weight fragment) when the average expert
//     has 32 rows or more (prefill);
//   - 4 warps, each 32 output columns (four n8 tiles), walking K in steps of
//     32 with the next step's fragments loaded while this one multiplies;
//   - fragments come straight from global memory as 16-byte loads: lane
//     (g, c) loads 8 consecutive k of its row (A) or column (B). Within a
//     32-wide k step both operands use the same permutation of k (physical
//     k 8c + 0..3 is logical 2c, 2c + 1, 2c + 8, 2c + 9 of the first k16
//     step, 8c + 4..7 the same of the second), so the dot product is
//     unchanged and no shared memory or shuffle is needed.
//
// Known limits, later work: no shared-memory staging or TMA, so each block
// re-reads its rows of xs (from L2), and mma.sync instead of wgmma; needs
// K % 32 == 0 and N % 8 == 0 (the wrapper refuses the rest).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // 4 warps
constexpr int kBlockN = 128;    // output columns per block
constexpr int kWarpN = 32;      // output columns per warp: four n8 tiles
constexpr int kStepK = 32;      // k per step: two k16 mma steps

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint4 load16(const __nv_bfloat16* p, bool valid) {
  return valid ? __ldg(reinterpret_cast<const uint4*>(p)) : make_uint4(0u, 0u, 0u, 0u);
}

template <int MT>  // m16 tiles per block: BM = 16 * MT
__global__ void __launch_bounds__(kThreads)
grouped_matmul_kernel(const __nv_bfloat16* __restrict__ xs,   // [R, K]
                      const __nv_bfloat16* __restrict__ w,    // [E, N, K]
                      const int* __restrict__ group_sizes,    // [E]
                      float* __restrict__ out,                // [R, N]
                      int R, int K, int N, int E) {
  constexpr int BM = 16 * MT;
  __shared__ int tile[3];  // expert, first row, end row
  if (threadIdx.x == 0) {
    int expert = -1, row0 = 0, row_end = 0;
    int seen = 0, offset = 0;
    for (int e = 0; e < E; ++e) {
      const int size = max(group_sizes[e], 0);
      const int n = (size + BM - 1) / BM;
      if ((int)blockIdx.x < seen + n) {
        expert = e;
        row0 = offset + ((int)blockIdx.x - seen) * BM;
        row_end = min(min(offset + size, row0 + BM), R);
        break;
      }
      seen += n;
      offset += size;
    }
    tile[0] = expert;
    tile[1] = row0;
    tile[2] = row_end;
  }
  __syncthreads();
  const int expert = tile[0], row0 = tile[1], row_end = tile[2];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_warp = blockIdx.y * kBlockN + warp * kWarpN;
  if (expert < 0 || row0 >= row_end || n_warp >= N) return;  // no barrier follows

  const int g = lane / 4, c = lane % 4;
  const __nv_bfloat16* a_ptr[MT][2];
  bool a_ok[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + i * 16 + h * 8 + g;
      a_ok[i][h] = r < row_end;
      a_ptr[i][h] = xs + (size_t)(a_ok[i][h] ? r : row0) * K + c * 8;
    }
  const __nv_bfloat16* w_exp = w + (size_t)expert * N * K;
  const __nv_bfloat16* b_ptr[4];
  bool b_ok[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n_warp + j * 8 + g;
    b_ok[j] = n < N;
    b_ptr[j] = w_exp + (size_t)(b_ok[j] ? n : n_warp) * K + c * 8;
  }

  float acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  uint4 a[MT][2], b[4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) a[i][h] = load16(a_ptr[i][h], a_ok[i][h]);
#pragma unroll
  for (int j = 0; j < 4; ++j) b[j] = load16(b_ptr[j], b_ok[j]);

  for (int k0 = 0; k0 < K; k0 += kStepK) {
    // The next step's fragments are in flight during this step's products.
    uint4 a_next[MT][2], b_next[4];
    const bool more = k0 + kStepK < K;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) a_next[i][h] = load16(a_ptr[i][h] + k0 + kStepK, more && a_ok[i][h]);
#pragma unroll
    for (int j = 0; j < 4; ++j) b_next[j] = load16(b_ptr[j] + k0 + kStepK, more && b_ok[j]);

#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // k16 step 0: physical k 8c + 0..3; step 1: 8c + 4..7.
        mma_bf16(acc[i][j], a[i][0].x, a[i][1].x, a[i][0].y, a[i][1].y, b[j].x, b[j].y);
        mma_bf16(acc[i][j], a[i][0].z, a[i][1].z, a[i][0].w, a[i][1].w, b[j].z, b[j].w);
      }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) a[i][h] = a_next[i][h];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = b_next[j];
  }

#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!a_ok[i][h]) continue;
      float* o = out + (size_t)(row0 + i * 16 + h * 8 + g) * N;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n_warp + j * 8 + 2 * c;
        if (n < N) *reinterpret_cast<float2*>(o + n) = make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
}

}  // namespace

// Plain C entry point, loaded with ctypes. m_tiles (1 or 4) picks the row
// tile; launches on `stream` and returns a CUDA error code (0 on success);
// it never synchronises.
extern "C" int scalellm_grouped_matmul(const void* xs, const void* w, const void* group_sizes,
                                       void* out, int R, int K, int N, int E, int m_tiles,
                                       void* stream) {
  if (R == 0 || N == 0) return 0;
  if (K <= 0 || K % kStepK || N % 8 || E <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int bm = 16 * m_tiles;
  const dim3 grid((R + bm - 1) / bm + (E < R ? E : R), (N + kBlockN - 1) / kBlockN);
#define SCALELLM_GMM_LAUNCH(MT)                                                         \
  grouped_matmul_kernel<MT><<<grid, kThreads, 0, st>>>(                                 \
      static_cast<const __nv_bfloat16*>(xs), static_cast<const __nv_bfloat16*>(w),      \
      static_cast<const int*>(group_sizes), static_cast<float*>(out), R, K, N, E)
  switch (m_tiles) {
    case 1: SCALELLM_GMM_LAUNCH(1); break;
    case 4: SCALELLM_GMM_LAUNCH(4); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef SCALELLM_GMM_LAUNCH
  return (int)cudaGetLastError();
}
