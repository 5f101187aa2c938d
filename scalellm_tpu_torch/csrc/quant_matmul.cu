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
//   the depth-3 DMA ring of weight tiles -> w4a8_kernel's ring of registers
//     (16-byte weight loads kW4Prefetch segments ahead of their use) and
//     tile_kernel's loads of the next K tile while the current one is
//     multiplied. A multi-stage cp.async/TMA ring through shared memory is
//     still open;
//   the norm computed once per call, ahead of the streamed tiles ->
//     act_quant_kernel (w4a8) and tile_kernel's prologue (group, dequant).
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
//     xq = clip(rint(x / sx), -127, 127). Per weight group an int8 x int8
//     dot with int32 sums; (dot - xsum * zero) * group scale, summed over
//     the k-block's groups in f32, times sx, summed over k-blocks. M <= 64.
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
// against 4 us of bytes, so operations bound it from M of about 150 up.
//
// Design, simple first:
//   w4a8: a small kernel (one block per row) normalises and quantizes x once
//     into scratch (one pass over x in device memory, the rest from shared
//     memory), writing xq with every 8 consecutive K stored as
//     [k0 k2 k4 k6 k1 k3 k5 k7] so that the main kernel's A fragments are
//     plain 32-bit loads that line up with nibbles unpacked by two masks.
//     The main kernel gives a block 8 output columns; its 4 warps split the
//     weight groups of K between them (the TPU kernel's sequential k grid
//     becomes a loop in the block plus a fixed-order reduction in shared
//     memory), each running mma.sync m16n8k32 s8 on 16-byte weight loads
//     that run a few segments ahead of their use in a ring of registers,
//     together with the group's scales and zero points.
//     int4 nibbles are used as (nibble << 4), i.e. 16 times the value, and
//     the int32 dot is shifted back: no sign-extension arithmetic.
//   group / dequant: one 64 x 64 output tile per block of 4 warps, K walked
//     in tiles of 64 (32 when the group size asks) through shared memory
//     (the next tile is loaded into registers while the current one is
//     multiplied), mma.sync m16n8k16 bf16 fed by ldmatrix. Weights are
//     unpacked (and for dequant scaled) on the way into shared memory; int4
//     nibbles become bf16 pairs by bit placement, without integer-to-float
//     converts. The RMSNorm prologue recomputes each row's mean square in
//     the block (from L2) and normalises x on the way into shared memory.
// Measured limits (H100, chip_smoke.py): a w4a8 call's time at decode is
// the latency chain of one block (its warps walk K in order and wait for
// the activation fragments of every group), not bytes; the tile kernels
// wait for each next tile's loads, one tile ahead. Later work: activation
// fragments through shared memory or a deeper ring, cp.async or TMA rings,
// wgmma, split-K across blocks for narrow N, a pre-shuffled weight layout,
// and an M tile above 64 for prefill.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "quant_act.cuh"
#include "quant_unpack.cuh"

namespace {

using scalellm_quant::act_quant_kernel;
using scalellm_quant::bf16x2_bits;
using scalellm_quant::bf16x2_from_bits;
using scalellm_quant::kActThreads;
using scalellm_quant::load_f32_or_bf16;
using scalellm_quant::mma_bf16;

typedef __nv_bfloat16 bf16;

// ------------------------------------------------------------ w4a8

constexpr int kW4Threads = 128;
constexpr int kW4Warps = kW4Threads / 32;
constexpr int kW4Cols = 8;  // output columns per block (one n8 mma tile)
constexpr int kW4PrefetchInt4 = 4;  // weight loads a warp keeps in flight
constexpr int kW4PrefetchInt8 = 1;  // (a deeper ring costs the int8 kernels their occupancy)

__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// MT: 16-row tiles of M (1, 2 or 4). BITS: 4 or 8.
template <int MT, int BITS>
__global__ void __launch_bounds__(kW4Threads) w4a8_kernel(
    const int8_t* __restrict__ xq, const float* __restrict__ sx, const int* __restrict__ xsum,
    const uint8_t* __restrict__ qw, const void* __restrict__ scales, int scales_bf16,
    const int8_t* __restrict__ zeros, bf16* __restrict__ out,
    int M, int K, int N, int G, int block_k) {
  constexpr int kSegK = BITS == 4 ? 128 : 64;  // K per 64-byte segment of a weight row
  constexpr int kLaneK = kSegK / 4;            // K per lane's 16-byte load
  constexpr int kAVecs = kLaneK / 16;          // 16-byte loads of xq per row and segment
  constexpr int kW4Prefetch = BITS == 4 ? kW4PrefetchInt4 : kW4PrefetchInt8;
  __shared__ float red[kW4Warps][MT * 16][kW4Cols];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int n0 = blockIdx.x * kW4Cols;
  const int n_groups = K / G, n_kb = K / block_k;
  const int segs_per_group = G / kSegK, groups_per_kb = block_k / G;
  const size_t row_bytes = BITS == 4 ? (size_t)K / 2 : (size_t)K;
  const uint8_t* wrow = qw + (size_t)(n0 + gid) * row_bytes + tig * 16;
  const int col = n0 + tig * 2;  // this thread's two C columns: col, col + 1

  float acc[MT][4], tot[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[mt][i] = tot[mt][i] = 0.f;

  auto flush = [&](int kb) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = mt * 16 + gid + h * 8;
        const float s = r < M ? sx[(size_t)r * n_kb + kb] : 0.f;
        acc[mt][2 * h] += tot[mt][2 * h] * s;
        acc[mt][2 * h + 1] += tot[mt][2 * h + 1] * s;
        tot[mt][2 * h] = tot[mt][2 * h + 1] = 0.f;
      }
  };

  // This warp's weight groups are warp, warp + kW4Warps, ...; a group is
  // segs_per_group 64-byte segments of the weight row. The segments' 16-byte
  // loads, and with them the group's scales and zero points (cold in device
  // memory, like the weights), run kW4Prefetch ahead of their use, in a ring
  // of registers.
  const int my_groups = n_groups > warp ? (n_groups - warp + kW4Warps - 1) / kW4Warps : 0;
  const int total = my_groups * segs_per_group;
  auto weight_vec = [&](int g, int s) {
    const int k0 = g * G + s * kSegK;
    return __ldg(reinterpret_cast<const uint4*>(wrow + (BITS == 4 ? k0 / 2 : k0)));
  };
  uint4 ring[kW4Prefetch];
  float ring_s[kW4Prefetch][2];
  int ring_z[kW4Prefetch][2];
  int pg = warp, ps = 0;  // the next segment to load
  auto prefetch = [&](int u) {
    ring[u] = weight_vec(pg, ps);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      ring_s[u][j] = load_f32_or_bf16(scales, (size_t)pg * N + col + j, scales_bf16);
      ring_z[u][j] = zeros != nullptr ? (int)zeros[(size_t)pg * N + col + j] : 0;
    }
    if (++ps == segs_per_group) { ps = 0; pg += kW4Warps; }
  };
#pragma unroll
  for (int u = 0; u < kW4Prefetch; ++u) {
    ring[u] = make_uint4(0, 0, 0, 0);
    ring_s[u][0] = ring_s[u][1] = 0.f;
    ring_z[u][0] = ring_z[u][1] = 0;
    if (u < total) prefetch(u);
  }

  int c[MT][4];
  int cur_kb = -1;
  int g = warp, s = 0;  // the segment in use
  for (int t0 = 0; t0 < total; t0 += kW4Prefetch) {
#pragma unroll
    for (int u = 0; u < kW4Prefetch; ++u) {
      const int t = t0 + u;
      if (t >= total) break;
      if (s == 0) {
        const int kb = g / groups_per_kb;
        if (kb != cur_kb) {
          if (cur_kb >= 0) flush(cur_kb);
          cur_kb = kb;
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int i = 0; i < 4; ++i) c[mt][i] = 0;
      }
      const uint4 wv = ring[u];
      const float s0 = ring_s[u][0], s1 = ring_s[u][1];
      const int z0 = ring_z[u][0], z1 = ring_z[u][1];
      if (t + kW4Prefetch < total) prefetch(u);
      const uint32_t w[4] = {wv.x, wv.y, wv.z, wv.w};
      const int ka = g * G + s * kSegK + tig * kLaneK;  // first K of this lane's weights
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t a_lo[kAVecs * 4], a_hi[kAVecs * 4];  // rows gid and gid + 8
        const int r_lo = mt * 16 + gid, r_hi = r_lo + 8;
#pragma unroll
        for (int v = 0; v < kAVecs; ++v) {
          uint4 lo = make_uint4(0, 0, 0, 0), hi = make_uint4(0, 0, 0, 0);
          if (r_lo < M) lo = __ldg(reinterpret_cast<const uint4*>(xq + (size_t)r_lo * K + ka) + v);
          if (r_hi < M) hi = __ldg(reinterpret_cast<const uint4*>(xq + (size_t)r_hi * K + ka) + v);
          a_lo[4 * v] = lo.x; a_lo[4 * v + 1] = lo.y; a_lo[4 * v + 2] = lo.z; a_lo[4 * v + 3] = lo.w;
          a_hi[4 * v] = hi.x; a_hi[4 * v + 1] = hi.y; a_hi[4 * v + 2] = hi.z; a_hi[4 * v + 3] = hi.w;
        }
        // Each step multiplies 8 consecutive K of this lane: xq holds them
        // as [evens | odds], and so do b0 | b1.
        if constexpr (BITS == 4) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint32_t b0 = (w[j] << 4) & 0xF0F0F0F0u;  // low nibbles: even K, times 16
            const uint32_t b1 = w[j] & 0xF0F0F0F0u;         // high nibbles: odd K, times 16
            mma_s8(c[mt], a_lo[2 * j], a_hi[2 * j], a_lo[2 * j + 1], a_hi[2 * j + 1], b0, b1);
          }
        } else {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const uint32_t b0 = __byte_perm(w[2 * j], w[2 * j + 1], 0x6420);
            const uint32_t b1 = __byte_perm(w[2 * j], w[2 * j + 1], 0x7531);
            mma_s8(c[mt], a_lo[2 * j], a_hi[2 * j], a_lo[2 * j + 1], a_hi[2 * j + 1], b0, b1);
          }
        }
      }
      if (++s < segs_per_group) continue;

      // Group epilogue: (dot - xsum * zero) * scale into the k-block's total.
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = mt * 16 + gid + h * 8;
          int d0 = c[mt][2 * h], d1 = c[mt][2 * h + 1];
          if (BITS == 4) {  // the nibbles were multiplied as 16 times their value
            d0 >>= 4;
            d1 >>= 4;
          }
          if (zeros != nullptr && r < M) {
            const int xs = xsum[(size_t)r * n_groups + g];
            d0 -= xs * z0;
            d1 -= xs * z1;
          }
          tot[mt][2 * h] += (float)d0 * s0;
          tot[mt][2 * h + 1] += (float)d1 * s1;
        }
      s = 0;
      g += kW4Warps;
    }
  }
  if (cur_kb >= 0) flush(cur_kb);

  // The warps' partial sums, added in warp order.
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      red[warp][mt * 16 + gid + (i >> 1) * 8][tig * 2 + (i & 1)] = acc[mt][i];
  __syncthreads();
  for (int i = tid; i < MT * 16 * kW4Cols; i += kW4Threads) {
    const int r = i / kW4Cols, cc = i % kW4Cols;
    if (r >= M) continue;
    float v = 0.f;
#pragma unroll
    for (int w2 = 0; w2 < kW4Warps; ++w2) v += red[w2][r][cc];
    out[(size_t)r * N + n0 + cc] = __float2bfloat16_rn(v);
  }
}

// ------------------------------------------------------------ group / dequant

constexpr int kTileThreads = 128;
constexpr int kBM = 64, kBN = 64;

// Four 8x8 b16 matrices from shared memory, one row address per lane.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* row) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// DEQUANT false: `group`, true: `dequant`. BK: K per tile (32 or 64), a
// divisor of the group size. grid (ceil(M/64), ceil(N/64)).
template <bool DEQUANT, int BITS, int BK>
__global__ void __launch_bounds__(kTileThreads) tile_kernel(
    const bf16* __restrict__ x, const uint8_t* __restrict__ qw, const void* __restrict__ scales,
    int scales_bf16, const int8_t* __restrict__ zeros, const void* __restrict__ gamma,
    int gamma_bf16, float eps, bf16* __restrict__ out, int M, int K, int N, int G) {
  constexpr int kLD = BK + 8;  // bf16 row stride in shared memory: no bank conflicts
  constexpr int kAVecs = kBM * BK / 8 / kTileThreads;  // 16-byte pieces of x per thread
  constexpr int kARowVecs = BK / 8;                    // 16-byte pieces per row of the x tile
  constexpr int kBK2 = BK / 2;                         // K of one weight row per thread
  constexpr int kBWords = BITS == 4 ? kBK2 / 8 : kBK2 / 4;  // 32-bit words of them
  __shared__ __align__(16) bf16 As[kBM * kLD];
  __shared__ __align__(16) bf16 Bs[kBN * kLD];
  __shared__ float inv_s[kBM];
  __shared__ float xs_s[kBM];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;  // 2 x 2 warps, 32 x 32 each
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const bool asym = zeros != nullptr;
  const bool group_xsum = !DEQUANT && asym;

  if (gamma != nullptr) {
    for (int r = warp; r < kBM; r += kTileThreads / 32) {
      const int row = m0 + r;
      float ss = 0.f;
      if (row < M) {
        const bf16* xr = x + (size_t)row * K;
        for (int k = lane; k < K; k += 32) {
          const float v = __bfloat162float(xr[k]);
          ss += v * v;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
      if (lane == 0) inv_s[r] = __frsqrt_rn(ss / (float)K + eps);
    }
    __syncthreads();
  }

  // This thread's part of a tile: kAVecs 8-wide pieces of x, BK/2 K of one
  // weight row.
  const int b_n = tid >> 1, b_k = (tid & 1) * kBK2;
  const bool b_ok = n0 + b_n < N;
  const size_t row_bytes = BITS == 4 ? (size_t)K / 2 : (size_t)K;
  const uint8_t* b_src = qw + (size_t)(n0 + b_n) * row_bytes;

  uint4 a_reg[kAVecs];
  uint32_t b_reg[kBWords];
  float b_scale = 0.f;
  int b_zero = 0;

  auto load_tile = [&](int kt) {
    const int k0 = kt * BK;
#pragma unroll
    for (int i = 0; i < kAVecs; ++i) {
      const int v = tid + i * kTileThreads;
      const int row = m0 + v / kARowVecs;
      a_reg[i] = make_uint4(0, 0, 0, 0);
      if (row < M)
        a_reg[i] = __ldg(reinterpret_cast<const uint4*>(x + (size_t)row * K + k0 + (v % kARowVecs) * 8));
    }
#pragma unroll
    for (int i = 0; i < kBWords; ++i) b_reg[i] = 0;
    b_scale = 0.f;
    b_zero = 0;
    if (b_ok) {
      const uint2* src = reinterpret_cast<const uint2*>(b_src + (BITS == 4 ? (k0 + b_k) / 2 : k0 + b_k));
#pragma unroll
      for (int i = 0; i < kBWords / 2; ++i) {
        const uint2 v = __ldg(src + i);
        b_reg[2 * i] = v.x;
        b_reg[2 * i + 1] = v.y;
      }
      const size_t gi = (size_t)(k0 / G) * N + n0 + b_n;
      b_scale = load_f32_or_bf16(scales, gi, scales_bf16);
      if (asym) b_zero = zeros[gi];
    }
  };

  auto store_tile = [&](int kt) {
    const int k0 = kt * BK;
#pragma unroll
    for (int i = 0; i < kAVecs; ++i) {
      const int vi = tid + i * kTileThreads;
      const int a_row = vi / kARowVecs, a_k = (vi % kARowVecs) * 8;
      uint4 v = a_reg[i];
      if (gamma != nullptr) {
        const float inv = inv_s[a_row];
        uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const __nv_bfloat162 p = *reinterpret_cast<const __nv_bfloat162*>(&w[j]);
          const int k = k0 + a_k + 2 * j;
          const float lo = __bfloat162float(p.x) * inv * load_f32_or_bf16(gamma, k, gamma_bf16);
          const float hi = __bfloat162float(p.y) * inv * load_f32_or_bf16(gamma, k + 1, gamma_bf16);
          w[j] = pack_bf16x2(lo, hi);
        }
      }
      *reinterpret_cast<uint4*>(&As[a_row * kLD + a_k]) = v;
    }
    // BK/2 weights of row b_n, in K order, to bf16: unpacked, and for dequant
    // (q - z) in bf16, then times the bf16 scale, rounded to bf16 again.
    bf16* dst = &Bs[b_n * kLD + b_k];
    if (BITS == 4) {
      // Exact unpacking (quant_unpack.cuh); the offset 136 + z leaves the
      // weight minus its zero point.
      const __nv_bfloat162 offset = __float2bfloat162_rn(136.f + (DEQUANT ? (float)b_zero : 0.f));
      const __nv_bfloat162 s2 = __float2bfloat162_rn(b_scale);
#pragma unroll
      for (int i = 0; i < kBWords; ++i) {  // 8 weights a word
        uint32_t packed[4];
        scalellm_quant::unpack_int4x8(b_reg[i], offset, packed);
        if (DEQUANT) {
#pragma unroll
          for (int j = 0; j < 4; ++j) packed[j] = bf16x2_bits(__hmul2(bf16x2_from_bits(packed[j]), s2));
        }
        *reinterpret_cast<uint4*>(dst + 8 * i) = make_uint4(packed[0], packed[1], packed[2], packed[3]);
      }
    } else {
      const float s = __bfloat162float(__float2bfloat16_rn(b_scale));
#pragma unroll
      for (int i = 0; i < kBWords; ++i) {  // 4 weights a word
        float q[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float d = (float)(int8_t)((b_reg[i] >> (8 * j)) & 0xFFu);
          if (DEQUANT) {
            if (asym) d = __bfloat162float(__float2bfloat16_rn(d - (float)b_zero));
            d *= s;
          }
          q[j] = d;
        }
        *reinterpret_cast<uint2*>(dst + 4 * i) = make_uint2(pack_bf16x2(q[0], q[1]), pack_bf16x2(q[2], q[3]));
      }
    }
  };

  float acc[2][4][4], cg[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = cg[mt][nt][i] = 0.f;
  // The group variant's scales and zero points of the group in progress,
  // fetched when the group begins so that its end does not wait for them.
  float gs[4][2], gz[4][2];

  const int n_kt = K / BK;
  load_tile(0);
  for (int kt = 0; kt < n_kt; ++kt) {
    store_tile(kt);
    __syncthreads();
    if (kt + 1 < n_kt) load_tile(kt + 1);

    const bool group_begin = (kt * BK) % G == 0;
    const bool group_end = ((kt + 1) * BK) % G == 0;
    if (!DEQUANT && group_begin) {
      const int g = (kt * BK) / G;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = n0 + wn * 32 + nt * 8 + tig * 2 + j;
          gs[nt][j] = gz[nt][j] = 0.f;
          if (c < N) {
            gs[nt][j] = load_f32_or_bf16(scales, (size_t)g * N + c, scales_bf16);
            if (asym) gz[nt][j] = (float)zeros[(size_t)g * N + c];
          }
        }
    }
    if (group_xsum && tid < kBM) {
      float p = 0.f;
#pragma unroll
      for (int k = 0; k < BK; ++k) p += __bfloat162float(As[tid * kLD + k]);
      xs_s[tid] = group_begin ? p : xs_s[tid] + p;
    }
    float (&target)[2][4][4] = DEQUANT ? acc : cg;
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      // ldmatrix hands each lane the fragment words the mma wants: for A
      // the four 8x8 quarters of a 16x16 tile, for B (stored [n][k]) the
      // two k halves of two neighbouring n8 tiles.
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldmatrix_x4(a[mt], &As[(wm * 32 + mt * 16 + (lane & 15)) * kLD + ks * 16 + (lane >> 4) * 8]);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t r[4];
        ldmatrix_x4(r, &Bs[(wn * 32 + np * 16 + (lane & 7) + (lane >> 4) * 8) * kLD + ks * 16 +
                           ((lane >> 3) & 1) * 8]);
        b[2 * np][0] = r[0];
        b[2 * np][1] = r[1];
        b[2 * np + 1][0] = r[2];
        b[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_bf16(target[mt][nt], a[mt][0], a[mt][1], a[mt][2], a[mt][3], b[nt][0], b[nt][1]);
    }
    if (!DEQUANT && group_end) {
      if (group_xsum) __syncthreads();  // xs_s is complete
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float d = cg[mt][nt][i];
            if (asym) d -= xs_s[wm * 32 + mt * 16 + gid + (i >> 1) * 8] * gz[nt][i & 1];
            acc[mt][nt][i] += d * gs[nt][i & 1];
            cg[mt][nt][i] = 0.f;
          }
    }
    __syncthreads();  // the tile is consumed; the next store may overwrite it
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * 32 + mt * 16 + gid + h * 8;
        const int c0 = n0 + wn * 32 + nt * 8 + tig * 2;
        if (row < M && c0 + 1 < N) {
          *reinterpret_cast<uint32_t*>(out + (size_t)row * N + c0) =
              pack_bf16x2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
        } else if (row < M && c0 < N) {
          out[(size_t)row * N + c0] = __float2bfloat16_rn(acc[mt][nt][2 * h]);
        }
      }
}

template <bool DEQUANT>
int launch_tile(const void* x, const void* qweight, const void* scales, const void* zeros,
                const void* rms_gamma, void* out, int M, int K, int N, int G, int bits,
                int scales_bf16, int gamma_bf16, float rms_eps, cudaStream_t st) {
  if (M <= 0 || N <= 0) return 0;
  if ((bits != 4 && bits != 8) || G <= 0 || K % G != 0 || G % 32 != 0 || N % 2 != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
#define SCALELLM_TILE_LAUNCH(BITS, BK)                                                  \
  tile_kernel<DEQUANT, BITS, BK><<<grid, kTileThreads, 0, st>>>(                        \
      static_cast<const bf16*>(x), static_cast<const uint8_t*>(qweight), scales,        \
      scales_bf16, static_cast<const int8_t*>(zeros), rms_gamma, gamma_bf16, rms_eps,   \
      static_cast<bf16*>(out), M, K, N, G)
  // K tiles of 64 where the group size allows: fewer, longer steps hide the
  // latency of the next tile's loads better (128 measured slower than 64).
  if (bits == 4) {
    if (G % 64 == 0) SCALELLM_TILE_LAUNCH(4, 64);
    else SCALELLM_TILE_LAUNCH(4, 32);
  } else {
    if (G % 64 == 0) SCALELLM_TILE_LAUNCH(8, 64);
    else SCALELLM_TILE_LAUNCH(8, 32);
  }
#undef SCALELLM_TILE_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each launches on `stream` and
// returns cudaGetLastError() (0 on success); none synchronises or allocates.

// xq s8 [M, K], sx f32 [M, K / block_k] and xsum s32 [M, K / G] (null when
// zeros is null) are scratch the caller allocates. M <= 64.
extern "C" int scalellm_quant_matmul_w4a8(
    const void* x, const void* qweight, const void* scales, const void* zeros,
    const void* rms_gamma, void* xq, void* sx, void* xsum, void* out, int M, int K, int N,
    int group_size, int bits, int scales_bf16, int gamma_bf16, int block_k, float rms_eps,
    void* stream) {
  if (M <= 0 || N <= 0) return 0;
  const int G = group_size;
  const int seg_k = bits == 4 ? 128 : 64;
  if ((bits != 4 && bits != 8) || M > 64 || G <= 0 || G % seg_k != 0 || K % G != 0 ||
      block_k <= 0 || block_k % G != 0 || K % block_k != 0 || N % kW4Cols != 0 || K % 16 != 0 ||
      K > 32 * 1024 || (zeros != nullptr && xsum == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int act_smem = 3 * K;  // bf16 values and int8 values of one row
  if (act_smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        act_quant_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, act_smem);
    if (e != cudaSuccess) return (int)e;
  }
  act_quant_kernel<<<M, kActThreads, act_smem, st>>>(
      static_cast<const bf16*>(x), rms_gamma, gamma_bf16, rms_eps, static_cast<int8_t*>(xq),
      static_cast<float*>(sx), zeros != nullptr ? static_cast<int*>(xsum) : nullptr, K, block_k, G);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const int grid = N / kW4Cols;
#define SCALELLM_W4A8_LAUNCH(MT, BITS)                                                   \
  w4a8_kernel<MT, BITS><<<grid, kW4Threads, 0, st>>>(                                    \
      static_cast<const int8_t*>(xq), static_cast<const float*>(sx),                     \
      static_cast<const int*>(xsum), static_cast<const uint8_t*>(qweight), scales,       \
      scales_bf16, static_cast<const int8_t*>(zeros), static_cast<bf16*>(out), M, K, N,  \
      G, block_k)
  const int mt = M <= 16 ? 1 : (M <= 32 ? 2 : 4);
  if (bits == 4) {
    if (mt == 1) SCALELLM_W4A8_LAUNCH(1, 4);
    else if (mt == 2) SCALELLM_W4A8_LAUNCH(2, 4);
    else SCALELLM_W4A8_LAUNCH(4, 4);
  } else {
    if (mt == 1) SCALELLM_W4A8_LAUNCH(1, 8);
    else if (mt == 2) SCALELLM_W4A8_LAUNCH(2, 8);
    else SCALELLM_W4A8_LAUNCH(4, 8);
  }
#undef SCALELLM_W4A8_LAUNCH
  return (int)cudaGetLastError();
}

extern "C" int scalellm_quant_matmul_group(
    const void* x, const void* qweight, const void* scales, const void* zeros,
    const void* rms_gamma, void* out, int M, int K, int N, int group_size, int bits,
    int scales_bf16, int gamma_bf16, float rms_eps, void* stream) {
  return launch_tile<false>(x, qweight, scales, zeros, rms_gamma, out, M, K, N, group_size, bits,
                            scales_bf16, gamma_bf16, rms_eps,
                            reinterpret_cast<cudaStream_t>(stream));
}

extern "C" int scalellm_quant_matmul_dequant(
    const void* x, const void* qweight, const void* scales, const void* zeros,
    const void* rms_gamma, void* out, int M, int K, int N, int group_size, int bits,
    int scales_bf16, int gamma_bf16, float rms_eps, void* stream) {
  return launch_tile<true>(x, qweight, scales, zeros, rms_gamma, out, M, K, N, group_size, bits,
                           scales_bf16, gamma_bf16, rms_eps,
                           reinterpret_cast<cudaStream_t>(stream));
}
