// Weight-gradient and LayerNorm-backward kernels of the training backward
// (H5, H6, H7, H8): the products and reductions that the TPU backward kernels
// accumulate inside their bodies (tvts_tpu/ops/pallas_block_backward.py:
// 3167-3174 (fused_space_attention_block_v10_bwd, :3106), the weight halves of
// fused_time_attention_block_v2_bwd (:736, kernel :501) and
// fused_mlp_block_v7_bwd (:2637); pallas_block_attention.py::
// fused_mlp_block_bwd (:1021); pallas_text_attention.py:225-257) into fp32
// output refs carried across the sequential grid.
//
// CUDA blocks run in no order, so every reduction over the B*S rows is split:
// each block reduces its own contiguous chunk of rows into an f32 partial, and
// reduce_partials_kernel sums the partials in a fixed order. The result is
// deterministic, and no atomics are used.
//
// wgrad_kernel: C[N1, N2] = A^T B over M rows (A [M, N1], B [M, N2], both
// row-major bf16, f32 accumulation). With `stats` B is LN(x), recomputed from
// the row statistics the forward saved and rounded to bf16 as the forward's
// product saw it. With `colsum` it also sums A's columns (the bias gradient)
// in f32, in a fixed order.
// Bound on the H100: the tensor cores (2*M*N1*N2 flops; at B/16's B=20, M =
// 23,540: 83.3 GFLOP for dWqkv, 27.8 for dWproj). Design, for sm_90a: ln_gemm's
// mainloop (hopper.cuh) with the contraction over the token rows. A block owns
// a 128 x 256 output tile and one split of the rows; TMA loads run ahead into
// a 4-stage ring against full / empty mbarriers, each stage 64 token rows: two
// boxes (64 features by 64 rows) of one operand and four of the other, 48 KB,
// with zeros past M and past N1 / N2. The tiles are token-row-major, so both
// wgmma operands are MN-major (transpose immediates 1, 1; sw128_mn_desc:
// 64-wide atoms 8 KB apart, a k16 step 16 rows = 2048 bytes on). Two consumer
// warpgroups, 64 output rows each, run wgmma.mma_async m64n256k16 with f32
// accumulators in registers and do nothing else with the LayerNorm: a
// producer warpgroup normalises the LayerNorm operand of a stage in place
// (the 128-wide one, so the tile is C^T and leaves transposed) and hands it
// over on a third mbarrier, while the first consumer refills each slot as
// soon as both warpgroups hand it back (three stages of loads in flight).
// A first version normalised a 256-wide B tile in the consumers between
// their wgmmas and ran the LayerNorm products at 250-280 TFLOP/s against 640
// without; this one runs them at ~400, held back by the rewrite's
// shared-memory traffic and arithmetic (without the rewrite ~530;
// PERF.md). colsum(A) is spread over the blocks that load the same A tile, a
// stage each in turn.
// Split-M: a split's rows are a multiple of the 64-row stage, so no box
// crosses into the next split. The split count (ops/block_backward.py::
// wgrad_plan) depends on the shapes and the SM count only: it minimises the
// waves of tiles times the k steps a block walks plus a fixed cost a block
// (ring fill, epilogue), plus the partials' traffic. The partials cost
// splits * N1 * N2 * 4 bytes written and read again: at B/16's B=20, dWqkv
// (54 tiles) takes 2 splits (14.2 MB), dWproj (18 tiles) 7 (16.5 MB), the MLP
// products (72 tiles) 3 (28.3 MB).
//
// ln_bwd_kernel and ln_colsum_kernel: the LayerNorm backward (its own section
// below).
#pragma once

#include "hopper.cuh"

namespace tvts {

constexpr int WG_BM = 128;  // R features a tile: two consumer warpgroups of 64
constexpr int WG_BN = 256;  // Q features a tile
constexpr int WG_BK = 64;   // token rows a stage
constexpr int WG_STAGES = 4;
constexpr int WG_BOX_BYTES = 64 * WG_BK * 2;  // 64 features by 64 rows, bf16
constexpr int WG_R_BYTES = 2 * WG_BOX_BYTES;
constexpr int WG_STAGE_BYTES = WG_R_BYTES + 4 * WG_BOX_BYTES;
// the ring, 1 KB of slack to align it to the swizzle pattern, 3 barriers a
// stage (full, empty, ready), the column sums' staging (8 x 128 floats)
constexpr int WG_SMEM = WG_STAGES * WG_STAGE_BYTES + 1024 + 3 * WG_STAGES * 8 + 1024 * 4;
// two consumer warpgroups and a producer warp; with the LayerNorm prologue a
// whole producer warpgroup, which also normalises and sums columns
__host__ __device__ constexpr int wgrad_threads(bool ln) { return ln ? 384 : 288; }

struct WgradArgs {
  const float2* stats;  // LayerNorm prologue on B (mean, rstd per row); null: none
  const float* ln_w;
  const float* ln_b;
  float* partial;  // [splits][N1][N2]
  float* colsum;   // [splits * (tiles of the other operand)][N1] or null
  int M, N1, N2, rows_per_split;
};

// Roles: the R operand (two 64-wide boxes a stage, wgmma's A, one warpgroup
// each) and the Q operand (four boxes, wgmma's B). Without LN, R = A and Q =
// B: the tile is C[128 x 256]. With LN, R = B = x, whose 128 x 64 tile a stage
// the producer warpgroup normalises (half the elements of a 256-wide tile),
// and Q = A: the tile is C^T, stored transposed. colsum(A): a block sums A's
// columns over the stages kt with kt % T == t, T the number of tiles of the
// other operand and t this block's index among them, so that the work spreads
// over the blocks that load the same A tile; the partial goes to row
// split * T + t of `colsum`.
template <bool LN>
__global__ void __launch_bounds__(LN ? 384 : 288, 1)
    wgrad_kernel(const __grid_constant__ CUtensorMap tmR,
                 const __grid_constant__ CUtensorMap tmQ, const WgradArgs a) {
  extern __shared__ uint8_t wgrad_smem[];
  const uint32_t raw = smem_addr(wgrad_smem);
  const uint32_t ring = (raw + 1023) & ~1023u;  // the swizzle pattern repeats every 1 KB
  const uint32_t full = ring + WG_STAGES * WG_STAGE_BYTES;
  const uint32_t empty = full + WG_STAGES * 8;
  const uint32_t ready = empty + WG_STAGES * 8;  // LN: the stage is normalised
  uint8_t* ring_ptr = wgrad_smem + (ring - raw);
  float* csum_s =
      reinterpret_cast<float*>(ring_ptr + WG_STAGES * WG_STAGE_BYTES + 3 * WG_STAGES * 8);

  const int tid = threadIdx.x, wg = tid >> 7;
  const int r0 = blockIdx.y * WG_BM, q0 = blockIdx.x * WG_BN, split = blockIdx.z;
  const int NR = LN ? a.N2 : a.N1, NQ = LN ? a.N1 : a.N2;
  const int m_begin = split * a.rows_per_split;
  const int m_end = min(a.M, m_begin + a.rows_per_split);
  const int KT = (m_end - m_begin + WG_BK - 1) / WG_BK;  // >= 1: no split is empty
  const int cs_every = LN ? gridDim.y : gridDim.x, cs_phase = LN ? blockIdx.y : blockIdx.x;
  const bool do_colsum = a.colsum != nullptr;
  if (tid == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);    // the producer's expect_tx
      mbar_init(empty + 8 * s, 2);   // one arrival per consumer warpgroup
      mbar_init(ready + 8 * s, 128);  // LN: every thread of the producer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto load = [&](int kt) {
    const int s = kt % WG_STAGES;
    const uint32_t dst = ring + s * WG_STAGE_BYTES;
    const int row = m_begin + kt * WG_BK;
    mbar_expect_tx(full + 8 * s, WG_STAGE_BYTES);
    tma_load_2d(dst, &tmR, full + 8 * s, r0, row);
    tma_load_2d(dst + WG_BOX_BYTES, &tmR, full + 8 * s, r0 + 64, row);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      tma_load_2d(dst + WG_R_BYTES + q * WG_BOX_BYTES, &tmQ, full + 8 * s, q0 + 64 * q, row);
  };

  if (wg == 2) {
    if constexpr (!LN) {
      // ---- producer: one thread keeps the ring full -------------------------
      if (tid == 2 * 128) {
        for (int kt = 0; kt < KT; ++kt) {
          if (kt >= WG_STAGES)
            mbar_wait(empty + 8 * (kt % WG_STAGES), ((kt / WG_STAGES) & 1) ^ 1);
          load(kt);
        }
      }
      return;
    } else {
      // ---- producer warpgroup: the first loads, the LayerNorm of the R tile,
      // colsum (the consumers refill the ring) ---------------------------------
      // Thread lt owns the 16-byte chunk lt % 8 of rows lt / 8 + 16 j (j < 4)
      // in both R boxes; under the 128-byte swizzle logical chunk c of row r
      // sits at chunk c ^ (r % 8), the same for its four rows, so it needs the
      // LayerNorm weights of one 8-column chunk a box. Rows past M are zeros
      // and become b (stats (0, 1)) against a zero A row. For colsum it sums
      // four columns (an 8-byte quad) of the Q tile over 32 rows.
      const int lt = tid - 256;
      if (lt == 0)
        for (int kt = 0; kt < min(WG_STAGES, KT); ++kt) load(kt);
      const int rr0 = lt >> 3, chunk = lt & 7, lc = chunk ^ (rr0 & 7);
      const int cq = lt & 63, rh = lt >> 6;
      const int cs_off = (cq >> 4) * WG_BOX_BYTES + (cq & 1) * 8, cs_chunk = (cq & 15) >> 1;
      float cs[4] = {0.f, 0.f, 0.f, 0.f};
      // the LayerNorm weights of the thread's two chunks, once a block; each
      // stage's row statistics are loaded two stages ahead, so that their
      // latency hides under the work of the stages between
      float w[2][8], b[2][8];
#pragma unroll
      for (int bx = 0; bx < 2; ++bx) {
        const int k = min(r0 + 64 * bx + 8 * lc, NR - 8);  // past N2: any columns, never stored
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          w[bx][e] = __ldg(a.ln_w + k + e);
          b[bx][e] = __ldg(a.ln_b + k + e);
        }
      }
      float2 st[4], st1[4], st2[4];  // the stats of stages kt, kt + 1, kt + 2
      auto load_stats = [&](int kt, float2 (&out)[4]) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int row = m_begin + kt * WG_BK + rr0 + 16 * j;
          out[j] = row < a.M ? __ldg(a.stats + row) : make_float2(0.f, 1.f);
        }
      };
      load_stats(0, st);
      load_stats(1, st1);
      for (int kt = 0; kt < KT; ++kt) {
        const int s = kt % WG_STAGES;
        load_stats(kt + 2, st2);
        mbar_wait(full + 8 * s, (kt / WG_STAGES) & 1);
        uint8_t* tile = ring_ptr + s * WG_STAGE_BYTES;
#pragma unroll
        for (int bx = 0; bx < 2; ++bx) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            uint4* p = reinterpret_cast<uint4*>(tile + bx * WG_BOX_BYTES + (rr0 + 16 * j) * 128 +
                                                chunk * 16);
            float x[8];
            unpack_bf16x8(*p, x);
#pragma unroll
            for (int e = 0; e < 8; ++e) x[e] = (x[e] - st[j].x) * st[j].y * w[bx][e] + b[bx][e];
            *p = pack_bf16x8(x);
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          st[j] = st1[j];
          st1[j] = st2[j];
        }
        if (do_colsum && kt % cs_every == cs_phase) {
          const uint8_t* at = tile + WG_R_BYTES + cs_off;
#pragma unroll 8
          for (int r = 32 * rh; r < 32 * rh + 32; ++r) {
            const uint2 u = *reinterpret_cast<const uint2*>(at + r * 128 +
                                                            ((cs_chunk ^ (r & 7)) << 4));
            cs[0] += __uint_as_float(u.x << 16);
            cs[1] += __uint_as_float(u.x & 0xffff0000u);
            cs[2] += __uint_as_float(u.y << 16);
            cs[3] += __uint_as_float(u.y & 0xffff0000u);
          }
        }
        // the rewritten rows, written by the generic proxy, are read by wgmma
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(ready + 8 * s);
      }
      if (do_colsum) {
#pragma unroll
        for (int e = 0; e < 4; ++e) csum_s[rh * 256 + 4 * cq + e] = cs[e];
        named_sync(3, 128);
        for (int c = lt; c < WG_BN; c += 128)
          if (q0 + c < NQ)
            a.colsum[((i64)split * cs_every + cs_phase) * a.N1 + q0 + c] =
                csum_s[c] + csum_s[256 + c];
      }
      return;
    }
  }

  // ---- consumers: warpgroup wg owns R features r0 + 64 wg .. + 63 ----------
  const int wt = tid & 127, warp = wt >> 5, lane = tid & 31;
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  // without LN, colsum(A = R): thread tid sums the 4 columns 4 (tid % 32)..
  // of the R tile over rows 8 (tid / 32) .. + 7 of its stages
  const int cq = tid & 31, rg = tid >> 5;
  const int cs_off = (cq >> 4) * WG_BOX_BYTES + (cq & 1) * 8, cs_chunk = (cq & 15) >> 1;
  float cs[4] = {0.f, 0.f, 0.f, 0.f};

  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % WG_STAGES;
    mbar_wait(full + 8 * s, (kt / WG_STAGES) & 1);
    if constexpr (LN) mbar_wait(ready + 8 * s, (kt / WG_STAGES) & 1);
    const uint32_t tile = ring + s * WG_STAGE_BYTES;
    const uint64_t dR = sw128_mn_desc(tile + wg * WG_BOX_BYTES, WG_BOX_BYTES);
    const uint64_t dQ = sw128_mn_desc(tile + WG_R_BYTES, WG_BOX_BYTES);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j)  // 16 token rows (2048 bytes) a step
      wgmma_ss<1, 1>(acc, dR + (uint64_t)(j * 2048 >> 4), dQ + (uint64_t)(j * 2048 >> 4), 1);
    wgmma_commit();
    if constexpr (!LN) {
      if (do_colsum && kt % cs_every == cs_phase) {
        const uint8_t* at = ring_ptr + s * WG_STAGE_BYTES + cs_off;
#pragma unroll
        for (int r = 8 * rg; r < 8 * rg + 8; ++r) {
          const uint2 u =
              *reinterpret_cast<const uint2*>(at + r * 128 + ((cs_chunk ^ (r & 7)) << 4));
          cs[0] += __uint_as_float(u.x << 16);
          cs[1] += __uint_as_float(u.x & 0xffff0000u);
          cs[2] += __uint_as_float(u.y << 16);
          cs[3] += __uint_as_float(u.y & 0xffff0000u);
        }
        named_sync(1, 256);  // every consumer is done with this R tile before it goes back
      }
    }
    // the previous stage's wgmmas are done: hand it back to the producer
    wgmma_wait<1>();
    if (kt > 0 && wt == 0) mbar_arrive(empty + 8 * ((kt - 1) % WG_STAGES));
    // with LN the producer warpgroup is busy normalising: the first consumer
    // refills the slot of stage kt - 1 once both warpgroups have handed it back
    if constexpr (LN)
      if (kt > 0 && tid == 0 && kt - 1 + WG_STAGES < KT) {
        mbar_wait(empty + 8 * ((kt - 1) % WG_STAGES), ((kt - 1) / WG_STAGES) & 1);
        load(kt - 1 + WG_STAGES);
      }
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // ---- epilogue: the f32 partial of this split, straight from the
  // accumulators (per 8 Q features i, R features g and g + 8 of the warp's
  // 16, Q features 2t..2t+1). C[R][Q] without LN: a warp's store covers 8
  // rows x 32 bytes; C^T with LN: 4 rows x 32 bytes (8 neighbouring R
  // features), whole sectors either way. ------------------------------------
  float* out = a.partial + (i64)split * a.N1 * a.N2;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rf = r0 + 64 * wg + 16 * warp + g + 8 * h;
    if (rf >= NR) continue;
#pragma unroll
    for (int i = 0; i < WG_BN / 8; ++i) {
      const int qf = q0 + 8 * i + 2 * t4;
      if (qf >= NQ) continue;
      if constexpr (LN) {
        out[(i64)qf * a.N2 + rf] = acc[4 * i + 2 * h];
        out[(i64)(qf + 1) * a.N2 + rf] = acc[4 * i + 2 * h + 1];
      } else {
        *reinterpret_cast<float2*>(out + (i64)rf * a.N2 + qf) =
            make_float2(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
      }
    }
  }
  if constexpr (!LN) {
    if (do_colsum) {
#pragma unroll
      for (int e = 0; e < 4; ++e) csum_s[rg * 128 + 4 * cq + e] = cs[e];
      named_sync(1, 256);
      if (tid < WG_BM && r0 + tid < a.N1) {
        float sum = 0.f;
#pragma unroll
        for (int k = 0; k < 8; ++k) sum += csum_s[k * 128 + tid];
        a.colsum[((i64)split * cs_every + cs_phase) * a.N1 + r0 + tid] = sum;
      }
    }
  }
}

#ifndef TVTS_WGRAD_UNIT  // weight_grad.cu holds wgrad alone; block_kernels.cu the rest
// out[i] = sum_p partial[p * n + i] for p = 0 .. P-1 in order (f32 and/or bf16).
__global__ void reduce_partials_kernel(const float* __restrict__ partial, int P, i64 n,
                                       float* __restrict__ out_f32, bf16* __restrict__ out_bf16) {
  const i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int p = 0; p < P; ++p) s += partial[(i64)p * n + i];
  if (out_f32) out_f32[i] = s;
  if (out_bf16) out_bf16[i] = __float2bfloat16(s);
}

// LayerNorm backward (H5-H8): the part of the TPU backward kernels after
// _ln_bwd (tvts_tpu/ops/pallas_block_backward.py:46), which sums dln_w and
// dln_b inside the Pallas kernel (e.g. :809). Row r: xhat = (x - mean) * rstd,
// dxhat = dxln * w, dx = res + (dxhat - mean(dxhat) - xhat * mean(dxhat *
// xhat)) * rstd in bf16; dln_w = sum_r dxln * xhat and dln_b = sum_r dxln in
// f32. Bound on the H100: bytes (x 2, dxln 4, res 2 and dx 2 bytes an
// element: 181 MB, 0.054 ms at B/16's B=20, M = 23,540, K = 768).
// ln_bwd_kernel is one pass over the rows in one wave (ops/block_backward.py::
// ln_bwd_plan: a block of 8 warps an SM, or one block per 8 rows when M is
// smaller; up to 255 registers a thread, so the lane's column partials stay in
// registers at K = 1280). Of the W warps, warp w owns rows [w * M / W, (w + 1)
// * M / W), so every warp has the same number of rows to one; for each row it
// loads x, dxln and res once (16-byte vectors,
// every chunk of the row in flight together) and computes dx in the first
// version's arithmetic and order (lane l owns columns c * 256 + 8 l .. + 7;
// m1, m2 summed per lane in column order, then across the warp), so dx is
// bit for bit the first version's. Each lane sums its columns of dxln * xhat
// and dxln over its rows in registers; at the end the block sums its 8 warps'
// partials in warp order (through shared memory) into one row: part
// [2][blocks][K] f32, one row an SM (the first version wrote a row a warp,
// ~3,900 rows at B/16, and summed each column on one thread; partials summed
// in shared memory row by row, at 2 blocks an SM, took 7% longer at K = 768
// and at 1280; PERF.md). ln_colsum_kernel then sums the partial rows: a block a slab of
// 32 columns, each of its 16 warps a sixteenth of the rows in order (their
// loads in flight at once), then the warp sums in warp order. No atomics:
// dln_w and dln_b do not vary from run to run.
constexpr int LNB_WARPS = 8;
constexpr int LNB_MAXC = 5;  // 256-column chunks a row: K <= 1280
constexpr int LNC_COLS = 32;  // columns a ln_colsum_kernel block

// shared memory of an ln_bwd_kernel block: the warps' column partials
inline size_t ln_bwd_smem(int K, bool weight_grads) {
  return weight_grads ? (size_t)2 * LNB_WARPS * K * sizeof(float) : 0;
}

// eight f32 from a 16-byte aligned address, in two 16-byte loads
__device__ __forceinline__ void load_f32x8(const float* p, float (&f)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p), b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w, f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
}

template <int C>  // chunks of 256 columns: K <= 256 * C
__global__ void __launch_bounds__(LNB_WARPS * 32, 1)
    ln_bwd_kernel(const bf16* __restrict__ X, const float2* __restrict__ stats,
                  const float* __restrict__ dxln, const float* __restrict__ ln_w,
                  const bf16* __restrict__ res, bf16* __restrict__ dx,
                  float* __restrict__ part, int M, int K) {
  extern __shared__ __align__(16) float lnb_acc[];  // [2][LNB_WARPS][K]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float aw[C][8], ab[C][8];  // this lane's column partials of dxln * xhat and dxln
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int i = 0; i < 8; ++i) aw[c][i] = ab[c][i] = 0.f;
  const float inv_k = 1.f / K;
  const i64 warps = (i64)gridDim.x * LNB_WARPS, wg = (i64)blockIdx.x * LNB_WARPS + warp;
  const int r0 = (int)(wg * M / warps), r1 = (int)((wg + 1) * M / warps);

  for (int row = r0; row < r1; ++row) {
    const float2 st = stats[row];
    const bf16* xr = X + (i64)row * K;
    const float* gr = dxln + (i64)row * K;
    uint4 xv[C], rv[C];
    float g[C][8];
#pragma unroll
    for (int c = 0; c < C; ++c) {  // the whole row in flight at once
      const int k = c * 256 + lane * 8;
      xv[c] = rv[c] = make_uint4(0, 0, 0, 0);
      if (k >= K) continue;
      xv[c] = *reinterpret_cast<const uint4*>(xr + k);
      load_f32x8(gr + k, g[c]);
      if (res) rv[c] = *reinterpret_cast<const uint4*>(res + (i64)row * K + k);
    }
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int k = c * 256 + lane * 8;
      if (k >= K) continue;
      float xf[8], w[8];
      unpack_bf16x8(xv[c], xf);
      load_f32x8(ln_w + k, w);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float xhat = (xf[i] - st.x) * st.y;
        const float dxh = g[c][i] * w[i];
        m1 += dxh;
        m2 += dxh * xhat;
      }
    }
    m1 = warp_sum(m1) * inv_k;
    m2 = warp_sum(m2) * inv_k;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int k = c * 256 + lane * 8;
      if (k >= K) continue;
      float xf[8], rf[8], w[8], v[8];
      unpack_bf16x8(xv[c], xf);
      unpack_bf16x8(rv[c], rf);
      load_f32x8(ln_w + k, w);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float xhat = (xf[i] - st.x) * st.y;
        aw[c][i] += g[c][i] * xhat;
        ab[c][i] += g[c][i];
        v[i] = rf[i] + (g[c][i] * w[i] - m1 - xhat * m2) * st.y;
      }
      *reinterpret_cast<uint4*>(dx + (i64)row * K + k) = pack_bf16x8(v);
    }
  }
  if (!part) return;
  // one row of partials a block: the warps' sums in warp order
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int k = c * 256 + lane * 8;
    if (k >= K) continue;
#pragma unroll
    for (int i = 0; i < 8; i += 4) {
      *reinterpret_cast<float4*>(lnb_acc + warp * K + k + i) =
          make_float4(aw[c][i], aw[c][i + 1], aw[c][i + 2], aw[c][i + 3]);
      *reinterpret_cast<float4*>(lnb_acc + (LNB_WARPS + warp) * K + k + i) =
          make_float4(ab[c][i], ab[c][i + 1], ab[c][i + 2], ab[c][i + 3]);
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < 2 * K; e += blockDim.x) {
    const int which = e / K, k = e - which * K;
    const float* src = lnb_acc + which * LNB_WARPS * K + k;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < LNB_WARPS; ++w) s += src[w * K];
    part[((i64)which * gridDim.x + blockIdx.x) * K + k] = s;
  }
}

// out_w[k] = sum_p part[0][p][k], out_b[k] = sum_p part[1][p][k]: block
// (slab, which) sums LNC_COLS columns of one of the two; warp w of the
// LNC_WARPS takes the rows [w * P / LNC_WARPS, (w + 1) * P / LNC_WARPS) in
// order, all of its loads in flight at once (up to LNC_BATCH rows), then the
// warps' sums are added in warp order.
constexpr int LNC_WARPS = 16, LNC_BATCH = 24;

__global__ void __launch_bounds__(LNC_WARPS * 32)
    ln_colsum_kernel(const float* __restrict__ part, int P, int K, float* __restrict__ out_w,
                     float* __restrict__ out_b) {
  __shared__ float red[LNC_WARPS][LNC_COLS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k = blockIdx.x * LNC_COLS + lane;
  const float* src = part + (i64)blockIdx.y * P * K + k;
  float s = 0.f;
  if (k < K) {
    const int p1 = (warp + 1) * P / LNC_WARPS;
    for (int p0 = warp * P / LNC_WARPS; p0 < p1; p0 += LNC_BATCH) {
      float v[LNC_BATCH];
#pragma unroll
      for (int i = 0; i < LNC_BATCH; ++i) v[i] = p0 + i < p1 ? src[(i64)(p0 + i) * K] : 0.f;
#pragma unroll
      for (int i = 0; i < LNC_BATCH; ++i) s += v[i];
    }
  }
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && k < K) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < LNC_WARPS; ++w) t += red[w][lane];
    (blockIdx.y ? out_b : out_w)[k] = t;
  }
}

#endif

}  // namespace tvts
