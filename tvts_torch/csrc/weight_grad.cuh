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
// ln_bwd_kernel: dx = res + LN_bwd(dxln) row by row (one warp per row, two
// passes over the row), plus per-warp column partials of dxln * xhat and
// dxln (the LayerNorm weight and bias gradients). Bound by bytes.
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

// LayerNorm backward. Row r: xhat = (x - mean) * rstd, dxhat = dxln * w,
// dx = res + (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)) * rstd.
// Warp `wg` (global index) owns rows [wg * rpw, (wg + 1) * rpw) and writes its
// column partials part_w[wg] = sum dxln * xhat, part_b[wg] = sum dxln (unless
// part_w is null: the frozen backward needs dx only). K % 8 == 0, K <= 1280.
constexpr int LNB_MAXC = 5;  // 256-column chunks per lane: K <= 1280

__global__ void __launch_bounds__(256)
    ln_bwd_kernel(const bf16* __restrict__ X, const float2* __restrict__ stats,
                  const float* __restrict__ dxln, const float* __restrict__ ln_w,
                  const bf16* __restrict__ res, bf16* __restrict__ dx,
                  float* __restrict__ part_w, float* __restrict__ part_b, int M, int K,
                  int rpw) {
  const int lane = threadIdx.x & 31;
  const int wg = blockIdx.x * 8 + (threadIdx.x >> 5);
  float aw[LNB_MAXC][8], ab[LNB_MAXC][8];
#pragma unroll
  for (int c = 0; c < LNB_MAXC; ++c)
#pragma unroll
    for (int i = 0; i < 8; ++i) aw[c][i] = ab[c][i] = 0.f;
  const float inv_k = 1.f / K;

  for (int row = wg * rpw; row < min(M, (wg + 1) * rpw); ++row) {
    const float2 st = stats[row];
    const bf16* xr = X + (i64)row * K;
    const float* gr = dxln + (i64)row * K;
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int c = 0; c < LNB_MAXC; ++c) {
      const int k = c * 256 + lane * 8;
      if (k >= K) continue;
      uint4 u = *reinterpret_cast<const uint4*>(xr + k);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float xv = i & 1 ? __bfloat1622float2(h[i / 2]).y : __bfloat1622float2(h[i / 2]).x;
        const float xhat = (xv - st.x) * st.y;
        const float dxh = gr[k + i] * ln_w[k + i];
        m1 += dxh;
        m2 += dxh * xhat;
      }
    }
    m1 = warp_sum(m1) * inv_k;
    m2 = warp_sum(m2) * inv_k;
#pragma unroll
    for (int c = 0; c < LNB_MAXC; ++c) {
      const int k = c * 256 + lane * 8;
      if (k >= K) continue;
      uint4 u = *reinterpret_cast<const uint4*>(xr + k);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
      uint4 rv = make_uint4(0, 0, 0, 0);
      if (res) rv = *reinterpret_cast<const uint4*>(res + (i64)row * K + k);
      const __nv_bfloat162* rh = reinterpret_cast<const __nv_bfloat162*>(&rv);
      uint4 o;
      __nv_bfloat162* oh = reinterpret_cast<__nv_bfloat162*>(&o);
      float v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float xv = i & 1 ? __bfloat1622float2(h[i / 2]).y : __bfloat1622float2(h[i / 2]).x;
        const float rr = i & 1 ? __bfloat1622float2(rh[i / 2]).y : __bfloat1622float2(rh[i / 2]).x;
        const float xhat = (xv - st.x) * st.y;
        const float g = gr[k + i];
        aw[c][i] += g * xhat;
        ab[c][i] += g;
        v[i] = rr + (g * ln_w[k + i] - m1 - xhat * m2) * st.y;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) oh[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      *reinterpret_cast<uint4*>(dx + (i64)row * K + k) = o;
    }
  }
  if (!part_w) return;
#pragma unroll
  for (int c = 0; c < LNB_MAXC; ++c) {
    const int k = c * 256 + lane * 8;
    if (k >= K) continue;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      part_w[(i64)wg * K + k + i] = aw[c][i];
      part_b[(i64)wg * K + k + i] = ab[c][i];
    }
  }
}

#endif

}  // namespace tvts
