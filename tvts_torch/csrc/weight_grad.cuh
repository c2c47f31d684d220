// Weight-gradient and LayerNorm-backward kernels of the training backward
// (H5, H6, H7): the products and reductions that the TPU backward kernels
// accumulate inside their bodies (tvts_tpu/ops/pallas_block_backward.py:
// 3167-3174, pallas_text_attention.py:225-257) into fp32 output refs carried
// across the sequential grid.
//
// CUDA blocks run in no order, so every reduction over the B*S rows is split:
// each block reduces its own chunk of rows into an f32 partial, and
// reduce_partials_kernel sums the partials in a fixed order. The result is
// deterministic, and no atomics are used.
//
// wgrad_kernel: C[N1, N2] = A^T B over M rows (A [M, N1], B [M, N2], both
// row-major bf16, f32 accumulation on the tensor cores with mma.sync). With
// `stats` B is LN(x), recomputed from the row statistics the forward saved and
// rounded to bf16 as the forward's qkv product saw it. With `colsum` the
// blocks of the first column tile also sum A's columns (the bias gradient).
// Bound on the H100: tensor-core issue (2*M*N1*N2 flops, M = 23,540 at B=20),
// with 128x128 output tiles, 32-row k steps through a double-buffered shared
// ring, and the rows split across blocks so that the 36 to 108 output tiles
// fill 132 SMs.
//
// ln_bwd_kernel: dx = res + LN_bwd(dxln) row by row (one warp per row, two
// passes over the row), plus per-warp column partials of dxln * xhat and
// dxln (the LayerNorm weight and bias gradients). Bound by bytes.
#pragma once

#include "common.cuh"

namespace tvts {

constexpr int WG_BM = 128;  // output rows (columns of A)
constexpr int WG_BN = 128;  // output columns (columns of B)
constexpr int WG_BK = 32;   // reduction rows per step
constexpr int WG_LDS = WG_BM + 8;
constexpr int WG_THREADS = 256;

struct WgradArgs {
  const bf16* A;
  i64 lda;
  const bf16* Bm;
  i64 ldb;
  const float2* stats;  // LayerNorm prologue on B (mean, rstd per row); null: none
  const float* ln_w;
  const float* ln_b;
  float* partial;  // [splits][N1][N2]
  float* colsum;   // [splits][N1] or null
  int M, N1, N2, rows_per_split;
};

__global__ void __launch_bounds__(WG_THREADS) wgrad_kernel(const WgradArgs a) {
  __shared__ __align__(16) bf16 sA[2][WG_BK][WG_LDS];
  __shared__ __align__(16) bf16 sB[2][WG_BK][WG_LDS];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps, 64 x 32 outputs each
  const int i0 = blockIdx.y * WG_BM, j0 = blockIdx.x * WG_BN, split = blockIdx.z;
  const int m_begin = split * a.rows_per_split;
  const int m_end = min(a.M, m_begin + a.rows_per_split);
  const bool do_colsum = a.colsum != nullptr && blockIdx.x == 0;

  // each thread moves rows lr and lr + 16 of both tiles, 8 columns at lc
  const int lr = tid >> 4, lc = (tid & 15) * 8;
  uint4 ra[2], rb[2];
  float2 st[2];
  auto load_global = [&](int kt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = m_begin + kt * WG_BK + lr + 16 * i;
      const bool ok = row < m_end;
      ra[i] = ok && i0 + lc < a.N1
                  ? *reinterpret_cast<const uint4*>(a.A + (i64)row * a.lda + i0 + lc)
                  : make_uint4(0, 0, 0, 0);
      rb[i] = ok && j0 + lc < a.N2
                  ? *reinterpret_cast<const uint4*>(a.Bm + (i64)row * a.ldb + j0 + lc)
                  : make_uint4(0, 0, 0, 0);
      st[i] = ok && a.stats ? a.stats[row] : make_float2(0.f, 0.f);
    }
  };
  auto store_smem = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      uint4 u = rb[i];
      if (a.stats && j0 + lc < a.N2) {
        __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
        const int k = j0 + lc;
        const float4 w0 = *reinterpret_cast<const float4*>(a.ln_w + k);
        const float4 w1 = *reinterpret_cast<const float4*>(a.ln_w + k + 4);
        const float4 b0 = *reinterpret_cast<const float4*>(a.ln_b + k);
        const float4 b1 = *reinterpret_cast<const float4*>(a.ln_b + k + 4);
        const float w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
        // rows past the split give LN(0) = b here, but their A row is zero
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float2 f = __bfloat1622float2(h[j]);
          f.x = (f.x - st[i].x) * st[i].y * w[2 * j] + b[2 * j];
          f.y = (f.y - st[i].x) * st[i].y * w[2 * j + 1] + b[2 * j + 1];
          h[j] = __floats2bfloat162_rn(f.x, f.y);
        }
      }
      *reinterpret_cast<uint4*>(&sA[buf][lr + 16 * i][lc]) = ra[i];
      *reinterpret_cast<uint4*>(&sB[buf][lr + 16 * i][lc]) = u;
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mi][ni][c] = 0.f;
  float csum = 0.f;

  const int KT = (m_end - m_begin + WG_BK - 1) / WG_BK;
  if (KT > 0) {
    load_global(0);
    store_smem(0);
  }
  __syncthreads();
  for (int kt = 0; kt < KT; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < KT) load_global(kt + 1);
    if (do_colsum && tid < WG_BM) {
#pragma unroll 8
      for (int k = 0; k < WG_BK; ++k) csum += __bfloat162float(sA[buf][k][tid]);
    }
#pragma unroll
    for (int kk = 0; kk < WG_BK; kk += 16) {
      // A^T fragments from the k-major A tile (ldmatrix .trans), B fragments
      // from the k-major B tile (.trans, as V in the attention cores)
      uint32_t af[4][4], bfr[4][2];
      const int j = lane >> 3, r = lane & 7;
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4_trans(af[mi], &sA[buf][kk + (j >> 1) * 8 + r][wm * 64 + mi * 16 + (j & 1) * 8]);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        uint32_t t[4];
        ldmatrix_x4_trans(t, &sB[buf][kk + r + (j & 1) * 8][wn * 32 + nj * 16 + (j >> 1) * 8]);
        bfr[2 * nj][0] = t[0];
        bfr[2 * nj][1] = t[1];
        bfr[2 * nj + 1][0] = t[2];
        bfr[2 * nj + 1][1] = t[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16_16816(acc[mi][ni], af[mi], bfr[ni][0], bfr[ni][1]);
    }
    if (kt + 1 < KT) store_smem(buf ^ 1);
    __syncthreads();
  }

  float* out = a.partial + (i64)split * a.N1 * a.N2;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = i0 + wm * 64 + mi * 16 + g + half * 8;
        const int col = j0 + wn * 32 + ni * 8 + t4 * 2;
        if (row >= a.N1 || col >= a.N2) continue;
        *reinterpret_cast<float2*>(out + (i64)row * a.N2 + col) =
            make_float2(acc[mi][ni][2 * half], acc[mi][ni][2 * half + 1]);
      }
  if (do_colsum && tid < WG_BM && i0 + tid < a.N1)
    a.colsum[(i64)split * a.N1 + i0 + tid] = csum;
}

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

}  // namespace tvts
