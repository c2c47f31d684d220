// H4: the CLS-only space tail of the extraction forward, from x alone. It
// replaces tvts_tpu/ops/pallas_block_attention.py::fused_space_cls_only_v7
// (:3339, kernel body :3155-3217): out = basecls + Proj(softmax(q k^T / sqrt(d)) v)
// for the CLS query of each (b, h) over every token of the clip, with
// y = LN(x) rounded to bf16, q = Wq y_0 + bq, k = Wk y + bk, v = Wv y + bv
// (q, k and v kept in f32, as the TPU kernel keeps them).
//
// The per-frame queries are dead, and k and v are linear in y, so the function
// is computed without them (the absorbed form):
//   u_h   = Wk_h^T q_h / sqrt(d)                     (the logit of key j is
//   l_hj  = y_j . u_h  (+ q_h . bk_h / sqrt(d), the   same for every key: it
//                       drops out of the softmax)
//   z_h   = sum_j p_hj y_j,  p_hj = softmax_j(l_hj)
//   att_h = Wv_h z_h + bv_h,  out = basecls + Wproj att + bproj.
// Bound on the H100: bytes. x is read once (B*S*D bf16: 231 MB at B/16,
// B = 64, 0.069 ms), the four D x D weights once; the two products over the
// tokens (Y u^T and P^T Y, ~5.6 GFLOP at B = 64) are far below the tensor-core
// line. Design, six launches:
//   cls_matvec_kernel (LayerNorm on the staged CLS rows) -> q [B, D] f32;
//   cls_u_kernel -> u [B, H, D] f32;
//   cls_pool_kernel, one pass over x: a block takes a chunk of rows of one
//     clip in steps of 16 rows (cp.async double buffer; two blocks an SM up
//     to D = 768, one above), forms y = LN(x) in
//     shared memory, the logits of all heads (mma.sync, u split into a bf16
//     high and low part so the product keeps ~16 bits), an online softmax per
//     head, and z_h += P^T Y (mma.sync, P split likewise) in registers; it
//     writes an f32 partial (m, l, z[D]) per head;
//   cls_pool_merge_kernel merges the chunks in a fixed order (no atomics);
//   cls_matvec_kernel -> att = Wv_h z_h + bv (bf16), then
//   cls_matvec_kernel -> out = basecls + Wproj att + bproj.
#pragma once

#include <math.h>

#include "common.cuh"

namespace tvts {

// ---------------------------------------------------------------------------
// out[b, n] = W[n, :] . in_b,g + bias[n] (+ res[b, n]) for a few batch rows:
// in_b,g is row b of `in` for the group g = n / group_rows (a head: the att
// product reads head h's z for the rows of head h), optionally
// LayerNormed and rounded to bf16 as it is staged. A block: 16 output rows x
// 8 batch rows, the inputs staged in shared memory as f32, a warp per two
// output rows reading W in 16-byte vectors.
// ---------------------------------------------------------------------------
constexpr int MV_ROWS = 16;  // output rows a block: divides a head of 64 or 80
constexpr int MV_BATCH = 8;  // batch rows a block (one warp stages each)

struct ClsMatvecArgs {
  const bf16* W;
  const bf16* bias;
  const void* in;
  i64 in_bstride, in_gstride;
  int group_rows;
  const float* ln_w;
  const float* ln_b;
  float eps;
  const bf16* res;
  i64 res_bstride;
  void* out;
  i64 out_bstride;
  int B, N, K;
};

template <bool IN_F32, bool OUT_F32>
__global__ void __launch_bounds__(256) cls_matvec_kernel(const ClsMatvecArgs a) {
  extern __shared__ __align__(16) float s_in[];  // [MV_BATCH][K]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n0 = blockIdx.x * MV_ROWS, b0 = blockIdx.y * MV_BATCH;
  const int K = a.K;
  {
    const int b = b0 + warp;
    float* dst = s_in + warp * K;
    if (b < a.B) {
      const i64 off = (i64)b * a.in_bstride + (i64)(n0 / a.group_rows) * a.in_gstride;
#pragma unroll 8
      for (int k = lane; k < K; k += 32)
        dst[k] = IN_F32 ? static_cast<const float*>(a.in)[off + k]
                        : __bfloat162float(static_cast<const bf16*>(a.in)[off + k]);
      if (a.ln_w) {
        __syncwarp();
        float sum = 0.f;
        for (int k = lane; k < K; k += 32) sum += dst[k];
        const float mean = warp_sum(sum) / K;
        float sq = 0.f;
        for (int k = lane; k < K; k += 32) sq += (dst[k] - mean) * (dst[k] - mean);
        const float rstd = rsqrtf(warp_sum(sq) / K + a.eps);
        for (int k = lane; k < K; k += 32)
          dst[k] = __bfloat162float(
              __float2bfloat16((dst[k] - mean) * rstd * a.ln_w[k] + a.ln_b[k]));
      }
    } else {
      for (int k = lane; k < K; k += 32) dst[k] = 0.f;
    }
  }
  __syncthreads();
#pragma unroll
  for (int rr = 0; rr < MV_ROWS / 8; ++rr) {
    const int n = n0 + warp * (MV_ROWS / 8) + rr;  // < N: the grid covers N / MV_ROWS
    float acc[MV_BATCH];
#pragma unroll
    for (int bb = 0; bb < MV_BATCH; ++bb) acc[bb] = 0.f;
    const bf16* wr = a.W + (i64)n * K;
    for (int k = lane * 8; k < K; k += 256) {
      float w[8];
      unpack_bf16x8(*reinterpret_cast<const uint4*>(wr + k), w);
#pragma unroll
      for (int bb = 0; bb < MV_BATCH; ++bb) {
        const float4 x0 = *reinterpret_cast<const float4*>(s_in + bb * K + k);
        const float4 x1 = *reinterpret_cast<const float4*>(s_in + bb * K + k + 4);
        acc[bb] += w[0] * x0.x + w[1] * x0.y + w[2] * x0.z + w[3] * x0.w + w[4] * x1.x +
                   w[5] * x1.y + w[6] * x1.z + w[7] * x1.w;
      }
    }
    float mine = 0.f;
#pragma unroll
    for (int bb = 0; bb < MV_BATCH; ++bb) {
      const float v = warp_sum(acc[bb]);
      if (lane == bb) mine = v;
    }
    const int b = b0 + lane;
    if (lane < MV_BATCH && b < a.B) {
      if (a.bias) mine += __bfloat162float(a.bias[n]);
      if (a.res) mine += __bfloat162float(a.res[(i64)b * a.res_bstride + n]);
      if (OUT_F32)
        static_cast<float*>(a.out)[(i64)b * a.out_bstride + n] = mine;
      else
        static_cast<bf16*>(a.out)[(i64)b * a.out_bstride + n] = __float2bfloat16(mine);
    }
  }
}

// u[b, h, :] = scale * Wk_h^T q[b, h*DH : (h+1)*DH]; Wk [H*DH, D] rows in the
// nn.Linear layout. A block per (h, 8 batch rows, 128 column pairs); a thread
// per column pair.
constexpr int U_THREADS = 128;

__global__ void __launch_bounds__(U_THREADS)
    cls_u_kernel(const float* __restrict__ q, const bf16* __restrict__ Wk, float* __restrict__ u,
                 int B, int H, int DH, float scale) {
  __shared__ float sq[MV_BATCH][128];
  const int h = blockIdx.x, b0 = blockIdx.y * MV_BATCH, D = H * DH;
  for (int e = threadIdx.x; e < MV_BATCH * DH; e += blockDim.x) {
    const int bb = e / DH, i = e % DH;
    sq[bb][i] = b0 + bb < B ? q[(i64)(b0 + bb) * D + h * DH + i] : 0.f;
  }
  __syncthreads();
  const int c = 2 * (blockIdx.z * U_THREADS + threadIdx.x);
  if (c < D) {
    float acc[MV_BATCH][2];
#pragma unroll
    for (int bb = 0; bb < MV_BATCH; ++bb) acc[bb][0] = acc[bb][1] = 0.f;
#pragma unroll 8
    for (int i = 0; i < DH; ++i) {
      const float2 w = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(Wk + (i64)(h * DH + i) * D + c));
#pragma unroll
      for (int bb = 0; bb < MV_BATCH; ++bb) {
        acc[bb][0] += sq[bb][i] * w.x;
        acc[bb][1] += sq[bb][i] * w.y;
      }
    }
#pragma unroll
    for (int bb = 0; bb < MV_BATCH; ++bb)
      if (b0 + bb < B)
        *reinterpret_cast<float2*>(u + ((i64)(b0 + bb) * H + h) * D + c) =
            make_float2(acc[bb][0] * scale, acc[bb][1] * scale);
  }
}

// ---------------------------------------------------------------------------
// The pass over x (module notes). Block (c, b): rows [c*R, min(S, (c+1)*R)) of
// clip b, 16 at a time. MAXP: 16-column pairs a warp owns for z (pair p to
// warp p % 8), ceil(D / 128); z of heads (g, g + 8) x those columns lives in
// registers for the whole chunk.
// ---------------------------------------------------------------------------
constexpr int CP_THREADS = 256;
constexpr int CP_ROWS = 16;   // token rows a step
constexpr int CP_HEADS = 16;  // heads padded to one m16 tile
constexpr int CP_PLD = 24;    // row length of the P tiles (16 rows + padding)

inline size_t cls_pool_smem(int D) {
  const size_t LD = D + 8;
  return 2 * CP_ROWS * LD * 2       // x / y, double buffered
         + 2 * CP_HEADS * LD * 2    // u high and low parts
         + 8 * CP_ROWS * CP_HEADS * 4  // the warps' partial logits
         + 2 * CP_HEADS * CP_PLD * 2   // P high and low parts
         + CP_HEADS * 4                // the step's rescale factor per head
         + 2 * (size_t)D * 4;          // the LayerNorm weight and bias (L1 is nearly all
                                       // shared memory here: global reads of them stall)
}

template <int MAXP>
__global__ void __launch_bounds__(CP_THREADS)
    cls_pool_kernel(const bf16* __restrict__ x, int S, int D, int H,
                    const float* __restrict__ ln_w, const float* __restrict__ ln_b, float eps,
                    const float* __restrict__ u, int R, float* __restrict__ partial) {
  constexpr int VMAX = (MAXP * 16 + 31) / 32;  // 16-byte vectors of a row a lane takes
  extern __shared__ __align__(16) unsigned char cp_smem[];
  const int LD = D + 8;
  bf16* sX = reinterpret_cast<bf16*>(cp_smem);  // [2][CP_ROWS][LD]
  bf16* sUh = sX + 2 * CP_ROWS * LD;            // [CP_HEADS][LD]
  bf16* sUl = sUh + CP_HEADS * LD;
  float* red = reinterpret_cast<float*>(sUl + CP_HEADS * LD);  // [8][CP_ROWS][CP_HEADS]
  bf16* sPh = reinterpret_cast<bf16*>(red + 8 * CP_ROWS * CP_HEADS);  // [CP_HEADS][CP_PLD]
  bf16* sPl = sPh + CP_HEADS * CP_PLD;
  float* sCorr = reinterpret_cast<float*>(sPl + CP_HEADS * CP_PLD);
  float* sLnW = sCorr + CP_HEADS;  // [D]
  float* sLnB = sLnW + D;          // [D]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int c = blockIdx.x, b = blockIdx.y, C = gridDim.x;
  const int row0 = c * R, row_end = min(S, row0 + R);
  const int n_steps = row_end > row0 ? (row_end - row0 + CP_ROWS - 1) / CP_ROWS : 0;
  const int VPR = D / 8;
  const bf16* xb = x + (i64)b * S * D;

  auto stage = [&](int step) {
    bf16* dst = sX + (step & 1) * CP_ROWS * LD;
    const int r0 = row0 + step * CP_ROWS;
    for (int e = tid; e < CP_ROWS * VPR; e += CP_THREADS) {
      const int r = e / VPR, col = (e % VPR) * 8;
      if (r0 + r < row_end)
        cp_async16(dst + r * LD + col, xb + (i64)(r0 + r) * D + col);
      else
        *reinterpret_cast<uint4*>(dst + r * LD + col) = make_uint4(0, 0, 0, 0);
    }
    cp_async_commit();
  };
  if (n_steps > 0) stage(0);

  // u of this clip, split into bf16 high and low parts (heads >= H zero), and
  // the LayerNorm parameters; 16-byte loads, several in flight a thread
  const int D4 = D / 4;
#pragma unroll 4
  for (int e = tid; e < CP_HEADS * D4; e += CP_THREADS) {
    const int hh = e / D4, col = (e - hh * D4) * 4;
    const float4 v = hh < H ? *reinterpret_cast<const float4*>(u + ((i64)b * H + hh) * D + col)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
    const __nv_bfloat162 h01 = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 h23 = __floats2bfloat162_rn(v.z, v.w);
    const float2 f01 = __bfloat1622float2(h01), f23 = __bfloat1622float2(h23);
    *reinterpret_cast<__nv_bfloat162*>(sUh + hh * LD + col) = h01;
    *reinterpret_cast<__nv_bfloat162*>(sUh + hh * LD + col + 2) = h23;
    *reinterpret_cast<__nv_bfloat162*>(sUl + hh * LD + col) =
        __floats2bfloat162_rn(v.x - f01.x, v.y - f01.y);
    *reinterpret_cast<__nv_bfloat162*>(sUl + hh * LD + col + 2) =
        __floats2bfloat162_rn(v.z - f23.x, v.w - f23.y);
  }
  for (int e = tid; e < D4; e += CP_THREADS) {
    reinterpret_cast<float4*>(sLnW)[e] = reinterpret_cast<const float4*>(ln_w)[e];
    reinterpret_cast<float4*>(sLnB)[e] = reinterpret_cast<const float4*>(ln_b)[e];
  }

  float z[MAXP][2][4];
#pragma unroll
  for (int pi = 0; pi < MAXP; ++pi)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) z[pi][nt][0] = z[pi][nt][1] = z[pi][nt][2] = z[pi][nt][3] = 0.f;
  // the softmax state of head tid / 16, held alike by its 16 threads
  const int my_head = tid >> 4, my_row = tid & 15;
  float m_h = -INFINITY, l_h = 0.f;
  const int n_pairs = D / 16;

  for (int step = 0; step < n_steps; ++step) {
    if (step + 1 < n_steps) {
      stage(step + 1);
      cp_async_wait_pending(1);
    } else {
      cp_async_wait_pending(0);
    }
    __syncthreads();
    bf16* sY = sX + (step & 1) * CP_ROWS * LD;
    const int live = min(CP_ROWS, row_end - (row0 + step * CP_ROWS));

    // y = LN(x) in place, rounded to bf16; warp w takes rows w and w + 8 (one
    // at a time: both at once take 167 registers, one block an SM)
    for (int r = warp; r < live; r += 8) {
      float f[VMAX][8];
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < VMAX; ++i) {
        const int v = lane + 32 * i;
        if (v < VPR) {
          unpack_bf16x8(*reinterpret_cast<const uint4*>(sY + r * LD + v * 8), f[i]);
#pragma unroll
          for (int e = 0; e < 8; ++e) sum += f[i][e];
        }
      }
      const float mean = warp_sum(sum) / D;
      float sq = 0.f;
#pragma unroll
      for (int i = 0; i < VMAX; ++i)
        if (lane + 32 * i < VPR)
#pragma unroll
          for (int e = 0; e < 8; ++e) sq += (f[i][e] - mean) * (f[i][e] - mean);
      const float rstd = rsqrtf(warp_sum(sq) / D + eps);
#pragma unroll
      for (int i = 0; i < VMAX; ++i) {
        const int v = lane + 32 * i;
        if (v < VPR) {
          const float4* w4 = reinterpret_cast<const float4*>(sLnW + v * 8);
          const float4* b4 = reinterpret_cast<const float4*>(sLnB + v * 8);
          const float w[8] = {w4[0].x, w4[0].y, w4[0].z, w4[0].w,
                              w4[1].x, w4[1].y, w4[1].z, w4[1].w};
          const float bb[8] = {b4[0].x, b4[0].y, b4[0].z, b4[0].w,
                               b4[1].x, b4[1].y, b4[1].z, b4[1].w};
          float y[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) y[e] = (f[i][e] - mean) * rstd * w[e] + bb[e];
          *reinterpret_cast<uint4*>(sY + r * LD + v * 8) = pack_bf16x8(y);
        }
      }
    }
    __syncthreads();

    // logits [16 rows x 16 heads] = Y u^T, the k steps split over the warps
    {
      float lg[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};  // u's high part
      float lo[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};  // u's low part
      const int j = lane >> 3;
      for (int ks = warp; ks < D / 16; ks += 8) {
        uint32_t ya[4], uh[4], ul[4];
        ldmatrix_x4(ya, sY + (lane & 15) * LD + ks * 16 + (lane >> 4) * 8);
        ldmatrix_x4(uh, sUh + ((lane & 7) + (j >> 1) * 8) * LD + ks * 16 + (j & 1) * 8);
        ldmatrix_x4(ul, sUl + ((lane & 7) + (j >> 1) * 8) * LD + ks * 16 + (j & 1) * 8);
        mma_bf16_16816(lg[0], ya, uh[0], uh[1]);
        mma_bf16_16816(lg[1], ya, uh[2], uh[3]);
        mma_bf16_16816(lo[0], ya, ul[0], ul[1]);
        mma_bf16_16816(lo[1], ya, ul[2], ul[3]);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          red[(warp * CP_ROWS + g + (e >> 1) * 8) * CP_HEADS + nt * 8 + t4 * 2 + (e & 1)] =
              lg[nt][e] + lo[nt][e];
    }
    __syncthreads();

    // online softmax of head my_head over the step's rows (natural-log units)
    {
      float logit = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w) logit += red[(w * CP_ROWS + my_row) * CP_HEADS + my_head];
      if (my_row >= live || my_head >= H) logit = -INFINITY;
      float tmax = logit;
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
      const float m_new = fmaxf(m_h, tmax);
      const bool dead = m_new == -INFINITY;  // a padding head
      const float corr = dead ? 1.f : __expf(m_h - m_new);
      const float p = dead ? 0.f : __expf(logit - m_new);
      float psum = p;
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, o);
      l_h = l_h * corr + psum;
      m_h = m_new;
      const bf16 hi = __float2bfloat16(p);
      sPh[my_head * CP_PLD + my_row] = hi;
      sPl[my_head * CP_PLD + my_row] = __float2bfloat16(p - __bfloat162float(hi));
      if (my_row == 0) sCorr[my_head] = corr;
    }
    __syncthreads();

    // z[heads x columns] = z * corr + P^T Y for this warp's column pairs
    {
      uint32_t ph[4], pl[4];
      ldmatrix_x4(ph, sPh + (lane & 15) * CP_PLD + (lane >> 4) * 8);
      ldmatrix_x4(pl, sPl + (lane & 15) * CP_PLD + (lane >> 4) * 8);
      const float c0 = sCorr[g], c1 = sCorr[g + 8];
#pragma unroll
      for (int pi = 0; pi < MAXP; ++pi) {
        const int pair = warp + pi * 8;
        if (pair >= n_pairs) continue;
        uint32_t yf[4];
        ldmatrix_x4_trans(yf, sY + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + pair * 16 +
                                  ((lane >> 4) & 1) * 8);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          z[pi][nt][0] *= c0;
          z[pi][nt][1] *= c0;
          z[pi][nt][2] *= c1;
          z[pi][nt][3] *= c1;
        }
        mma_bf16_16816(z[pi][0], ph, yf[0], yf[1]);
        mma_bf16_16816(z[pi][1], ph, yf[2], yf[3]);
        mma_bf16_16816(z[pi][0], pl, yf[0], yf[1]);
        mma_bf16_16816(z[pi][1], pl, yf[2], yf[3]);
      }
    }
    __syncthreads();  // the buffer is staged again two steps on
  }

  // the partial of each head: [B, C, H, D + 2] = (m, l, z[D])
  float* out = partial + ((i64)b * C + c) * H * (D + 2);
  if (my_row == 0 && my_head < H) {
    out[my_head * (D + 2)] = m_h;
    out[my_head * (D + 2) + 1] = l_h;
  }
#pragma unroll
  for (int pi = 0; pi < MAXP; ++pi) {
    const int pair = warp + pi * 8;
    if (pair >= n_pairs) continue;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int head = g + r * 8;
        if (head < H)
          *reinterpret_cast<float2*>(out + head * (D + 2) + 2 + pair * 16 + nt * 8 + t4 * 2) =
              make_float2(z[pi][nt][2 * r], z[pi][nt][2 * r + 1]);
      }
  }
}

// zf[b, h, :] = the merged z of (b, h) over its C chunks, divided by the
// merged l: the softmax-weighted mean of y. Chunks in a fixed order.
__global__ void __launch_bounds__(256)
    cls_pool_merge_kernel(const float* __restrict__ partial, int C, int H, int D,
                          float* __restrict__ zf) {
  const int h = blockIdx.x, b = blockIdx.y;
  const i64 cstride = (i64)H * (D + 2);
  const float* p = partial + (i64)b * C * cstride + (i64)h * (D + 2);
  float mx = -INFINITY;
  for (int c = 0; c < C; ++c) mx = fmaxf(mx, p[c * cstride]);
  float lsum = 0.f;
  for (int c = 0; c < C; ++c) lsum += __expf(p[c * cstride] - mx) * p[c * cstride + 1];
  const float inv = 1.f / lsum;
  for (int col = threadIdx.x; col < D; col += blockDim.x) {
    float acc = 0.f;
    for (int c = 0; c < C; ++c) acc += __expf(p[c * cstride] - mx) * p[c * cstride + 2 + col];
    zf[((i64)b * H + h) * D + col] = acc * inv;
  }
}

}  // namespace tvts
