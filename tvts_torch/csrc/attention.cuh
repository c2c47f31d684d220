// Attention cores of the divided space-time block, on the [B, S, 3D] qkv rows
// that ln_gemm writes (S = 1 + T*N, CLS first, frame-major patches; q is not
// pre-scaled, the cores scale the logits). All softmaxes are exact and
// max-shifted in f32. Training saves: with a non-null `lse` [B, H, S] f32 each
// core also writes the natural-log log-sum-exp of the scaled logits of every
// row it computes (row 0, the CLS row, from cls_combine_kernel), which the
// backward kernels (attention_bwd.cuh) use to recompute the probabilities.
#pragma once

#include <math.h>

#include "common.cuh"

namespace tvts {

// ---------------------------------------------------------------------------
// Time core. Patch (t, n) attends over the CLS key plus location n in every
// frame: per (b, n, h), T <= 32 queries over 1 + T keys. Too small for the
// tensor cores; one warp per (b, n, h), lane t owns query t, keys and values
// broadcast from shared memory, online f32 softmax. Writes patch rows only.
// ---------------------------------------------------------------------------
constexpr int TIME_WARPS = 4;

template <int DH>
__global__ void __launch_bounds__(TIME_WARPS * 32)
    time_core_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out,
                     float* __restrict__ lse, int T, int N, int H, float scale) {
  extern __shared__ float tsm[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = blockIdx.x, b = blockIdx.y;
  const int D = H * DH, S = 1 + T * N;
  const int QS = DH + 1;  // padded query rows: lane t reads row t conflict-free
  float* sq = tsm + warp * (T * QS + 2 * (T + 1) * DH);
  float* sk = sq + T * QS;
  float* sv = sk + (T + 1) * DH;
  const bf16* base = qkv + (i64)b * S * 3 * D;

  for (int h = warp; h < H; h += TIME_WARPS) {
    // key/value row s: s == 0 is the CLS token, s >= 1 is frame s-1 at n
    for (int r = 0; r < 3 * T + 2; ++r) {
      int tok, col;
      float* dst;
      if (r < T) {
        tok = 1 + r * N + n; col = h * DH; dst = sq + r * QS;
      } else if (r < 2 * T + 1) {
        const int s = r - T;
        tok = s == 0 ? 0 : 1 + (s - 1) * N + n; col = D + h * DH; dst = sk + s * DH;
      } else {
        const int s = r - 2 * T - 1;
        tok = s == 0 ? 0 : 1 + (s - 1) * N + n; col = 2 * D + h * DH; dst = sv + s * DH;
      }
      const __nv_bfloat162* src =
          reinterpret_cast<const __nv_bfloat162*>(base + (i64)tok * 3 * D + col);
      for (int e = lane; e < DH / 2; e += 32) {
        const float2 f = __bfloat1622float2(src[e]);
        dst[2 * e] = f.x;
        dst[2 * e + 1] = f.y;
      }
    }
    __syncwarp();
    if (lane < T) {
      float q[DH], acc[DH];
#pragma unroll
      for (int i = 0; i < DH; ++i) {
        q[i] = sq[lane * QS + i] * scale;
        acc[i] = 0.f;
      }
      float m = -INFINITY, l = 0.f;
      for (int s = 0; s <= T; ++s) {
        const float* kr = sk + s * DH;
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < DH; ++i) dot += q[i] * kr[i];
        const float m_new = fmaxf(m, dot);
        const float corr = __expf(m - m_new);
        const float p = __expf(dot - m_new);
        l = l * corr + p;
        const float* vr = sv + s * DH;
#pragma unroll
        for (int i = 0; i < DH; ++i) acc[i] = acc[i] * corr + p * vr[i];
        m = m_new;
      }
      const float inv = 1.f / l;
#pragma unroll
      for (int i = 0; i < DH; ++i) sq[lane * QS + i] = acc[i] * inv;
      if (lse) lse[((i64)b * H + h) * S + 1 + lane * N + n] = m + __logf(l);
    }
    __syncwarp();
    for (int t = 0; t < T; ++t) {
      __nv_bfloat162* dst =
          reinterpret_cast<__nv_bfloat162*>(out + ((i64)b * S + 1 + t * N + n) * D + h * DH);
      for (int e = lane; e < DH / 2; e += 32)
        dst[e] = __floats2bfloat162_rn(sq[t * QS + 2 * e], sq[t * QS + 2 * e + 1]);
    }
    __syncwarp();
  }
}

inline size_t time_core_smem(int T, int DH) {
  return sizeof(float) * TIME_WARPS * (T * (DH + 1) + 2 * (T + 1) * DH);
}

// ---------------------------------------------------------------------------
// Space core. Patch (t, i) attends over the CLS key plus frame t's N patches:
// per (b, t, h), N queries over 1 + N keys, the CLS key being key 0. Flash
// style on the tensor cores: a block holds 64 queries (4 warps x 16 rows) and
// walks 64-key tiles with an online f32 softmax; ragged tiles are masked.
// ---------------------------------------------------------------------------
constexpr int SP_BQ = 64;
constexpr int SP_BK = 64;

template <int DH>
__global__ void __launch_bounds__(128)
    space_core_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out,
                      float* __restrict__ lse, int T, int N, int H, float scale_log2) {
  constexpr int LD = DH + 8;
  __shared__ __align__(16) bf16 sQ[SP_BQ][LD];
  __shared__ __align__(16) bf16 sK[SP_BK][LD];
  __shared__ __align__(16) bf16 sV[SP_BK][LD];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * SP_BQ, h = blockIdx.y;
  const int b = blockIdx.z / T, t = blockIdx.z % T;
  const int D = H * DH, S = 1 + T * N;
  const bf16* base = qkv + (i64)b * S * 3 * D;
  const i64 frame_row0 = 1 + (i64)t * N;  // token row of patch 0 of frame t
  constexpr int VPR = DH / 8;             // 16-byte vectors per head row

  for (int e = tid; e < SP_BQ * VPR; e += 128) {
    const int r = e / VPR, c = (e % VPR) * 8;
    uint4 u = make_uint4(0, 0, 0, 0);
    if (q0 + r < N)
      u = *reinterpret_cast<const uint4*>(base + (frame_row0 + q0 + r) * 3 * D + h * DH + c);
    *reinterpret_cast<uint4*>(&sQ[r][c]) = u;
  }
  __syncthreads();

  uint32_t qf[DH / 16][4];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    ldmatrix_x4(qf[kk], &sQ[warp * 16 + (lane & 15)][kk * 16 + (lane >> 4) * 8]);

  float o[DH / 8][4];
#pragma unroll
  for (int i = 0; i < DH / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int g = lane >> 2, t4 = lane & 3;
  const int n_keys = N + 1;

  for (int k0 = 0; k0 < n_keys; k0 += SP_BK) {
    __syncthreads();  // previous tile fully consumed
    for (int e = tid; e < SP_BK * VPR; e += 128) {
      const int r = e / VPR, c = (e % VPR) * 8;
      const int j = k0 + r;
      uint4 uk = make_uint4(0, 0, 0, 0), uv = uk;
      if (j < n_keys) {
        const i64 tok = j == 0 ? 0 : frame_row0 + j - 1;
        const bf16* row = base + tok * 3 * D + h * DH + c;
        uk = *reinterpret_cast<const uint4*>(row + D);
        uv = *reinterpret_cast<const uint4*>(row + 2 * D);
      }
      *reinterpret_cast<uint4*>(&sK[r][c]) = uk;
      *reinterpret_cast<uint4*>(&sV[r][c]) = uv;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys (8 n-tiles of 8 keys)
    float s[SP_BK / 8][4];
#pragma unroll
    for (int i = 0; i < SP_BK / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
      for (int np = 0; np < SP_BK / 16; ++np) {
        uint32_t kf[4];
        const int j = lane >> 3;
        ldmatrix_x4(kf, &sK[np * 16 + (lane & 7) + (j >> 1) * 8][kk * 16 + (j & 1) * 8]);
        mma_bf16_16816(s[2 * np], qf[kk], kf[0], kf[1]);
        mma_bf16_16816(s[2 * np + 1], qf[kk], kf[2], kf[3]);
      }

    // online softmax in the log2 domain; this thread owns rows g and g + 8
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < SP_BK / 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = k0 + nt * 8 + t4 * 2 + (c & 1);
        const float v = key < n_keys ? s[nt][c] * scale_log2 : -INFINITY;
        s[nt][c] = v;
        tmax[c >> 1] = fmaxf(tmax[c >> 1], v);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
      const float m_new = fmaxf(m[r], tmax[r]);  // finite: key 0 (CLS) is in tile 0
      corr[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int nt = 0; nt < SP_BK / 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = exp2f(s[nt][c] - m[c >> 1]);
        s[nt][c] = p;
        l[c >> 1] += p;
      }
#pragma unroll
    for (int i = 0; i < DH / 8; ++i) {
      o[i][0] *= corr[0];
      o[i][1] *= corr[0];
      o[i][2] *= corr[1];
      o[i][3] *= corr[1];
    }

    // O += P V: the S accumulator layout is the A-fragment layout of P
#pragma unroll
    for (int kt = 0; kt < SP_BK / 16; ++kt) {
      uint32_t pa[4];
      pa[0] = pack_bf16x2(s[2 * kt][0], s[2 * kt][1]);
      pa[1] = pack_bf16x2(s[2 * kt][2], s[2 * kt][3]);
      pa[2] = pack_bf16x2(s[2 * kt + 1][0], s[2 * kt + 1][1]);
      pa[3] = pack_bf16x2(s[2 * kt + 1][2], s[2 * kt + 1][3]);
#pragma unroll
      for (int dp = 0; dp < DH / 16; ++dp) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, &sV[kt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8]
                                 [dp * 16 + ((lane >> 4) & 1) * 8]);
        mma_bf16_16816(o[2 * dp], pa, vf[0], vf[1]);
        mma_bf16_16816(o[2 * dp + 1], pa, vf[2], vf[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int qi = q0 + warp * 16 + g + r * 8;
    if (lse && t4 == 0 && qi < N)  // m is in log2 units: lse = (m + log2 l) ln 2
      lse[((i64)b * H + h) * S + frame_row0 + qi] = (m[r] + __log2f(l[r])) * 0.6931471805599453f;
    l[r] = 1.f / l[r];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + warp * 16 + g + r * 8;
    if (qi >= N) continue;
    bf16* dst = out + ((i64)b * S + frame_row0 + qi) * D + h * DH;
#pragma unroll
    for (int i = 0; i < DH / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(dst + i * 8 + t4 * 2) =
          __floats2bfloat162_rn(o[i][2 * r] * l[r], o[i][2 * r + 1] * l[r]);
  }
}

// ---------------------------------------------------------------------------
// CLS global row: one query per (b, h) over L keys. The TPU kernels carry the
// online-softmax state across sequential grid steps; CUDA blocks run in no
// order, so this is split-KV: each block writes a partial (m, l, acc[DH]) in
// f32 for its chunk of keys, and cls_combine_kernel merges the chunks of each
// (b, h) in a fixed order (no atomics: the result does not vary run to run).
// ---------------------------------------------------------------------------
constexpr int CLS_CHUNK = 128;

template <int DH>
__global__ void __launch_bounds__(CLS_CHUNK)
    cls_partial_kernel(const bf16* __restrict__ q, i64 q_bstride, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, i64 kv_bstride, i64 kv_rstride, int L,
                       int H, float scale, float* __restrict__ partial) {
  __shared__ float sq[DH];
  __shared__ float sp[CLS_CHUNK];
  __shared__ float red[CLS_CHUNK / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nC = gridDim.x;
  for (int i = tid; i < DH; i += CLS_CHUNK)
    sq[i] = __bfloat162float(q[(i64)b * q_bstride + h * DH + i]) * scale;
  __syncthreads();

  const int j = c * CLS_CHUNK + tid;
  float logit = -INFINITY;
  if (j < L) {
    const bf16* kr = k + (i64)b * kv_bstride + (i64)j * kv_rstride + h * DH;
    float dot = 0.f;
#pragma unroll
    for (int i = 0; i < DH; i += 8) {
      uint4 u = *reinterpret_cast<const uint4*>(kr + i);
      const __nv_bfloat162* hv = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(hv[e]);
        dot += sq[i + 2 * e] * f.x + sq[i + 2 * e + 1] * f.y;
      }
    }
    logit = dot;
  }
  float mx = warp_max(logit);
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  mx = red[0];
#pragma unroll
  for (int w = 1; w < CLS_CHUNK / 32; ++w) mx = fmaxf(mx, red[w]);  // finite: j = c*CHUNK < L
  const float p = j < L ? __expf(logit - mx) : 0.f;
  sp[tid] = p;
  __syncthreads();
  float ls = warp_sum(p);
  if (lane == 0) red[warp] = ls;  // every thread read the max before the barrier above
  __syncthreads();

  float* out = partial + (((i64)b * H + h) * nC + c) * (DH + 2);
  const int nj = min(CLS_CHUNK, L - c * CLS_CHUNK);
  for (int i = tid; i < DH; i += CLS_CHUNK) {
    const bf16* vc = v + (i64)b * kv_bstride + (i64)c * CLS_CHUNK * kv_rstride + h * DH + i;
    float acc = 0.f;
    for (int jj = 0; jj < nj; ++jj) acc += sp[jj] * __bfloat162float(vc[(i64)jj * kv_rstride]);
    out[2 + i] = acc;
  }
  if (tid == 0) {
    float lsum = 0.f;
    for (int w = 0; w < CLS_CHUNK / 32; ++w) lsum += red[w];
    out[0] = mx;
    out[1] = lsum;
  }
}

template <int DH>
__global__ void cls_combine_kernel(const float* __restrict__ partial, int nC, int H,
                                   bf16* __restrict__ out, i64 out_bstride,
                                   float* __restrict__ lse, int lse_S) {
  const int h = blockIdx.x, b = blockIdx.y, i = threadIdx.x;
  const float* p = partial + ((i64)b * H + h) * nC * (DH + 2);
  float mx = -INFINITY;
  for (int c = 0; c < nC; ++c) mx = fmaxf(mx, p[c * (DH + 2)]);
  float lsum = 0.f, acc = 0.f;
  for (int c = 0; c < nC; ++c) {
    const float w = __expf(p[c * (DH + 2)] - mx);
    lsum += w * p[c * (DH + 2) + 1];
    acc += w * p[c * (DH + 2) + 2 + i];
  }
  out[(i64)b * out_bstride + h * DH + i] = __float2bfloat16(acc / lsum);
  if (lse && i == 0) lse[((i64)b * H + h) * lse_S] = mx + __logf(lsum);
}

}  // namespace tvts
