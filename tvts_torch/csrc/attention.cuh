// Attention cores of the divided space-time block, on the [B, S, 3D] qkv rows
// that ln_gemm writes (S = 1 + T*N, CLS first, frame-major patches; q is not
// pre-scaled, the cores scale the logits). All softmaxes are exact and
// max-shifted in f32. Training saves: with a non-null `lse` [B, H, S] f32 each
// core also writes the natural-log log-sum-exp of the scaled logits of every
// row it computes (row 0, the CLS row, from cls_combine_kernel), which the
// backward kernels (attention_bwd.cuh) use to recompute the probabilities.
//
// The same two cores are the attention cores on their own (H9, replacing
// tvts_tpu/ops/pallas_attention.py::_space_attention_fused and
// _time_attention_fused): with STRIDED = true they read separate q, k, v
// [B, H, S, d] tensors of any batch, head and row strides (q pre-scaled: the
// caller passes scale 1) and write an output laid out likewise. STRIDED is a
// template parameter, so the packed kernels of H1 / H2 keep their
// compile-time addressing.
#pragma once

#include <math.h>

#include <algorithm>

#include "common.cuh"

namespace tvts {

// Element strides (batch, head, row) of q, k, v and the output for the
// STRIDED cores; the last dimension is contiguous.
struct CoreStrides {
  i64 q[3], k[3], v[3], o[3];
};

// Row `tok` of head h of batch b of q (which = 0), k (1) or v (2). Packed: the
// [B, S, 3D] qkv rows at `q`; strided: three tensors.
template <int DH, bool STRIDED>
struct CoreAddr {
  const bf16 *q, *k, *v;
  bf16* o;
  int H, S;
  CoreStrides st;

  __device__ __forceinline__ const bf16* row(int which, int b, int h, i64 tok) const {
    if constexpr (STRIDED) {
      const bf16* p = which == 0 ? q : which == 1 ? k : v;
      const i64* s = which == 0 ? st.q : which == 1 ? st.k : st.v;
      return p + b * s[0] + h * s[1] + tok * s[2];
    } else {
      const int D = H * DH;
      return q + ((i64)b * S + tok) * 3 * D + which * D + h * DH;
    }
  }
  __device__ __forceinline__ bf16* out_row(int b, int h, i64 tok) const {
    if constexpr (STRIDED)
      return o + b * st.o[0] + h * st.o[1] + tok * st.o[2];
    else
      return o + ((i64)b * S + tok) * H * DH + h * DH;
  }
};

// ---------------------------------------------------------------------------
// Time core (H1 and H6's forward packed; H9 time strided). It replaces the
// time attention inside tvts_tpu/ops/pallas_block_attention.py::
// fused_time_attention_block_v7 (:2456) and pallas_attention.py::
// _time_attention_fused (:69). Patch (t, n) attends over the CLS key plus
// location n in every frame: per (b, n, h), T <= 32 queries over 1 + T keys.
// Bound on the H100: bytes (q, k and v read once, the output written once;
// the 13-key products at T = 12 are a few GFLOP at B = 64, far too small for
// the tensor cores to matter). Design: one block per (b, n, head group), a
// group of at most TIME_MAX_ROWS / T heads (6 of 12 at T = 12): small blocks,
// several on an SM, so that one block's loads overlap another's arithmetic
// (one block over all 12 heads holds 35 K registers and runs alone on its
// SM, its loads and then its math). 16-byte cp.async copies,
// neighbouring threads on neighbouring addresses, bring the T query rows and
// the 1 + T key and value rows of the group into shared memory as bf16 (the
// CLS key and value rows once a block, not once a head).
// A thread owns each (t, h) query row, with an exact max-shifted online f32
// softmax over the 1 + T keys in the first version's order of operations
// (its training-step gates sit near their limits at H/14: a logit summed in
// another order moved the worst gradient error from 0.102 to 0.124 against a
// limit of 0.12; PERF.md). Each output row
// goes back over its own query row in shared memory and leaves in 16-byte
// stores. Writes patch rows only (the CLS row is the split-KV kernel's).
// ---------------------------------------------------------------------------
constexpr int TIME_MAX_ROWS = 128;  // query rows (threads) a block

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

template <int DH, bool STRIDED>
__global__ void __launch_bounds__(TIME_MAX_ROWS, 2)
    time_core_kernel(const CoreAddr<DH, STRIDED> view, float* __restrict__ lse, int T, int N,
                     int HG, float scale) {
  extern __shared__ __align__(16) bf16 tsm[];
  constexpr int VPR = DH / 8;   // 16-byte vectors per head row
  const int n = blockIdx.x, b = blockIdx.y, h0 = blockIdx.z * HG;
  const int H = view.H, S = view.S;
  const int hg = min(HG, H - h0);
  const int RW = HG * DH;  // a token's row in shared memory: the group's heads
  bf16* sq = tsm;                // [T][RW]
  bf16* sk = sq + T * RW;        // [1 + T][RW], key s: s == 0 the CLS token, else frame s - 1
  bf16* sv = sk + (T + 1) * RW;  // [1 + T][RW]

  const int per_row = hg * VPR;
  for (int e = threadIdx.x; e < (3 * T + 2) * per_row; e += blockDim.x) {
    const int r = e / per_row, rem = e - r * per_row;
    const int hh = rem / VPR, c = rem - hh * VPR;
    int which, s;
    bf16* dst;
    if (r < T) {
      which = 0; s = r + 1; dst = sq + r * RW;
    } else if (r < 2 * T + 1) {
      which = 1; s = r - T; dst = sk + s * RW;
    } else {
      which = 2; s = r - 2 * T - 1; dst = sv + s * RW;
    }
    const i64 tok = s == 0 ? 0 : 1 + (i64)(s - 1) * N + n;
    cp_async16(dst + hh * DH + c * 8, view.row(which, b, h0 + hh, tok) + c * 8);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // thread q owns query row q = hh * T + t (neighbouring threads share a head:
  // their key and value reads are broadcasts); the arithmetic, its order
  // included, is the first version's: each logit one f32 chain over the head
  // dim, so that the training step's numerics do not move with the layout
  const int q = threadIdx.x;
  const bool live = q < T * hg;
  const int qc = live ? q : 0;
  const int hh = qc / T, t = qc - hh * T;
  float qf[DH], acc[DH];
#pragma unroll
  for (int i = 0; i < DH; i += 8) {
    float f[8];
    unpack_bf16x8(*reinterpret_cast<const uint4*>(sq + t * RW + hh * DH + i), f);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      qf[i + e] = f[e] * scale;
      acc[i + e] = 0.f;
    }
  }
  float m = -INFINITY, l = 0.f;
  for (int s = 0; s <= T; ++s) {
    const bf16* kr = sk + s * RW + hh * DH;
    float dot = 0.f;
#pragma unroll
    for (int i = 0; i < DH; i += 8) {
      float f[8];
      unpack_bf16x8(*reinterpret_cast<const uint4*>(kr + i), f);
#pragma unroll
      for (int e = 0; e < 8; ++e) dot += qf[i + e] * f[e];
    }
    const float m_new = fmaxf(m, dot);
    const float corr = __expf(m - m_new);
    const float p = __expf(dot - m_new);
    l = l * corr + p;
    const bf16* vr = sv + s * RW + hh * DH;
#pragma unroll
    for (int i = 0; i < DH; i += 8) {
      float f[8];
      unpack_bf16x8(*reinterpret_cast<const uint4*>(vr + i), f);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[i + e] = acc[i + e] * corr + p * f[e];
    }
    m = m_new;
  }
  if (live) {
    const float inv = 1.f / l;
#pragma unroll
    for (int i = 0; i < DH; i += 8) {
      float o[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) o[e] = acc[i + e] * inv;
      *reinterpret_cast<uint4*>(sq + t * RW + hh * DH + i) = pack_bf16x8(o);  // only q read it
    }
    if (lse) lse[((i64)b * H + h0 + hh) * S + 1 + (i64)t * N + n] = m + __logf(l);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < T * per_row; e += blockDim.x) {
    const int r = e / per_row, rem = e - r * per_row;
    const int h = rem / VPR, c = rem - h * VPR;
    *reinterpret_cast<uint4*>(view.out_row(b, h0 + h, 1 + (i64)r * N + n) + c * 8) =
        *reinterpret_cast<const uint4*>(sq + r * RW + h * DH + c * 8);
  }
}

// Heads a block takes: at most TIME_MAX_ROWS / T, the H heads split as evenly
// as that allows.
inline int time_core_heads(int T, int H) {
  const int cap = std::max(1, TIME_MAX_ROWS / T);
  const int groups = (H + cap - 1) / cap;
  return (H + groups - 1) / groups;
}

inline size_t time_core_smem(int T, int HG, int DH) { return (size_t)(3 * T + 2) * HG * DH * 2; }

// ---------------------------------------------------------------------------
// Space core. Patch (t, i) attends over the CLS key plus frame t's N patches:
// per (b, t, h), N queries over 1 + N keys, the CLS key being key 0. Flash
// style on the tensor cores: a block holds 64 queries (4 warps x 16 rows) and
// walks 64-key tiles with an online f32 softmax; ragged tiles are masked.
// ---------------------------------------------------------------------------
constexpr int SP_BQ = 64;
constexpr int SP_BK = 64;

template <int DH, bool STRIDED>
__global__ void __launch_bounds__(128)
    space_core_kernel(const CoreAddr<DH, STRIDED> view, float* __restrict__ lse, int T, int N,
                      float scale_log2) {
  constexpr int LD = DH + 8;
  __shared__ __align__(16) bf16 sQ[SP_BQ][LD];
  __shared__ __align__(16) bf16 sK[SP_BK][LD];
  __shared__ __align__(16) bf16 sV[SP_BK][LD];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * SP_BQ, h = blockIdx.y;
  const int b = blockIdx.z / T, t = blockIdx.z % T;
  const int H = view.H, S = view.S;
  const i64 frame_row0 = 1 + (i64)t * N;  // token row of patch 0 of frame t
  constexpr int VPR = DH / 8;             // 16-byte vectors per head row

  for (int e = tid; e < SP_BQ * VPR; e += 128) {
    const int r = e / VPR, c = (e % VPR) * 8;
    uint4 u = make_uint4(0, 0, 0, 0);
    if (q0 + r < N)
      u = *reinterpret_cast<const uint4*>(view.row(0, b, h, frame_row0 + q0 + r) + c);
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
        uk = *reinterpret_cast<const uint4*>(view.row(1, b, h, tok) + c);
        uv = *reinterpret_cast<const uint4*>(view.row(2, b, h, tok) + c);
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
    bf16* dst = view.out_row(b, h, frame_row0 + qi);
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
