// Attention-core backward kernels of the training sub-paths: H5 (space), H6
// (time) and H7 (text / sort head). Inputs are the forward's saves: the qkv
// rows [B, S, 3D] (q not pre-scaled), the pre-projection attention output O
// [B, S, D], the natural-log lse [B, H, S] of every row's scaled logits, and
// dO = dL/dO [B, S, D] from the proj backward. Output: dqkv [B, S, 3D] bf16.
//
// Every core uses the delta identity of flash attention: with
// P = exp(scale q.k - lse), dP = dO.v and delta = rowsum(dO * O),
// dS = P * (dP - delta), dq = scale * dS k, dk = scale * dS^T q, dv = P^T dO.
// P is recomputed from the saved lse, so saved and recomputed probabilities
// (the TPU's pallas_v10 and pallas_v10r, or pallas_tps and pallas) are one
// schedule here.
//
// The CLS token is global: its query attends over every token (lse row 0),
// and its key/value join every group's softmax. Both backwards work on
// "groups" of tokens that include the CLS token as element 0: the space group
// of frame t is [CLS, the N patches of t], the time group of location n is
// [CLS, location n in each of the T frames]. Then every patch query and key
// of a group is complete within it (a patch key is seen by its group's patch
// queries and by the CLS query), and the CLS token's own dq, dk, dv are sums
// over groups: each group writes an f32 partial [B, G, H, 3, DH] and
// cls_grad_combine_kernel adds them in a fixed order (no atomics; the result
// does not vary run to run). The CLS query's logit on the CLS key belongs to
// group 0 only.
//
// Replaces the attention-core part of tvts_tpu/ops/pallas_block_backward.py::
// fused_time_attention_block_v2_bwd (:736, kernel :501; the TPU carries the
// CLS row's dq, dk, dv in scratch across its sequential grid),
// fused_space_attention_block_v10_bwd (:3106, kernel :2722) and
// pallas_text_attention.py::fused_text_attention_block_bwd (:264, kernel
// :134; whole [S, S] probabilities per head in VMEM). Bound on the H100: the
// time and space cores move bytes (qkv, dO and dqkv rows, ~10.7 KB a token at
// D = 768: 0.075 ms at B=20 against ~0.02 ms of their tensor-core work); the
// text core at the sort head's S = 1181 is bound by its 10 * D * S^2 flops per
// sequence. The flash kernels (the text core; the space core of a group too
// large for one block) recompute QK^T and dO V^T in both passes (dq; dk and
// dv); the one-pass space core stages its group once and computes both; the
// time core runs on SIMT lanes, a thread per (element, head) of a group. Each
// has its own section below.
#pragma once

#include <math.h>

#include <algorithm>

#include "common.cuh"

namespace tvts {

constexpr float LOG2E_F = 1.4426950408889634f;

// delta[b, h, s] = sum_d dO[b, s, h*DH + d] * O[b, s, h*DH + d]
template <int DH>
__global__ void attn_delta_kernel(const bf16* __restrict__ dO, const bf16* __restrict__ O,
                                  int B, int S, int H, float* __restrict__ delta) {
  const i64 idx = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (i64)B * S * H) return;
  const int h = idx % H;
  const i64 row = idx / H;
  const bf16* a = dO + row * H * DH + h * DH;
  const bf16* o = O + row * H * DH + h * DH;
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < DH; i += 8) {
    uint4 ua = *reinterpret_cast<const uint4*>(a + i);
    uint4 uo = *reinterpret_cast<const uint4*>(o + i);
    const __nv_bfloat162* ha = reinterpret_cast<const __nv_bfloat162*>(&ua);
    const __nv_bfloat162* ho = reinterpret_cast<const __nv_bfloat162*>(&uo);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 fa = __bfloat1622float2(ha[e]), fo = __bfloat1622float2(ho[e]);
      acc += fa.x * fo.x + fa.y * fo.y;
    }
  }
  const int b = row / S, s = row % S;
  delta[((i64)b * H + h) * S + s] = acc;
}

// ---------------------------------------------------------------------------
// Flash backward on the tensor cores (mma.sync m16n8k16, bf16 in, f32
// accumulate), for plain self-attention (SPACE = false: one group per
// sequence, element e = token e, causal or not) and for the space core
// (SPACE = true: one group per (b, t), element 0 the CLS token, element
// e >= 1 patch e - 1 of frame t). Two kernels, as in flash-attention 2:
// - flash_bwd_dq_kernel: a block owns 64 query elements (4 warps x 16) and
//   walks the 64-key tiles: dq = scale * sum dS k;
// - flash_bwd_dkv_kernel: a block owns 64 key elements and walks the query
//   tiles: dk = scale * sum dS^T q, dv = sum P^T dO.
// Each writes every output element once, so neither needs atomics. Ragged
// tiles load zeros and are masked to P = 0; with `causal` the tiles past the
// diagonal are skipped and the diagonal tile masked.
// ---------------------------------------------------------------------------
constexpr int FB_BQ = 64;
constexpr int FB_BK = 64;

struct FlashBwdArgs {
  const bf16* qkv;
  const bf16* dO;
  const float* lse;
  const float* delta;
  bf16* dqkv;
  float* cls_partial;  // SPACE: [B, T, H, 3, DH] f32
  int T, N, S, H;
  float scale;
  int causal;
};

template <bool SPACE>
__device__ __forceinline__ int group_token(int e, int t, int N) {
  if (SPACE) return e == 0 ? 0 : 1 + t * N + e - 1;
  return e;
}

// load rows [e0, e0 + 64) of a group's column block `col` (q: 0, k: D, v: 2D
// in qkv; 0 in dO) into a [64][DH + 8] tile; rows past L are zeros
template <int DH, bool SPACE>
__device__ __forceinline__ void load_group_tile(bf16 (*dst)[DH + 8], const bf16* base,
                                                i64 row_stride, int col, int e0, int L, int t,
                                                int N, int tid) {
  constexpr int VPR = DH / 8;
  for (int i = tid; i < 64 * VPR; i += 128) {
    const int r = i / VPR, c = (i % VPR) * 8;
    uint4 u = make_uint4(0, 0, 0, 0);
    if (e0 + r < L)
      u = *reinterpret_cast<const uint4*>(base + (i64)group_token<SPACE>(e0 + r, t, N) *
                                                     row_stride + col + c);
    *reinterpret_cast<uint4*>(&dst[r][c]) = u;
  }
}

// acc[16 x 64] (+)= A[16 x DH] B[64 x DH]^T, A rows warp*16.. of sA, B from sB
template <int DH>
__device__ __forceinline__ void mma_abt(float (&acc)[8][4], bf16 (*sA)[DH + 8],
                                        bf16 (*sB)[DH + 8], int warp, int lane) {
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    uint32_t af[4];
    ldmatrix_x4(af, &sA[warp * 16 + (lane & 15)][kk * 16 + (lane >> 4) * 8]);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t bfr[4];
      const int j = lane >> 3;
      ldmatrix_x4(bfr, &sB[np * 16 + (lane & 7) + (j >> 1) * 8][kk * 16 + (j & 1) * 8]);
      mma_bf16_16816(acc[2 * np], af, bfr[0], bfr[1]);
      mma_bf16_16816(acc[2 * np + 1], af, bfr[2], bfr[3]);
    }
  }
}

// out[16 x DH] += P[16 x 64] (accumulator layout, rounded to bf16) @ sV[64 x DH]
template <int DH>
__device__ __forceinline__ void mma_pv(float (&out)[DH / 8][4], const float (&p)[8][4],
                                       bf16 (*sV)[DH + 8], int lane) {
#pragma unroll
  for (int kt = 0; kt < 4; ++kt) {
    uint32_t pa[4];
    pa[0] = pack_bf16x2(p[2 * kt][0], p[2 * kt][1]);
    pa[1] = pack_bf16x2(p[2 * kt][2], p[2 * kt][3]);
    pa[2] = pack_bf16x2(p[2 * kt + 1][0], p[2 * kt + 1][1]);
    pa[3] = pack_bf16x2(p[2 * kt + 1][2], p[2 * kt + 1][3]);
#pragma unroll
    for (int dp = 0; dp < DH / 16; ++dp) {
      uint32_t vf[4];
      ldmatrix_x4_trans(vf, &sV[kt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8]
                               [dp * 16 + ((lane >> 4) & 1) * 8]);
      mma_bf16_16816(out[2 * dp], pa, vf[0], vf[1]);
      mma_bf16_16816(out[2 * dp + 1], pa, vf[2], vf[3]);
    }
  }
}

template <int DH, bool SPACE>
__global__ void __launch_bounds__(128) flash_bwd_dq_kernel(const FlashBwdArgs a) {
  __shared__ __align__(16) bf16 sQ[FB_BQ][DH + 8];
  __shared__ __align__(16) bf16 sdO[FB_BQ][DH + 8];
  __shared__ __align__(16) bf16 sK[FB_BK][DH + 8];
  __shared__ __align__(16) bf16 sV[FB_BK][DH + 8];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = blockIdx.x * FB_BQ, h = blockIdx.y;
  const int b = SPACE ? blockIdx.z / a.T : blockIdx.z, t = SPACE ? blockIdx.z % a.T : 0;
  const int L = SPACE ? a.N + 1 : a.S;
  const int D = a.H * DH;
  const bf16* qkv = a.qkv + (i64)b * a.S * 3 * D;
  const bf16* dO = a.dO + (i64)b * a.S * D;
  const float* lse = a.lse + ((i64)b * a.H + h) * a.S;
  const float* delta = a.delta + ((i64)b * a.H + h) * a.S;
  const float scale_log2 = a.scale * LOG2E_F;

  load_group_tile<DH, SPACE>(sQ, qkv, 3 * D, h * DH, q0, L, t, a.N, tid);
  load_group_tile<DH, SPACE>(sdO, dO, D, h * DH, q0, L, t, a.N, tid);
  float lse2[2], dl[2];
  int qe[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qe[r] = q0 + warp * 16 + g + r * 8;
    const bool ok = qe[r] < L;
    const int tok = ok ? group_token<SPACE>(qe[r], t, a.N) : 0;
    lse2[r] = ok ? lse[tok] * LOG2E_F : INFINITY;
    dl[r] = ok ? delta[tok] : 0.f;
  }

  float dq[DH / 8][4];
#pragma unroll
  for (int i = 0; i < DH / 8; ++i) dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;
  const int k_end = a.causal ? min(L, q0 + FB_BQ) : L;

  for (int k0 = 0; k0 < k_end; k0 += FB_BK) {
    __syncthreads();  // previous tile fully consumed (and sQ / sdO written)
    load_group_tile<DH, SPACE>(sK, qkv, 3 * D, D + h * DH, k0, L, t, a.N, tid);
    load_group_tile<DH, SPACE>(sV, qkv, 3 * D, 2 * D + h * DH, k0, L, t, a.N, tid);
    __syncthreads();
    float s[8][4], dp[8][4];
    mma_abt<DH>(s, sQ, sK, warp, lane);
    mma_abt<DH>(dp, sdO, sV, warp, lane);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = k0 + nt * 8 + t4 * 2 + (c & 1), r = c >> 1;
        const bool masked = key >= L || (a.causal && key > qe[r]) ||
                            (SPACE && t != 0 && key == 0 && qe[r] == 0);
        const float p = masked ? 0.f : exp2f(s[nt][c] * scale_log2 - lse2[r]);
        s[nt][c] = p * (dp[nt][c] - dl[r]);  // dS
      }
    mma_pv<DH>(dq, s, sK, lane);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qe[r] >= L) continue;
    if (SPACE && qe[r] == 0) {
      float* dst = a.cls_partial + ((((i64)b * a.T + t) * a.H + h) * 3 + 0) * DH;
#pragma unroll
      for (int i = 0; i < DH / 8; ++i)
        *reinterpret_cast<float2*>(dst + i * 8 + t4 * 2) =
            make_float2(dq[i][2 * r] * a.scale, dq[i][2 * r + 1] * a.scale);
      continue;
    }
    bf16* dst = a.dqkv + ((i64)b * a.S + group_token<SPACE>(qe[r], t, a.N)) * 3 * D + h * DH;
#pragma unroll
    for (int i = 0; i < DH / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(dst + i * 8 + t4 * 2) =
          __floats2bfloat162_rn(dq[i][2 * r] * a.scale, dq[i][2 * r + 1] * a.scale);
  }
}

template <int DH, bool SPACE>
__global__ void __launch_bounds__(128) flash_bwd_dkv_kernel(const FlashBwdArgs a) {
  __shared__ __align__(16) bf16 sK[FB_BK][DH + 8];
  __shared__ __align__(16) bf16 sV[FB_BK][DH + 8];
  __shared__ __align__(16) bf16 sQ[FB_BQ][DH + 8];
  __shared__ __align__(16) bf16 sdO[FB_BQ][DH + 8];
  __shared__ float s_lse2[FB_BQ], s_delta[FB_BQ];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int k0 = blockIdx.x * FB_BK, h = blockIdx.y;
  const int b = SPACE ? blockIdx.z / a.T : blockIdx.z, t = SPACE ? blockIdx.z % a.T : 0;
  const int L = SPACE ? a.N + 1 : a.S;
  const int D = a.H * DH;
  const bf16* qkv = a.qkv + (i64)b * a.S * 3 * D;
  const bf16* dO = a.dO + (i64)b * a.S * D;
  const float* lse = a.lse + ((i64)b * a.H + h) * a.S;
  const float* delta = a.delta + ((i64)b * a.H + h) * a.S;
  const float scale_log2 = a.scale * LOG2E_F;

  load_group_tile<DH, SPACE>(sK, qkv, 3 * D, D + h * DH, k0, L, t, a.N, tid);
  load_group_tile<DH, SPACE>(sV, qkv, 3 * D, 2 * D + h * DH, k0, L, t, a.N, tid);
  int ke[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) ke[r] = k0 + warp * 16 + g + r * 8;

  float dk[DH / 8][4], dv[DH / 8][4];
#pragma unroll
  for (int i = 0; i < DH / 8; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk[i][c] = dv[i][c] = 0.f;

  for (int q0 = a.causal ? k0 : 0; q0 < L; q0 += FB_BQ) {
    __syncthreads();  // previous tile fully consumed (and sK / sV written)
    load_group_tile<DH, SPACE>(sQ, qkv, 3 * D, h * DH, q0, L, t, a.N, tid);
    load_group_tile<DH, SPACE>(sdO, dO, D, h * DH, q0, L, t, a.N, tid);
    if (tid < FB_BQ) {
      const int e = q0 + tid;
      const int tok = e < L ? group_token<SPACE>(e, t, a.N) : 0;
      s_lse2[tid] = e < L ? lse[tok] * LOG2E_F : INFINITY;
      s_delta[tid] = e < L ? delta[tok] : 0.f;
    }
    __syncthreads();
    // transposed tiles: rows are this warp's 16 keys, columns 64 queries
    float p[8][4], ds[8][4];
    mma_abt<DH>(p, sK, sQ, warp, lane);
    mma_abt<DH>(ds, sV, sdO, warp, lane);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int ql = nt * 8 + t4 * 2 + (c & 1), query = q0 + ql, key = ke[c >> 1];
        const bool masked = query >= L || key >= L || (a.causal && key > query) ||
                            (SPACE && t != 0 && key == 0 && query == 0);
        const float pv = masked ? 0.f : exp2f(p[nt][c] * scale_log2 - s_lse2[ql]);
        p[nt][c] = pv;
        ds[nt][c] = pv * (ds[nt][c] - s_delta[ql]);
      }
    mma_pv<DH>(dv, p, sdO, lane);
    mma_pv<DH>(dk, ds, sQ, lane);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (ke[r] >= L) continue;
    if (SPACE && ke[r] == 0) {
      float* dst = a.cls_partial + (((i64)b * a.T + t) * a.H + h) * 3 * DH;
#pragma unroll
      for (int i = 0; i < DH / 8; ++i) {
        *reinterpret_cast<float2*>(dst + DH + i * 8 + t4 * 2) =
            make_float2(dk[i][2 * r] * a.scale, dk[i][2 * r + 1] * a.scale);
        *reinterpret_cast<float2*>(dst + 2 * DH + i * 8 + t4 * 2) =
            make_float2(dv[i][2 * r], dv[i][2 * r + 1]);
      }
      continue;
    }
    bf16* dst = a.dqkv + ((i64)b * a.S + group_token<SPACE>(ke[r], t, a.N)) * 3 * D + h * DH;
#pragma unroll
    for (int i = 0; i < DH / 8; ++i) {
      *reinterpret_cast<__nv_bfloat162*>(dst + D + i * 8 + t4 * 2) =
          __floats2bfloat162_rn(dk[i][2 * r] * a.scale, dk[i][2 * r + 1] * a.scale);
      *reinterpret_cast<__nv_bfloat162*>(dst + 2 * D + i * 8 + t4 * 2) =
          __floats2bfloat162_rn(dv[i][2 * r], dv[i][2 * r + 1]);
    }
  }
}

// the two kernels of one flash backward, B sequences (SPACE: B * T groups)
template <int DH, bool SPACE>
inline cudaError_t launch_flash_bwd(const FlashBwdArgs& a, int B, cudaStream_t s) {
  const int L = SPACE ? a.N + 1 : a.S;
  const unsigned z = SPACE ? B * a.T : B;
  flash_bwd_dq_kernel<DH, SPACE><<<dim3((L + FB_BQ - 1) / FB_BQ, a.H, z), 128, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_kernel<DH, SPACE><<<dim3((L + FB_BK - 1) / FB_BK, a.H, z), 128, 0, s>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Space core backward (H5), one pass. It replaces the attention-core part of
// tvts_tpu/ops/pallas_block_backward.py::fused_space_attention_block_v10_bwd
// (:3106, kernel :2722) for the groups that fit one block: group (b, t) =
// [CLS, the N patches of frame t], L = N + 1 elements. Bound on the H100:
// bytes (qkv and dO read once, dqkv written once: 253 MB, 0.076 ms at B/16's
// B=20 against ~0.02 ms of tensor-core work). The flash pair above reads a
// group's k and v (dq kernel) or q and dO (dkv kernel) again for every 64-row
// tile and rounds L = 99 up to two tiles. Design, by the forward space core's
// pattern (attention.cuh): one block per (t, h, b) stages the group's q, k, v
// and dO rows in shared memory once (16-byte cp.async; L padded with zero rows
// to a multiple of 16: 64 KB at L = 99, d = 64, three blocks an SM), with the
// group's lse (log2 domain) and delta. Its warps (space_bwd_warps: 4 at d =
// 64, 5 at d = 80) then take 16-row slabs: a dq task walks
// the 16-key chunks of the group for its query slab, a dkv task the 16-query
// chunks for its key slab, both on mma.sync m16n8k16 from the staged rows.
// The first round of dq tasks starts as soon as its slabs' q and dO and the
// first key chunk have landed and walks the later key chunks as they arrive
// (a cp.async group each), so the loads overlap the arithmetic. The arithmetic is the pair's, in its order: S = Q K^T
// and dP = dO V^T in query-row layout for dq, K Q^T and V dO^T in key-row
// layout for dk and dv (both layouts computed, as the pair does; the core is
// bound by bytes), the same exp2 and masks, P and dS rounded to bf16 for the
// products, each accumulator summed chunk by chunk in key (query) order. A
// 16-wide chunk past L would only add exact zeros, so only the chunks that
// hold an element run (7 at L = 99, where the pair runs 8), and dqkv and the
// CLS partials are bit for bit the pair's. Groups too large for one block's
// shared memory (space_bwd_smem) take the pair (ops/block_backward.py::
// space_core_backward dispatches on L and d before the launch).
// ---------------------------------------------------------------------------
// warps a block, and blocks an SM: at d = 64 four warps, three blocks (168
// registers; seven warps, one per slab of L = 99, spilled at two blocks an SM
// and ran 9% slower); at d = 80 five warps, one per slab of L = 77, two blocks
// (8% faster than four warps)
template <int DH>
__host__ __device__ constexpr int space_bwd_warps() { return DH == 64 ? 4 : 5; }
template <int DH>
__host__ __device__ constexpr int space_bwd_blocks_per_sm() { return DH == 64 ? 3 : 2; }

// rows of a staged group: L = N + 1 padded to a multiple of 16
inline int space_bwd_rows(int N) { return (N + 1 + 15) / 16 * 16; }

// q, k, v and dO of the group ([Lp][DH + 8] bf16 each), then lse and delta ([Lp] f32)
inline size_t space_bwd_smem(int N, int DH) {
  const int Lp = space_bwd_rows(N);
  return (size_t)4 * Lp * (DH + 8) * 2 + (size_t)2 * Lp * 4;
}

// whether a space group of N patches at head dim DH fits one space_bwd_kernel
// block: the rule the launch refuses by and ops/block_backward.py dispatches on
// (through tvts_space_bwd_one_block)
inline bool space_bwd_one_block(int N, int DH) {
  return (DH == 64 || DH == 80) && N >= 1 && space_bwd_smem(N, DH) <= (size_t)SMEM_OPTIN;
}

// The staged group a space_bwd_kernel block works on: q, k, v and dO rows
// ([Lp][DH + 8] bf16), the lse in the log2 domain and delta ([Lp] f32).
template <int DH>
struct SpaceGroup {
  bf16 (*q)[DH + 8];
  bf16 (*k)[DH + 8];
  bf16 (*v)[DH + 8];
  bf16 (*dO)[DH + 8];
  const float* lse2;
  const float* delta;
  int L, t, b, h;
};

// dq of query slab [r0, r0 + 16) of the staged group: flash_bwd_dq_kernel's
// arithmetic, 16 keys a step (start, then step for k0 = 0, 16, .. < L, then
// store), the slab's q and dO fragments and its dq accumulators in registers
template <int DH>
struct SpaceBwdDq {
  uint32_t qf[DH / 16][4], of[DH / 16][4];
  float dq[DH / 8][4];
  float lse2[2], dl[2];
  int qe[2];

  __device__ __forceinline__ void start(const SpaceGroup<DH>& g, int r0, int lane) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      qe[r] = r0 + (lane >> 2) + r * 8;
      lse2[r] = g.lse2[qe[r]];
      dl[r] = g.delta[qe[r]];
    }
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      ldmatrix_x4(qf[kk], &g.q[r0 + (lane & 15)][kk * 16 + (lane >> 4) * 8]);
      ldmatrix_x4(of[kk], &g.dO[r0 + (lane & 15)][kk * 16 + (lane >> 4) * 8]);
    }
#pragma unroll
    for (int i = 0; i < DH / 8; ++i) dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;
  }

  __device__ __forceinline__ void step(const SpaceGroup<DH>& g, int k0, int lane,
                                       float scale_log2) {
    const int t4 = lane & 3, j = lane >> 3;
    float s[2][4], dp[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = dp[n][0] = dp[n][1] =
        dp[n][2] = dp[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      uint32_t bk[4], bv[4];
      ldmatrix_x4(bk, &g.k[k0 + (lane & 7) + (j >> 1) * 8][kk * 16 + (j & 1) * 8]);
      ldmatrix_x4(bv, &g.v[k0 + (lane & 7) + (j >> 1) * 8][kk * 16 + (j & 1) * 8]);
      mma_bf16_16816(s[0], qf[kk], bk[0], bk[1]);
      mma_bf16_16816(s[1], qf[kk], bk[2], bk[3]);
      mma_bf16_16816(dp[0], of[kk], bv[0], bv[1]);
      mma_bf16_16816(dp[1], of[kk], bv[2], bv[3]);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = k0 + nt * 8 + t4 * 2 + (c & 1), r = c >> 1;
        const bool masked = key >= g.L || (g.t != 0 && key == 0 && qe[r] == 0);
        const float p = masked ? 0.f : exp2f(s[nt][c] * scale_log2 - lse2[r]);
        s[nt][c] = p * (dp[nt][c] - dl[r]);  // dS
      }
    uint32_t pa[4];
    pa[0] = pack_bf16x2(s[0][0], s[0][1]);
    pa[1] = pack_bf16x2(s[0][2], s[0][3]);
    pa[2] = pack_bf16x2(s[1][0], s[1][1]);
    pa[3] = pack_bf16x2(s[1][2], s[1][3]);
#pragma unroll
    for (int d2 = 0; d2 < DH / 16; ++d2) {
      uint32_t kf[4];
      ldmatrix_x4_trans(kf, &g.k[k0 + (lane & 7) + ((lane >> 3) & 1) * 8]
                                [d2 * 16 + ((lane >> 4) & 1) * 8]);
      mma_bf16_16816(dq[2 * d2], pa, kf[0], kf[1]);
      mma_bf16_16816(dq[2 * d2 + 1], pa, kf[2], kf[3]);
    }
  }

  __device__ __forceinline__ void store(const FlashBwdArgs& a, const SpaceGroup<DH>& g,
                                        int lane) const {
    const int t4 = lane & 3, D = a.H * DH;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (qe[r] >= g.L) continue;
      if (qe[r] == 0) {
        float* dst = a.cls_partial + ((((i64)g.b * a.T + g.t) * a.H + g.h) * 3 + 0) * DH;
#pragma unroll
        for (int i = 0; i < DH / 8; ++i)
          *reinterpret_cast<float2*>(dst + i * 8 + t4 * 2) =
              make_float2(dq[i][2 * r] * a.scale, dq[i][2 * r + 1] * a.scale);
        continue;
      }
      bf16* dst = a.dqkv + ((i64)g.b * a.S + group_token<true>(qe[r], g.t, a.N)) * 3 * D +
                  g.h * DH;
#pragma unroll
      for (int i = 0; i < DH / 8; ++i)
        *reinterpret_cast<__nv_bfloat162*>(dst + i * 8 + t4 * 2) =
            __floats2bfloat162_rn(dq[i][2 * r] * a.scale, dq[i][2 * r + 1] * a.scale);
    }
  }
};

// dk and dv of key slab [k0, k0 + 16) of the staged group:
// flash_bwd_dkv_kernel's arithmetic, 16 queries a step
template <int DH>
__device__ __forceinline__ void space_bwd_dkv(const FlashBwdArgs& a, const SpaceGroup<DH>& sg,
                                              int k0, int lane, float scale_log2) {
  bf16 (*sQ)[DH + 8] = sg.q;
  bf16 (*sK)[DH + 8] = sg.k;
  bf16 (*sV)[DH + 8] = sg.v;
  bf16 (*sdO)[DH + 8] = sg.dO;
  const float* s_lse2 = sg.lse2;
  const float* s_delta = sg.delta;
  const int L = sg.L, t = sg.t, b = sg.b, h = sg.h;
  const int g = lane >> 2, t4 = lane & 3, j = lane >> 3;
  const int D = a.H * DH;
  const int ke[2] = {k0 + g, k0 + g + 8};
  uint32_t kf[DH / 16][4], vf[DH / 16][4];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    ldmatrix_x4(kf[kk], &sK[k0 + (lane & 15)][kk * 16 + (lane >> 4) * 8]);
    ldmatrix_x4(vf[kk], &sV[k0 + (lane & 15)][kk * 16 + (lane >> 4) * 8]);
  }
  float dk[DH / 8][4], dv[DH / 8][4];
#pragma unroll
  for (int i = 0; i < DH / 8; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk[i][c] = dv[i][c] = 0.f;

  for (int q0 = 0; q0 < L; q0 += 16) {
    // transposed tiles: rows are this slab's 16 keys, columns 16 queries
    float p[2][4], ds[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n) p[n][0] = p[n][1] = p[n][2] = p[n][3] = ds[n][0] = ds[n][1] =
        ds[n][2] = ds[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      uint32_t bq[4], bo[4];
      ldmatrix_x4(bq, &sQ[q0 + (lane & 7) + (j >> 1) * 8][kk * 16 + (j & 1) * 8]);
      ldmatrix_x4(bo, &sdO[q0 + (lane & 7) + (j >> 1) * 8][kk * 16 + (j & 1) * 8]);
      mma_bf16_16816(p[0], kf[kk], bq[0], bq[1]);
      mma_bf16_16816(p[1], kf[kk], bq[2], bq[3]);
      mma_bf16_16816(ds[0], vf[kk], bo[0], bo[1]);
      mma_bf16_16816(ds[1], vf[kk], bo[2], bo[3]);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int query = q0 + nt * 8 + t4 * 2 + (c & 1), key = ke[c >> 1];
        const bool masked = query >= L || key >= L || (t != 0 && key == 0 && query == 0);
        const float pv = masked ? 0.f : exp2f(p[nt][c] * scale_log2 - s_lse2[query]);
        p[nt][c] = pv;
        ds[nt][c] = pv * (ds[nt][c] - s_delta[query]);
      }
    uint32_t pp[4], pd[4];
    pp[0] = pack_bf16x2(p[0][0], p[0][1]);
    pp[1] = pack_bf16x2(p[0][2], p[0][3]);
    pp[2] = pack_bf16x2(p[1][0], p[1][1]);
    pp[3] = pack_bf16x2(p[1][2], p[1][3]);
    pd[0] = pack_bf16x2(ds[0][0], ds[0][1]);
    pd[1] = pack_bf16x2(ds[0][2], ds[0][3]);
    pd[2] = pack_bf16x2(ds[1][0], ds[1][1]);
    pd[3] = pack_bf16x2(ds[1][2], ds[1][3]);
#pragma unroll
    for (int d2 = 0; d2 < DH / 16; ++d2) {
      uint32_t o4[4], q4[4];
      const int row = q0 + (lane & 7) + ((lane >> 3) & 1) * 8, col = d2 * 16 + ((lane >> 4) & 1) * 8;
      ldmatrix_x4_trans(o4, &sdO[row][col]);
      mma_bf16_16816(dv[2 * d2], pp, o4[0], o4[1]);
      mma_bf16_16816(dv[2 * d2 + 1], pp, o4[2], o4[3]);
      ldmatrix_x4_trans(q4, &sQ[row][col]);
      mma_bf16_16816(dk[2 * d2], pd, q4[0], q4[1]);
      mma_bf16_16816(dk[2 * d2 + 1], pd, q4[2], q4[3]);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (ke[r] >= L) continue;
    if (ke[r] == 0) {
      float* dst = a.cls_partial + (((i64)b * a.T + t) * a.H + h) * 3 * DH;
#pragma unroll
      for (int i = 0; i < DH / 8; ++i) {
        *reinterpret_cast<float2*>(dst + DH + i * 8 + t4 * 2) =
            make_float2(dk[i][2 * r] * a.scale, dk[i][2 * r + 1] * a.scale);
        *reinterpret_cast<float2*>(dst + 2 * DH + i * 8 + t4 * 2) =
            make_float2(dv[i][2 * r], dv[i][2 * r + 1]);
      }
      continue;
    }
    bf16* dst = a.dqkv + ((i64)b * a.S + group_token<true>(ke[r], t, a.N)) * 3 * D + h * DH;
#pragma unroll
    for (int i = 0; i < DH / 8; ++i) {
      *reinterpret_cast<__nv_bfloat162*>(dst + D + i * 8 + t4 * 2) =
          __floats2bfloat162_rn(dk[i][2 * r] * a.scale, dk[i][2 * r + 1] * a.scale);
      *reinterpret_cast<__nv_bfloat162*>(dst + 2 * D + i * 8 + t4 * 2) =
          __floats2bfloat162_rn(dv[i][2 * r], dv[i][2 * r + 1]);
    }
  }
}

// rows [r0, r1) of the staged arrays `which` (bit 0 q, 1 k, 2 v, 3 dO) by
// 16-byte cp.async; rows past L are zero-filled with plain stores
template <int DH>
__device__ __forceinline__ void space_bwd_stage(const FlashBwdArgs& a, const SpaceGroup<DH>& g,
                                                int which, int r0, int r1) {
  constexpr int VPR = DH / 8;
  const int D = a.H * DH, n = r1 - r0, per = n * VPR;
  bf16 (*dst_of[4])[DH + 8] = {g.q, g.k, g.v, g.dO};
  const bf16* qkv = a.qkv + (i64)g.b * a.S * 3 * D;
  const bf16* dO = a.dO + (i64)g.b * a.S * D;
#pragma unroll
  for (int arr = 0; arr < 4; ++arr) {
    if (!(which >> arr & 1)) continue;
    for (int i = threadIdx.x; i < per; i += blockDim.x) {
      const int r = r0 + i / VPR, c = (i % VPR) * 8;
      bf16* dst = &dst_of[arr][r][c];
      if (r < g.L) {
        const i64 tok = group_token<true>(r, g.t, a.N);
        cp_async16(dst, arr == 3 ? dO + tok * D + g.h * DH + c
                                 : qkv + tok * 3 * D + arr * D + g.h * DH + c);
      } else {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
      }
    }
  }
}

template <int DH>
__global__ void __launch_bounds__(space_bwd_warps<DH>() * 32, space_bwd_blocks_per_sm<DH>())
    space_bwd_kernel(const FlashBwdArgs a) {
  constexpr int W = space_bwd_warps<DH>();
  extern __shared__ __align__(16) uint8_t sbs[];
  constexpr int LD = DH + 8;
  const int L = a.N + 1, Lp = (L + 15) / 16 * 16;
  SpaceGroup<DH> g;
  g.q = reinterpret_cast<bf16 (*)[LD]>(sbs);
  g.k = g.q + Lp;
  g.v = g.k + Lp;
  g.dO = g.v + Lp;
  float* s_lse2 = reinterpret_cast<float*>(g.dO + Lp);
  float* s_delta = s_lse2 + Lp;
  g.lse2 = s_lse2;
  g.delta = s_delta;
  g.L = L;
  g.t = blockIdx.x;
  g.h = blockIdx.y;
  g.b = blockIdx.z;

  // The loads in the order the first round needs them, a commit group each:
  // q and dO of the first W slabs with k and v of key chunk 0, then k and v
  // of each further chunk, then q and dO of the other slabs. The first round
  // (a dq task on each warp) walks the key chunks as they arrive.
  const int slabs = Lp / 16, first = min(slabs, W);
  space_bwd_stage<DH>(a, g, 0b1001, 0, 16 * first);
  space_bwd_stage<DH>(a, g, 0b0110, 0, 16);
  cp_async_commit();
  for (int c = 1; c < slabs; ++c) {
    space_bwd_stage<DH>(a, g, 0b0110, 16 * c, 16 * c + 16);
    cp_async_commit();
  }
  space_bwd_stage<DH>(a, g, 0b1001, 16 * first, Lp);
  cp_async_commit();
  const float* lse = a.lse + ((i64)g.b * a.H + g.h) * a.S;
  const float* delta = a.delta + ((i64)g.b * a.H + g.h) * a.S;
  for (int e = threadIdx.x; e < Lp; e += blockDim.x) {
    const int tok = e < L ? group_token<true>(e, g.t, a.N) : 0;
    s_lse2[e] = e < L ? lse[tok] * LOG2E_F : INFINITY;
    s_delta[e] = e < L ? delta[tok] : 0.f;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float scale_log2 = a.scale * LOG2E_F;
  {  // first round: dq of slab `warp`, key chunk c once its group has landed
    SpaceBwdDq<DH> dq;
    for (int c = 0; c < slabs; ++c) {
      cp_async_wait_pending(slabs - c);  // groups 0 .. c of this thread's copies
      __syncthreads();                   // and everyone's
      if (warp < first) {
        if (c == 0) dq.start(g, 16 * warp, lane);
        dq.step(g, 16 * c, lane, scale_log2);
      }
    }
    if (warp < first) dq.store(a, g, lane);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  // then the other dq slabs and every dk, dv slab, in turn over the warps
  // (task r on warp (first + r) % W, so the warps without a first-round task
  // come first)
  for (int task = (warp - first % W + W) % W; task < 2 * slabs - first; task += W) {
    if (task < slabs - first) {
      SpaceBwdDq<DH> dq;
      dq.start(g, 16 * (first + task), lane);
      for (int k0 = 0; k0 < L; k0 += 16) dq.step(g, k0, lane, scale_log2);
      dq.store(a, g, lane);
    } else {
      space_bwd_dkv<DH>(a, g, 16 * (task - (slabs - first)), lane, scale_log2);
    }
  }
}

template <int DH>
inline cudaError_t launch_space_bwd(const FlashBwdArgs& a, int B, cudaStream_t s) {
  const size_t smem = space_bwd_smem(a.N, DH);
  cudaError_t err = cudaFuncSetAttribute(space_bwd_kernel<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  space_bwd_kernel<DH><<<dim3(a.T, a.H, B), space_bwd_warps<DH>() * 32, smem, s>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Time core backward (H6). The time group of location n is [CLS, (0, n), (1,
// n), .., (T-1, n)]: G = T + 1 <= 33 elements, too small for the tensor cores,
// and bound by bytes on the H100 (q, k, v and dO read once, dqkv written once:
// 253 MB, 0.075 ms at B/16's B=20). Design, by the forward time core's pattern
// (attention.cuh): one block per (b, n, head group), a group of at most
// TB_MAX_THREADS / G heads; small blocks (about 50 KB of shared memory and
// 100 threads at T = 12), several on an SM, so that one block's loads overlap
// another's arithmetic. 16-byte cp.async copies, neighbouring threads on
// neighbouring addresses, bring q, k, v and dO of the group's G tokens into
// shared memory as bf16 (the CLS rows once a block, not once a head; rows
// padded by 16 bytes so that neighbouring rows start on other banks), and
// the group's lse and delta once. Thread (h, i) then:
// (1) keeps q_i and dO_i in f32 registers and builds row i of P and dS,
//     each logit and each dP one f32 chain over d in order, p =
//     __expf(qk * scale - lse_i), dS = p * (dP - delta_i), both into shared
//     memory in f32;
// (2) after a barrier, dq_i = scale * sum_j dS_ij k_j over j in order;
// (3) dk_j = scale * sum_i dS_ij q_i and dv_j = sum_i P_ij dO_i over i in
//     order for the column j = i it owns.
// This is the first version's order of operations in every output element
// (one warp a group and SIMT lanes then), so dqkv and the CLS partials are bit
// for bit the same; the H/14 step-0 gates sit near their limit (PERF.md).
// The outputs are staged in shared memory over the rows no longer read (dq
// over v, dk over k, dv over q) and leave in 16-byte stores; the CLS token's
// dq, dk and dv go out as the group's f32 partial.
// ---------------------------------------------------------------------------
constexpr int TB_MAX_THREADS = 128;

// Heads a block takes: at most TB_MAX_THREADS / (T + 1), the H heads split as
// evenly as that allows.
inline int time_bwd_heads(int T, int H) {
  const int cap = std::max(1, TB_MAX_THREADS / (T + 1));
  const int groups = (H + cap - 1) / cap;
  return (H + groups - 1) / groups;
}

// q, k, v and dO of the G elements ([G][HG * DH + 8] bf16 each), then P and
// dS ([HG][G][G | 1] f32, an odd row stride), then lse and delta ([HG][G]).
inline size_t time_bwd_smem(int T, int HG, int DH) {
  const int G = T + 1;
  return (size_t)4 * G * (HG * DH + 8) * 2 + (size_t)2 * HG * G * (G | 1) * 4 +
         (size_t)2 * HG * G * 4;
}

template <int DH>
__global__ void __launch_bounds__(TB_MAX_THREADS)
    time_bwd_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dO,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dqkv, float* __restrict__ cls_partial, int T, int N,
                    int H, int HG, float scale) {
  extern __shared__ __align__(16) uint8_t tbs[];
  constexpr int VPR = DH / 8;  // 16-byte vectors per head row
  const int n = blockIdx.x, b = blockIdx.y, h0 = blockIdx.z * HG;
  const int hg = min(HG, H - h0);
  const int G = T + 1, GP = G | 1, D = H * DH, S = 1 + T * N, LD = HG * DH + 8;
  bf16* sq = reinterpret_cast<bf16*>(tbs);  // element e: 0 the CLS token, else frame e - 1
  bf16* sk = sq + G * LD;
  bf16* sv = sk + G * LD;
  bf16* sdo = sv + G * LD;
  float* sp = reinterpret_cast<float*>(sdo + G * LD);  // [HG][G][GP]
  float* sds = sp + HG * G * GP;
  float* slse = sds + HG * G * GP;  // [HG][G]
  float* sdel = slse + HG * G;
  const bf16* qb = qkv + (i64)b * S * 3 * D;
  const bf16* ob = dO + (i64)b * S * D;

  const int per_row = hg * VPR;
  for (int e = threadIdx.x; e < 4 * G * per_row; e += blockDim.x) {
    const int r = e / per_row, rem = e - r * per_row;
    const int hh = rem / VPR, c = rem - hh * VPR;
    const int which = r / G, el = r - which * G;  // 0 q, 1 k, 2 v, 3 dO
    const i64 tok = el == 0 ? 0 : 1 + (i64)(el - 1) * N + n;
    const bf16* src = which == 3 ? ob + tok * D : qb + tok * 3 * D + which * D;
    cp_async16(sq + (which * G + el) * LD + hh * DH + c * 8, src + (h0 + hh) * DH + c * 8);
  }
  for (int e = threadIdx.x; e < hg * G; e += blockDim.x) {
    const int hh = e / G, el = e - hh * G;
    const i64 at = ((i64)b * H + h0 + hh) * S + (el == 0 ? 0 : 1 + (i64)(el - 1) * N + n);
    slse[e] = lse[at];
    sdel[e] = delta[at];
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // thread (hh, i): neighbouring threads share a head, so their k / v (pass
  // 1) and q / dO (pass 3) reads are broadcasts
  const int tid = threadIdx.x;
  const bool live = tid < G * hg;
  const int tc = live ? tid : 0;
  const int hh = tc / G, i = tc - hh * G;
  const int col = hh * DH;
  float* prow = sp + (hh * G + i) * GP;
  float* dsrow = sds + (hh * G + i) * GP;

  // (1) row i of P and dS
  if (live) {
    float qf[DH], of[DH];
#pragma unroll
    for (int c = 0; c < DH; c += 8) {
      float f[8], g[8];
      unpack_bf16x8(*reinterpret_cast<const uint4*>(sq + i * LD + col + c), f);
      unpack_bf16x8(*reinterpret_cast<const uint4*>(sdo + i * LD + col + c), g);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        qf[c + e] = f[e];
        of[c + e] = g[e];
      }
    }
    const float l_i = slse[hh * G + i], d_i = sdel[hh * G + i];
    for (int j = 0; j < G; ++j) {
      float qk = 0.f, dv = 0.f;
#pragma unroll
      for (int c = 0; c < DH; c += 8) {
        float kf[8], vf[8];
        unpack_bf16x8(*reinterpret_cast<const uint4*>(sk + j * LD + col + c), kf);
        unpack_bf16x8(*reinterpret_cast<const uint4*>(sv + j * LD + col + c), vf);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          qk += qf[c + e] * kf[e];
          dv += of[c + e] * vf[e];
        }
      }
      const bool masked = i == 0 && j == 0 && n != 0;  // CLS-CLS belongs to group 0
      const float p = masked ? 0.f : __expf(qk * scale - l_i);
      prow[j] = p;
      dsrow[j] = p * (dv - d_i);
    }
  }
  __syncthreads();  // P and dS complete; v is read no more

  if (live) {
    // (2) dq_i = scale * sum_j dS_ij k_j
    {
      float acc[DH];
#pragma unroll
      for (int d = 0; d < DH; ++d) acc[d] = 0.f;
      for (int j = 0; j < G; ++j) {
        const float w = dsrow[j];
#pragma unroll
        for (int c = 0; c < DH; c += 8) {
          float kf[8];
          unpack_bf16x8(*reinterpret_cast<const uint4*>(sk + j * LD + col + c), kf);
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[c + e] += w * kf[e];
        }
      }
      if (i == 0) {
        float4* dst = reinterpret_cast<float4*>(
            cls_partial + ((((i64)b * N + n) * H + h0 + hh) * 3 + 0) * DH);
#pragma unroll
        for (int d = 0; d < DH; d += 4)
          dst[d / 4] = make_float4(acc[d] * scale, acc[d + 1] * scale, acc[d + 2] * scale,
                                   acc[d + 3] * scale);
      } else {
#pragma unroll
        for (int c = 0; c < DH; c += 8) {
          float o[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) o[e] = acc[c + e] * scale;
          *reinterpret_cast<uint4*>(sv + i * LD + col + c) = pack_bf16x8(o);  // dq over v
        }
      }
    }
  }
  // (3) column j = i: dk_j = scale * sum_i dS_ij q_i, dv_j = sum_i P_ij dO_i
  const int j = i;
  float ak[DH], av[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) ak[d] = av[d] = 0.f;
  if (live) {
    for (int r = 0; r < G; ++r) {
      const float w = sds[(hh * G + r) * GP + j], p = sp[(hh * G + r) * GP + j];
#pragma unroll
      for (int c = 0; c < DH; c += 8) {
        float qf[8], of[8];
        unpack_bf16x8(*reinterpret_cast<const uint4*>(sq + r * LD + col + c), qf);
        unpack_bf16x8(*reinterpret_cast<const uint4*>(sdo + r * LD + col + c), of);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          ak[c + e] += w * qf[e];
          av[c + e] += p * of[e];
        }
      }
    }
  }
  __syncthreads();  // q, k and dO are read no more
  if (live) {
    if (j == 0) {
      float4* dst = reinterpret_cast<float4*>(
          cls_partial + (((i64)b * N + n) * H + h0 + hh) * 3 * DH);
#pragma unroll
      for (int d = 0; d < DH; d += 4) {
        dst[DH / 4 + d / 4] = make_float4(ak[d] * scale, ak[d + 1] * scale, ak[d + 2] * scale,
                                          ak[d + 3] * scale);
        dst[2 * DH / 4 + d / 4] = make_float4(av[d], av[d + 1], av[d + 2], av[d + 3]);
      }
    } else {
#pragma unroll
      for (int c = 0; c < DH; c += 8) {
        float ok[8], ov[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          ok[e] = ak[c + e] * scale;
          ov[e] = av[c + e];
        }
        *reinterpret_cast<uint4*>(sk + j * LD + col + c) = pack_bf16x8(ok);  // dk over k
        *reinterpret_cast<uint4*>(sq + j * LD + col + c) = pack_bf16x8(ov);  // dv over q
      }
    }
  }
  __syncthreads();
  // the patch rows of dq (staged in v), dk (in k) and dv (in q) in 16-byte stores
  for (int e = threadIdx.x; e < T * 3 * per_row; e += blockDim.x) {
    const int r = e / (3 * per_row), rem = e - r * 3 * per_row;
    const int which = rem / per_row, rem2 = rem - which * per_row;
    const int h = rem2 / VPR, c = rem2 - h * VPR;
    const bf16* src = (which == 0 ? sv : which == 1 ? sk : sq) + (r + 1) * LD + h * DH + c * 8;
    const i64 tok = 1 + (i64)r * N + n;
    *reinterpret_cast<uint4*>(dqkv + ((i64)b * S + tok) * 3 * D + which * D + (h0 + h) * DH +
                              c * 8) = *reinterpret_cast<const uint4*>(src);
  }
}

// dqkv[b, 0, slot*D + h*DH + d] = sum_g partial[b, g, h, slot, d], g = 0 .. G-1
// in order (the CLS token's dq, dk, dv from the groups' partials).
__global__ void cls_grad_combine_kernel(const float* __restrict__ partial, int G, int H, int DH,
                                        i64 S, bf16* __restrict__ dqkv) {
  const int h = blockIdx.x, b = blockIdx.y, D = H * DH;
  for (int i = threadIdx.x; i < 3 * DH; i += blockDim.x) {
    const int slot = i / DH, d = i % DH;
    float s = 0.f;
    for (int gi = 0; gi < G; ++gi)
      s += partial[((((i64)b * G + gi) * H + h) * 3 + slot) * DH + d];
    dqkv[(i64)b * S * 3 * D + slot * D + h * DH + d] = __float2bfloat16(s);
  }
}

}  // namespace tvts
