// Attention core of the fused text-attention sub-path (H7): plain multi-head
// self-attention over the [B, S, 3D] qkv rows that ln_gemm writes, causal
// (text tower, S = 77) or not (sort head, S ~ 1181). Head dim 64 only: every
// text and sort config of the repo has d = 64.
//
// Replaces the core of tvts_tpu/ops/pallas_text_attention.py::
// fused_text_attention_block (:102, kernel :43-99), which keeps a whole [S, S]
// score matrix per head in VMEM. Here it is flash style on the tensor cores
// (mma.sync m16n8k16, bf16 in, f32 accumulate): one block per (64-query tile,
// head, batch), 4 warps x 16 query rows, walking 64-key tiles with an online,
// max-shifted f32 softmax; with `causal` the key tiles past the diagonal are
// skipped and the diagonal tile is masked. S is ragged against 64 at both
// shapes: query rows >= S load as zeros and are not written, keys >= S are
// masked. Unlike the space core (attention.cuh) no CLS key is spliced in.
//
// Numerics as the TPU kernel: q is scaled by 1/sqrt(d) and rounded to bf16
// before the products (for d = 64 the scale is 2^-3, so scaling the bf16 q
// from ln_gemm is exact); P is rounded to bf16 for P @ V while the row sum
// uses the f32 probabilities; the output is divided by that sum.
//
// Bound on the H100: at S = 77 the core is small next to the qkv and proj
// products (2 * S^2 * D * 2 flops per sequence against 4 * S * D^2 * 2: 7%),
// so the sub-path is bound by ln_gemm; at S = 1181 the core is about half of
// the flops.
//
// With a non-null `lse` [B, H, S] f32 the kernel also writes each row's
// natural-log log-sum-exp, the save of the training backward
// (attention_bwd.cuh); null leaves the inference path as it was.
#pragma once

#include <math.h>

#include "common.cuh"

namespace tvts {

constexpr int TX_BQ = 64;
constexpr int TX_BK = 64;

template <int DH>
__global__ void __launch_bounds__(128)
    text_core_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out,
                     float* __restrict__ lse, int S, int H, float scale, int causal) {
  constexpr int LD = DH + 8;
  __shared__ __align__(16) bf16 sQ[TX_BQ][LD];
  __shared__ __align__(16) bf16 sK[TX_BK][LD];
  __shared__ __align__(16) bf16 sV[TX_BK][LD];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * TX_BQ, h = blockIdx.y, b = blockIdx.z;
  const int D = H * DH;
  const bf16* base = qkv + (i64)b * S * 3 * D;
  constexpr int VPR = DH / 8;  // 16-byte vectors per head row

  for (int e = tid; e < TX_BQ * VPR; e += 128) {
    const int r = e / VPR, c = (e % VPR) * 8;
    uint4 u = make_uint4(0, 0, 0, 0);
    if (q0 + r < S) {
      u = *reinterpret_cast<const uint4*>(base + (i64)(q0 + r) * 3 * D + h * DH + c);
      __nv_bfloat162* hv = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(hv[i]);
        hv[i] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
      }
    }
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
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0 and row0 + 8
  const int k_end = causal ? min(S, q0 + TX_BQ) : S;
  constexpr float LOG2E = 1.4426950408889634f;

  for (int k0 = 0; k0 < k_end; k0 += TX_BK) {
    __syncthreads();  // previous tile fully consumed
    for (int e = tid; e < TX_BK * VPR; e += 128) {
      const int r = e / VPR, c = (e % VPR) * 8;
      uint4 uk = make_uint4(0, 0, 0, 0), uv = uk;
      if (k0 + r < S) {
        const bf16* row = base + (i64)(k0 + r) * 3 * D + h * DH + c;
        uk = *reinterpret_cast<const uint4*>(row + D);
        uv = *reinterpret_cast<const uint4*>(row + 2 * D);
      }
      *reinterpret_cast<uint4*>(&sK[r][c]) = uk;
      *reinterpret_cast<uint4*>(&sV[r][c]) = uv;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys (8 n-tiles of 8 keys)
    float s[TX_BK / 8][4];
#pragma unroll
    for (int i = 0; i < TX_BK / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
      for (int np = 0; np < TX_BK / 16; ++np) {
        uint32_t kf[4];
        const int j = lane >> 3;
        ldmatrix_x4(kf, &sK[np * 16 + (lane & 7) + (j >> 1) * 8][kk * 16 + (j & 1) * 8]);
        mma_bf16_16816(s[2 * np], qf[kk], kf[0], kf[1]);
        mma_bf16_16816(s[2 * np + 1], qf[kk], kf[2], kf[3]);
      }

    // online softmax in the log2 domain; this thread owns rows row0, row0 + 8
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < TX_BK / 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = k0 + nt * 8 + t4 * 2 + (c & 1);
        const int qi = row0 + (c >> 1) * 8;
        const bool masked = key >= S || (causal && key > qi);
        const float v = masked ? -INFINITY : s[nt][c] * LOG2E;
        s[nt][c] = v;
        tmax[c >> 1] = fmaxf(tmax[c >> 1], v);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
      // finite from the first tile on: key 0 is visible to every row
      const float m_new = fmaxf(m[r], tmax[r]);
      corr[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int nt = 0; nt < TX_BK / 8; ++nt)
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
    for (int kt = 0; kt < TX_BK / 16; ++kt) {
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
    const int qi = row0 + r * 8;
    if (lse && t4 == 0 && qi < S)  // training save: natural-log lse of the scaled logits
      lse[((i64)b * H + h) * S + qi] = (m[r] + __log2f(l[r])) * 0.6931471805599453f;
    l[r] = 1.f / l[r];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + r * 8;
    if (qi >= S) continue;
    bf16* dst = out + ((i64)b * S + qi) * D + h * DH;
#pragma unroll
    for (int i = 0; i < DH / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(dst + i * 8 + t4 * 2) =
          __floats2bfloat162_rn(o[i][2 * r] * l[r], o[i][2 * r + 1] * l[r]);
  }
}

}  // namespace tvts
