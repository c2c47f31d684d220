// ln_gemm: Y = epilogue(prologue(X) @ W^T + b), the building block that carries
// every matrix product of the four sub-path kernels (qkv, proj, c_fc, c_proj).
//
// X [M, K] bf16 (row stride lda), W [Nout, K] bf16 (the nn.Linear layout, so
// both operands are K-contiguous), f32 accumulation on the tensor cores
// (mma.sync m16n8k16). Prologue: optional LayerNorm, its f32 row statistics
// from row_stats_kernel, applied as A tiles move to shared memory and rounded
// to bf16 there (the JAX kernels also round LN(x) to bf16 before the product).
// Epilogue: bias, activation (none / quick_gelu / exact erf gelu), residual add
// from a separate `res` tensor, bf16 store (or an f32 store to `Yf`, which the
// training backward uses for dL/dLN(x) = dqkv @ Wqkv ahead of the LayerNorm
// backward; it passes the transposed weight, so the product is the
// untransposed-weight one, dY @ W).
//
// Two more epilogues serve the differentiable MLP sub-path (H8), chosen by the
// EPI template parameter so that the inference kernel's code does not change:
// - EPI_SAVE_PRE: the pre-activation hidden h = LN(x) Wfc^T + bfc goes to `Y2`
//   in bf16 beside act(h) in `Y`, the activation taken from the rounded h (the
//   saving forward of tvts_tpu/ops/pallas_block_attention.py::
//   fused_mlp_block_v7, :2552-2563);
// - EPI_ACT_GRAD_BF16 / _F32: the product is g Wproj and the epilogue reads the
//   hidden h (`Hin`, bf16 as saved or f32 as recomputed), writes
//   dh = product * act'(h) to `Y` and act(h) to `Y2`, both bf16 (the
//   arithmetic of _act_and_grad, pallas_block_attention.py:945-953, with erff
//   for the exact gelu).
//
// Bound on the H100: tensor-core issue for the big products (K = 768..5120).
// This first version stages tiles through registers into a double-buffered
// shared-memory ring (128x128x32 tiles, 8 warps of 64x32); wgmma/TMA and a
// deeper pipeline are later work.
#pragma once

#include "common.cuh"

namespace tvts {

enum Act { ACT_NONE = 0, ACT_QUICK_GELU = 1, ACT_GELU = 2 };
enum Epilogue { EPI_PLAIN = 0, EPI_SAVE_PRE = 1, EPI_ACT_GRAD_BF16 = 2, EPI_ACT_GRAD_F32 = 3 };

constexpr int GEMM_BM = 128;
constexpr int GEMM_BN = 128;
constexpr int GEMM_BK = 32;
constexpr int GEMM_LDS = GEMM_BK + 8;  // +16 B per row: conflict-free ldmatrix
constexpr int GEMM_THREADS = 256;

// One warp per row, two passes in f32 (mean, then mean of squared deviations),
// as LayerNormF32 computes them. Requires K % 8 == 0 and 16-byte aligned rows.
__global__ void row_stats_kernel(const bf16* __restrict__ X, i64 lda, int M, int K,
                                 float eps, float2* __restrict__ stats) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const bf16* x = X + (i64)row * lda;
  float s = 0.f;
  for (int k = lane * 8; k < K; k += 256) {
    uint4 u = *reinterpret_cast<const uint4*>(x + k);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(h[i]);
      s += f.x + f.y;
    }
  }
  const float mean = warp_sum(s) / K;
  float v = 0.f;
  for (int k = lane * 8; k < K; k += 256) {
    uint4 u = *reinterpret_cast<const uint4*>(x + k);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(h[i]);
      v += (f.x - mean) * (f.x - mean) + (f.y - mean) * (f.y - mean);
    }
  }
  v = warp_sum(v) / K;
  if (lane == 0) stats[row] = make_float2(mean, rsqrtf(v + eps));
}

struct GemmArgs {
  const bf16* X;
  i64 lda;
  const float2* stats;  // null: no LayerNorm prologue
  const float* ln_w;
  const float* ln_b;
  const bf16* W;     // [N, K]
  const bf16* bias;  // [N] or null
  const bf16* res;   // residual rows (stride ldres) or null
  i64 ldres;
  bf16* Y;
  float* Yf;  // non-null: f32 output instead of Y
  i64 ldy;
  int M, N, K, act;
  bf16* Y2;         // EPI_SAVE_PRE: h; EPI_ACT_GRAD_*: act(h); [M, N] at stride ldy
  const void* Hin;  // EPI_ACT_GRAD_*: the hidden h [M, N] at stride ldy
};

__device__ __forceinline__ float activate(float v, int act) {
  if (act == ACT_QUICK_GELU) return v / (1.f + __expf(-1.702f * v));
  if (act == ACT_GELU) return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
  return v;
}

// a = act(h), da = act'(h): quick_gelu s + 1.702 h s (1 - s) with s =
// sigmoid(1.702 h); exact gelu cdf + h * phi.
__device__ __forceinline__ void act_and_grad(float h, int act, float& a, float& da) {
  if (act == ACT_QUICK_GELU) {
    const float s = 1.f / (1.f + __expf(-1.702f * h));
    a = h * s;
    da = s * (1.f + 1.702f * h * (1.f - s));
  } else if (act == ACT_GELU) {
    const float cdf = 0.5f * (1.f + erff(h * 0.70710678118654752f));
    const float phi = __expf(-0.5f * h * h) * 0.3989422804014327f;
    a = h * cdf;
    da = cdf + h * phi;
  } else {
    a = h;
    da = 1.f;
  }
}

// F32_OUT is a template parameter, not a runtime branch: a runtime test in the
// epilogue cost the bf16 kernel 4-6% (one A/B call on the H100, PERF.md).
// EPI likewise: the H8 epilogues are compiled into kernels of their own.
template <bool F32_OUT, int EPI>
__global__ void __launch_bounds__(GEMM_THREADS) ln_gemm_kernel(const GemmArgs a) {
  __shared__ __align__(16) bf16 sA[2][GEMM_BM][GEMM_LDS];
  __shared__ __align__(16) bf16 sB[2][GEMM_BN][GEMM_LDS];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps, 64 x 32 each
  const int m0 = blockIdx.y * GEMM_BM, n0 = blockIdx.x * GEMM_BN;

  // Each thread moves rows lr and lr + 64 of both tiles, 8 columns at lc.
  const int lr = tid >> 2, lc = (tid & 3) * 8;
  const bool has_ln = a.stats != nullptr;
  float mean[2], rstd[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = m0 + lr + 64 * i;
    float2 st = make_float2(0.f, 1.f);
    if (has_ln && row < a.M) st = a.stats[row];
    mean[i] = st.x;
    rstd[i] = st.y;
  }

  uint4 ra[2], rb[2];
  auto load_global = [&](int kt) {
    const int k = kt * GEMM_BK + lc;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = m0 + lr + 64 * i;
      ra[i] = row < a.M ? *reinterpret_cast<const uint4*>(a.X + (i64)row * a.lda + k)
                        : make_uint4(0, 0, 0, 0);
      const int nrow = n0 + lr + 64 * i;
      rb[i] = nrow < a.N ? *reinterpret_cast<const uint4*>(a.W + (i64)nrow * a.K + k)
                         : make_uint4(0, 0, 0, 0);
    }
  };
  auto store_smem = [&](int kt, int buf) {
    const int k = kt * GEMM_BK + lc;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      uint4 u = ra[i];
      if (has_ln) {
        __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
        const float4 w0 = *reinterpret_cast<const float4*>(a.ln_w + k);
        const float4 w1 = *reinterpret_cast<const float4*>(a.ln_w + k + 4);
        const float4 b0 = *reinterpret_cast<const float4*>(a.ln_b + k);
        const float4 b1 = *reinterpret_cast<const float4*>(a.ln_b + k + 4);
        const float w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float2 f = __bfloat1622float2(h[j]);
          f.x = (f.x - mean[i]) * rstd[i] * w[2 * j] + b[2 * j];
          f.y = (f.y - mean[i]) * rstd[i] * w[2 * j + 1] + b[2 * j + 1];
          h[j] = __floats2bfloat162_rn(f.x, f.y);
        }
      }
      *reinterpret_cast<uint4*>(&sA[buf][lr + 64 * i][lc]) = u;
      *reinterpret_cast<uint4*>(&sB[buf][lr + 64 * i][lc]) = rb[i];
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mi][ni][c] = 0.f;

  const int KT = a.K / GEMM_BK;
  load_global(0);
  store_smem(0, 0);
  __syncthreads();
  for (int kt = 0; kt < KT; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < KT) load_global(kt + 1);
#pragma unroll
    for (int kk = 0; kk < GEMM_BK; kk += 16) {
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4(af[mi], &sA[buf][wm * 64 + mi * 16 + (lane & 15)][kk + (lane >> 4) * 8]);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        uint32_t t[4];
        const int j = lane >> 3;
        ldmatrix_x4(t, &sB[buf][wn * 32 + nj * 16 + (lane & 7) + (j >> 1) * 8]
                               [kk + (j & 1) * 8]);
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
    if (kt + 1 < KT) store_smem(kt + 1, buf ^ 1);
    __syncthreads();
  }

  // Epilogue straight from the accumulator fragments: c0,c1 at (g, 2t..2t+1),
  // c2,c3 at (g + 8, same columns).
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm * 64 + mi * 16 + g + half * 8;
        const int col = n0 + wn * 32 + ni * 8 + t4 * 2;
        if (row >= a.M || col >= a.N) continue;
        float v0 = acc[mi][ni][2 * half], v1 = acc[mi][ni][2 * half + 1];
        if constexpr (EPI >= EPI_ACT_GRAD_BF16) {
          const i64 at = (i64)row * a.ldy + col;
          float2 h;
          if constexpr (EPI == EPI_ACT_GRAD_F32)
            h = *reinterpret_cast<const float2*>(static_cast<const float*>(a.Hin) + at);
          else
            h = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(static_cast<const bf16*>(a.Hin) + at));
          float a0, a1, d0, d1;
          act_and_grad(h.x, a.act, a0, d0);
          act_and_grad(h.y, a.act, a1, d1);
          *reinterpret_cast<__nv_bfloat162*>(a.Y + at) = __floats2bfloat162_rn(v0 * d0, v1 * d1);
          *reinterpret_cast<__nv_bfloat162*>(a.Y2 + at) = __floats2bfloat162_rn(a0, a1);
          continue;
        }
        if (a.bias) {
          const float2 bb = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(a.bias + col));
          v0 += bb.x;
          v1 += bb.y;
        }
        if constexpr (EPI == EPI_SAVE_PRE) {
          const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
          *reinterpret_cast<__nv_bfloat162*>(a.Y2 + (i64)row * a.ldy + col) = h;
          v0 = __low2float(h);
          v1 = __high2float(h);
        }
        v0 = activate(v0, a.act);
        v1 = activate(v1, a.act);
        if (a.res) {
          const float2 r = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(a.res + (i64)row * a.ldres + col));
          v0 += r.x;
          v1 += r.y;
        }
        if constexpr (F32_OUT)
          *reinterpret_cast<float2*>(a.Yf + (i64)row * a.ldy + col) = make_float2(v0, v1);
        else
          *reinterpret_cast<__nv_bfloat162*>(a.Y + (i64)row * a.ldy + col) =
              __floats2bfloat162_rn(v0, v1);
      }
}

inline cudaError_t launch_ln_gemm(const GemmArgs& a, float eps, float2* stats, int epi,
                                  cudaStream_t stream) {
  GemmArgs args = a;
  if (args.ln_w != nullptr) {
    row_stats_kernel<<<(a.M + 7) / 8, 256, 0, stream>>>(a.X, a.lda, a.M, a.K, eps, stats);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    args.stats = stats;
  } else {
    args.stats = nullptr;
  }
  dim3 grid((a.N + GEMM_BN - 1) / GEMM_BN, (a.M + GEMM_BM - 1) / GEMM_BM);
  if (epi == EPI_SAVE_PRE)
    ln_gemm_kernel<false, EPI_SAVE_PRE><<<grid, GEMM_THREADS, 0, stream>>>(args);
  else if (epi == EPI_ACT_GRAD_BF16)
    ln_gemm_kernel<false, EPI_ACT_GRAD_BF16><<<grid, GEMM_THREADS, 0, stream>>>(args);
  else if (epi == EPI_ACT_GRAD_F32)
    ln_gemm_kernel<false, EPI_ACT_GRAD_F32><<<grid, GEMM_THREADS, 0, stream>>>(args);
  else if (args.Yf)
    ln_gemm_kernel<true, EPI_PLAIN><<<grid, GEMM_THREADS, 0, stream>>>(args);
  else
    ln_gemm_kernel<false, EPI_PLAIN><<<grid, GEMM_THREADS, 0, stream>>>(args);
  return cudaGetLastError();
}

}  // namespace tvts
