// Plain C entry points of the tvts_torch Hopper kernels, loaded with ctypes
// (tvts_torch/ops/block_kernels.py builds this file with nvcc for sm_90a).
// Every function launches on the given stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() after its launches.
#include "attention.cuh"
#include "ln_gemm.cuh"
#include "text_attention.cuh"

using tvts::bf16;
using tvts::i64;

extern "C" {

const char* tvts_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Y[M, N] = epilogue(LN?(X[M, K]) @ W[N, K]^T + bias), see ln_gemm.cuh.
// ln_w == NULL: no LayerNorm. bias/res may be NULL. stats: f32 scratch [M, 2].
int tvts_ln_gemm(const void* X, i64 lda, const void* ln_w, const void* ln_b, float eps,
                 void* stats, const void* W, const void* bias, const void* res, i64 ldres,
                 void* Y, i64 ldy, int M, int N, int K, int act, void* stream) {
  if (K % tvts::GEMM_BK != 0 || N % 8 != 0 || lda % 8 != 0 || ldy % 2 != 0 || act < 0 ||
      act > 2)
    return (int)cudaErrorInvalidValue;
  tvts::GemmArgs a;
  a.X = (const bf16*)X;
  a.lda = lda;
  a.stats = nullptr;
  a.ln_w = (const float*)ln_w;
  a.ln_b = (const float*)ln_b;
  a.W = (const bf16*)W;
  a.bias = (const bf16*)bias;
  a.res = (const bf16*)res;
  a.ldres = ldres;
  a.Y = (bf16*)Y;
  a.ldy = ldy;
  a.M = M;
  a.N = N;
  a.K = K;
  a.act = act;
  return (int)tvts::launch_ln_gemm(a, eps, (float2*)stats, (cudaStream_t)stream);
}

// Time attention of the patch rows of out [B, S, H*dh] from qkv [B, S, 3*H*dh].
int tvts_time_core(const void* qkv, void* out, int B, int T, int N, int H, int dh,
                   float scale, void* stream) {
  if (T < 1 || T > 32) return (int)cudaErrorInvalidValue;
  const size_t smem = tvts::time_core_smem(T, dh);
  dim3 grid(N, B);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (dh == 64) {
    err = cudaFuncSetAttribute(tvts::time_core_kernel<64>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    tvts::time_core_kernel<64><<<grid, tvts::TIME_WARPS * 32, smem, s>>>(
        (const bf16*)qkv, (bf16*)out, T, N, H, scale);
  } else if (dh == 80) {
    err = cudaFuncSetAttribute(tvts::time_core_kernel<80>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    tvts::time_core_kernel<80><<<grid, tvts::TIME_WARPS * 32, smem, s>>>(
        (const bf16*)qkv, (bf16*)out, T, N, H, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Space attention of the patch rows of out [B, S, H*dh] from qkv [B, S, 3*H*dh].
int tvts_space_core(const void* qkv, void* out, int B, int T, int N, int H, int dh,
                    float scale, void* stream) {
  dim3 grid((N + tvts::SP_BQ - 1) / tvts::SP_BQ, H, B * T);
  const float scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t s = (cudaStream_t)stream;
  if (dh == 64)
    tvts::space_core_kernel<64><<<grid, 128, 0, s>>>((const bf16*)qkv, (bf16*)out, T, N, H,
                                                    scale_log2);
  else if (dh == 80)
    tvts::space_core_kernel<80><<<grid, 128, 0, s>>>((const bf16*)qkv, (bf16*)out, T, N, H,
                                                    scale_log2);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// CLS global row: out[b, h*dh:(h+1)*dh] = softmax(q_b,h . k_b,h,j * scale) @ v over
// j < L. Row j of batch b sits at k + b*kv_bstride + j*kv_rstride (v alike).
// partial: f32 scratch [B, H, ceil(L / 128), dh + 2].
int tvts_cls_attention(const void* q, i64 q_bstride, const void* k, const void* v,
                       i64 kv_bstride, i64 kv_rstride, int L, void* out, i64 out_bstride,
                       void* partial, int B, int H, int dh, float scale, void* stream) {
  const int nC = (L + tvts::CLS_CHUNK - 1) / tvts::CLS_CHUNK;
  dim3 grid(nC, H, B);
  cudaStream_t s = (cudaStream_t)stream;
  if (dh == 64) {
    tvts::cls_partial_kernel<64><<<grid, tvts::CLS_CHUNK, 0, s>>>(
        (const bf16*)q, q_bstride, (const bf16*)k, (const bf16*)v, kv_bstride, kv_rstride, L,
        H, scale, (float*)partial);
  } else if (dh == 80) {
    tvts::cls_partial_kernel<80><<<grid, tvts::CLS_CHUNK, 0, s>>>(
        (const bf16*)q, q_bstride, (const bf16*)k, (const bf16*)v, kv_bstride, kv_rstride, L,
        H, scale, (float*)partial);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (dh == 64)
    tvts::cls_combine_kernel<64><<<dim3(H, B), 64, 0, s>>>((const float*)partial, nC, H,
                                                          (bf16*)out, out_bstride);
  else
    tvts::cls_combine_kernel<80><<<dim3(H, B), 80, 0, s>>>((const float*)partial, nC, H,
                                                          (bf16*)out, out_bstride);
  return (int)cudaGetLastError();
}

// Self-attention of out [B, S, H*dh] from qkv [B, S, 3*H*dh] (H7 core), causal
// or not; q is scaled by `scale` (and rounded to bf16) before the products.
int tvts_text_core(const void* qkv, void* out, int B, int S, int H, int dh, float scale,
                   int causal, void* stream) {
  if (dh != 64 || S < 1) return (int)cudaErrorInvalidValue;
  dim3 grid((S + tvts::TX_BQ - 1) / tvts::TX_BQ, H, B);
  tvts::text_core_kernel<64><<<grid, 128, 0, (cudaStream_t)stream>>>(
      (const bf16*)qkv, (bf16*)out, S, H, scale, causal);
  return (int)cudaGetLastError();
}

}  // extern "C"
