// Plain C entry points of the tvts_torch Hopper kernels, loaded with ctypes
// (tvts_torch/ops/block_kernels.py builds this file with nvcc for sm_90a).
// Every function launches on the given stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() after its launches.
#include "attention.cuh"
#include "attention_bwd.cuh"
#include "ln_gemm.cuh"
#include "text_attention.cuh"
#include "weight_grad.cuh"

using tvts::bf16;
using tvts::i64;

// Launchers of the attention cores, packed (H1 / H2) and strided (H9).
namespace {

template <int DH, bool STRIDED>
tvts::CoreAddr<DH, STRIDED> core_view(const void* q, const void* k, const void* v, void* out,
                                      int H, int S, const i64* strides) {
  tvts::CoreAddr<DH, STRIDED> view;
  view.q = (const bf16*)q;
  view.k = (const bf16*)k;
  view.v = (const bf16*)v;
  view.o = (bf16*)out;
  view.H = H;
  view.S = S;
  for (int i = 0; i < 3; ++i) {
    view.st.q[i] = strides ? strides[i] : 0;
    view.st.k[i] = strides ? strides[3 + i] : 0;
    view.st.v[i] = strides ? strides[6 + i] : 0;
    view.st.o[i] = strides ? strides[9 + i] : 0;
  }
  return view;
}

template <int DH, bool STRIDED>
cudaError_t launch_time_core(const void* q, const void* k, const void* v, void* out, void* lse,
                             const i64* strides, int B, int T, int N, int H, float scale,
                             cudaStream_t s) {
  const int HG = tvts::time_core_heads(T, H);
  const size_t smem = tvts::time_core_smem(T, HG, DH);
  cudaError_t err =
      cudaFuncSetAttribute(tvts::time_core_kernel<DH, STRIDED>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int threads = (T * HG + 31) / 32 * 32;
  tvts::time_core_kernel<DH, STRIDED><<<dim3(N, B, (H + HG - 1) / HG), threads, smem, s>>>(
      core_view<DH, STRIDED>(q, k, v, out, H, 1 + T * N, strides), (float*)lse, T, N, HG,
      scale);
  return cudaGetLastError();
}

template <int DH, bool STRIDED>
cudaError_t launch_space_core(const void* q, const void* k, const void* v, void* out, void* lse,
                              const i64* strides, int B, int T, int N, int H, float scale,
                              cudaStream_t s) {
  dim3 grid((N + tvts::SP_BQ - 1) / tvts::SP_BQ, H, B * T);
  tvts::space_core_kernel<DH, STRIDED><<<grid, 128, 0, s>>>(
      core_view<DH, STRIDED>(q, k, v, out, H, 1 + T * N, strides), (float*)lse, T, N,
      scale * 1.4426950408889634f);
  return cudaGetLastError();
}

// 12 element strides (batch, head, row of q, k, v, out): rows 16-byte aligned
bool strides_ok(const i64* st) {
  for (int i = 0; i < 12; ++i)
    if (st[i] % 8) return false;
  return true;
}

}  // namespace

extern "C" {

const char* tvts_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Y[M, N] = epilogue(LN?(X[M, K]) @ W[N, K]^T + bias), see ln_gemm.cuh.
// ln_w == NULL: no LayerNorm. bias/res may be NULL. stats: f32 scratch [M, 2]
// (the LayerNorm row statistics, kept by the training forward). Yf != NULL:
// f32 output there instead of Y. epi (ln_gemm.cuh's Epilogue): 1 also writes
// the pre-activation product to Y2 (bf16); 2 / 3 read the hidden Hin (bf16 /
// f32) and write product * act'(Hin) to Y and act(Hin) to Y2; Y2 and Hin are
// [M, N] at stride ldy.
int tvts_ln_gemm(const void* X, i64 lda, const void* ln_w, const void* ln_b, float eps,
                 void* stats, const void* W, const void* bias, const void* res, i64 ldres,
                 void* Y, void* Yf, i64 ldy, int M, int N, int K, int act, void* Y2,
                 const void* Hin, int epi, void* stream) {
  // what block_kernels.py::gemm_plan checks, again: K a multiple of the k step,
  // 16-byte aligned operands and row strides (TMA's and the epilogue's rules)
  const void* ptrs[] = {X, W, bias, res, Y, Yf, Y2, Hin};
  for (const void* ptr : ptrs)
    if ((uintptr_t)ptr % 16) return (int)cudaErrorInvalidValue;
  if (K % tvts::GEMM_BK != 0 || N % 8 != 0 || lda % 8 != 0 || ldy % (Yf ? 4 : 8) != 0 ||
      ldres % 8 != 0 || M < 1 || act < 0 || act > 2 || epi < 0 || epi > 3)
    return (int)cudaErrorInvalidValue;
  if (epi != tvts::EPI_PLAIN && (Yf || !Y || !Y2)) return (int)cudaErrorInvalidValue;
  if (epi >= tvts::EPI_ACT_GRAD_BF16 && (!Hin || bias || res || ln_w))
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
  a.Yf = (float*)Yf;
  a.ldy = ldy;
  a.M = M;
  a.N = N;
  a.K = K;
  a.act = act;
  a.Y2 = (bf16*)Y2;
  a.Hin = Hin;
  return (int)tvts::launch_ln_gemm(a, eps, (float2*)stats, epi, (cudaStream_t)stream);
}

// Time attention of the patch rows of out [B, S, H*dh] from qkv [B, S, 3*H*dh];
// lse != NULL: also their log-sum-exp into lse [B, H, S] (training save).
int tvts_time_core(const void* qkv, void* out, void* lse, int B, int T, int N, int H, int dh,
                   float scale, void* stream) {
  if (T < 1 || T > 32) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dh == 64)
    return (int)launch_time_core<64, false>(qkv, nullptr, nullptr, out, lse, nullptr, B, T, N,
                                            H, scale, s);
  if (dh == 80)
    return (int)launch_time_core<80, false>(qkv, nullptr, nullptr, out, lse, nullptr, B, T, N,
                                            H, scale, s);
  return (int)cudaErrorInvalidValue;
}

// Space attention of the patch rows of out [B, S, H*dh] from qkv [B, S, 3*H*dh];
// lse != NULL: also their log-sum-exp into lse [B, H, S] (training save).
int tvts_space_core(const void* qkv, void* out, void* lse, int B, int T, int N, int H, int dh,
                    float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dh == 64)
    return (int)launch_space_core<64, false>(qkv, nullptr, nullptr, out, lse, nullptr, B, T, N,
                                             H, scale, s);
  if (dh == 80)
    return (int)launch_space_core<80, false>(qkv, nullptr, nullptr, out, lse, nullptr, B, T, N,
                                             H, scale, s);
  return (int)cudaErrorInvalidValue;
}

// The attention cores on their own (H9): the patch rows of out from separate
// q, k, v of logical shape [B, H, 1 + T*N, dh], each addressed by its element
// strides (batch, head, row); strides: 12 values for q, k, v, out in that
// order, multiples of 8. space != 0: the space core, else the time core. The
// logits are scaled by `scale` (1 for a pre-scaled q).
int tvts_attention_core_strided(const void* q, const void* k, const void* v, void* out,
                                const i64* strides, int B, int T, int N, int H, int dh,
                                float scale, int space, void* stream) {
  if (!strides_ok(strides) || (!space && (T < 1 || T > 32))) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dh == 64)
    return (int)(space ? launch_space_core<64, true>(q, k, v, out, nullptr, strides, B, T, N, H,
                                                     scale, s)
                       : launch_time_core<64, true>(q, k, v, out, nullptr, strides, B, T, N, H,
                                                    scale, s));
  if (dh == 80)
    return (int)(space ? launch_space_core<80, true>(q, k, v, out, nullptr, strides, B, T, N, H,
                                                     scale, s)
                       : launch_time_core<80, true>(q, k, v, out, nullptr, strides, B, T, N, H,
                                                    scale, s));
  return (int)cudaErrorInvalidValue;
}

// CLS global row: out[b, h*dh:(h+1)*dh] = softmax(q_b,h . k_b,h,j * scale) @ v over
// j < L. Row j of batch b sits at k + b*kv_bstride + j*kv_rstride (v alike).
// partial: f32 scratch [B, H, ceil(L / 128), dh + 2]. lse != NULL: the row's
// log-sum-exp into lse[b, h, 0] of an lse [B, H, L] (training save).
int tvts_cls_attention(const void* q, i64 q_bstride, const void* k, const void* v,
                       i64 kv_bstride, i64 kv_rstride, int L, void* out, i64 out_bstride,
                       void* partial, void* lse, int B, int H, int dh, float scale,
                       void* stream) {
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
    tvts::cls_combine_kernel<64><<<dim3(H, B), 64, 0, s>>>(
        (const float*)partial, nC, H, (bf16*)out, out_bstride, (float*)lse, L);
  else
    tvts::cls_combine_kernel<80><<<dim3(H, B), 80, 0, s>>>(
        (const float*)partial, nC, H, (bf16*)out, out_bstride, (float*)lse, L);
  return (int)cudaGetLastError();
}

// Self-attention of out [B, S, H*dh] from qkv [B, S, 3*H*dh] (H7 core), causal
// or not; q is scaled by `scale` (and rounded to bf16) before the products.
// lse != NULL: also each row's log-sum-exp into lse [B, H, S] (training save).
int tvts_text_core(const void* qkv, void* out, void* lse, int B, int S, int H, int dh,
                   float scale, int causal, void* stream) {
  if (dh != 64 || S < 1) return (int)cudaErrorInvalidValue;
  dim3 grid((S + tvts::TX_BQ - 1) / tvts::TX_BQ, H, B);
  tvts::text_core_kernel<64><<<grid, 128, 0, (cudaStream_t)stream>>>(
      (const bf16*)qkv, (bf16*)out, (float*)lse, S, H, scale, causal);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// training backward (weight_grad.cuh, attention_bwd.cuh)
// ---------------------------------------------------------------------------

// partial[z] = A[rows of split z]^T B[same rows] (f32 [N1, N2] each), B optionally
// LN(x) from the row stats; colsum != NULL: colsum[z] = column sums of A's rows.
int tvts_wgrad(const void* A, i64 lda, const void* Bm, i64 ldb, const void* stats,
               const void* ln_w, const void* ln_b, void* partial, void* colsum, int M, int N1,
               int N2, int splits, int rows_per_split, void* stream) {
  if (N1 % 8 || N2 % 8 || lda % 8 || ldb % 8 || rows_per_split % tvts::WG_BK ||
      (i64)splits * rows_per_split < M)
    return (int)cudaErrorInvalidValue;
  tvts::WgradArgs a;
  a.A = (const bf16*)A;
  a.lda = lda;
  a.Bm = (const bf16*)Bm;
  a.ldb = ldb;
  a.stats = (const float2*)stats;
  a.ln_w = (const float*)ln_w;
  a.ln_b = (const float*)ln_b;
  a.partial = (float*)partial;
  a.colsum = (float*)colsum;
  a.M = M;
  a.N1 = N1;
  a.N2 = N2;
  a.rows_per_split = rows_per_split;
  dim3 grid((N2 + tvts::WG_BN - 1) / tvts::WG_BN, (N1 + tvts::WG_BM - 1) / tvts::WG_BM, splits);
  tvts::wgrad_kernel<<<grid, tvts::WG_THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// out[i] = sum over p < P of partial[p * n + i], in order; out_f32 / out_bf16 may be NULL.
int tvts_reduce(const void* partial, int P, i64 n, void* out_f32, void* out_bf16,
                void* stream) {
  const int threads = 256;
  tvts::reduce_partials_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                                 (cudaStream_t)stream>>>((const float*)partial, P, n,
                                                         (float*)out_f32, (bf16*)out_bf16);
  return (int)cudaGetLastError();
}

// dx = res + LN_bwd(dxln) over M rows of width K; part_w / part_b: f32 [blocks*8, K]
// column partials (NULL: dx only). rows_per_warp rows per warp, 8 warps a block.
int tvts_ln_bwd(const void* X, const void* stats, const void* dxln, const void* ln_w,
                const void* res, void* dx, void* part_w, void* part_b, int M, int K,
                int rows_per_warp, int blocks, void* stream) {
  if (K % 8 || K > 256 * tvts::LNB_MAXC || (i64)blocks * 8 * rows_per_warp < M)
    return (int)cudaErrorInvalidValue;
  tvts::ln_bwd_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      (const bf16*)X, (const float2*)stats, (const float*)dxln, (const float*)ln_w,
      (const bf16*)res, (bf16*)dx, (float*)part_w, (float*)part_b, M, K, rows_per_warp);
  return (int)cudaGetLastError();
}

// delta [B, H, S] = per-head row dot of dO and O ([B, S, H*dh] each).
int tvts_attn_delta(const void* dO, const void* O, int B, int S, int H, int dh, void* delta,
                    void* stream) {
  const i64 n = (i64)B * S * H;
  const unsigned blocks = (unsigned)((n + 255) / 256);
  cudaStream_t s = (cudaStream_t)stream;
  if (dh == 64)
    tvts::attn_delta_kernel<64><<<blocks, 256, 0, s>>>((const bf16*)dO, (const bf16*)O, B, S,
                                                       H, (float*)delta);
  else if (dh == 80)
    tvts::attn_delta_kernel<80><<<blocks, 256, 0, s>>>((const bf16*)dO, (const bf16*)O, B, S,
                                                       H, (float*)delta);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// dqkv [B, S, 3*H*dh] of a flash-attention core. space == 0: self-attention of
// S rows (causal or not; the H7 text core). space == 1: the H5 space core over
// S = 1 + T*N rows, with the CLS token's dq, dk, dv as f32 partials into
// cls_partial [B, T, H, 3, dh] (combined by tvts_cls_grad_combine).
int tvts_flash_bwd(const void* qkv, const void* dO, const void* lse, const void* delta,
                   void* dqkv, void* cls_partial, int B, int T, int N, int S, int H, int dh,
                   float scale, int causal, int space, void* stream) {
  tvts::FlashBwdArgs a;
  a.qkv = (const bf16*)qkv;
  a.dO = (const bf16*)dO;
  a.lse = (const float*)lse;
  a.delta = (const float*)delta;
  a.dqkv = (bf16*)dqkv;
  a.cls_partial = (float*)cls_partial;
  a.T = T;
  a.N = N;
  a.S = S;
  a.H = H;
  a.scale = scale;
  a.causal = causal;
  cudaStream_t s = (cudaStream_t)stream;
  if (space && (causal || S != 1 + T * N)) return (int)cudaErrorInvalidValue;
  if (dh == 64)
    return (int)(space ? tvts::launch_flash_bwd<64, true>(a, B, s)
                 : tvts::launch_flash_bwd<64, false>(a, B, s));
  if (dh == 80)
    return (int)(space ? tvts::launch_flash_bwd<80, true>(a, B, s)
                 : tvts::launch_flash_bwd<80, false>(a, B, s));
  return (int)cudaErrorInvalidValue;
}

// dqkv of the H6 time core (S = 1 + T*N rows), the CLS token's dq, dk, dv as
// f32 partials into cls_partial [B, N, H, 3, dh].
int tvts_time_bwd(const void* qkv, const void* dO, const void* lse, const void* delta,
                  void* dqkv, void* cls_partial, int B, int T, int N, int H, int dh,
                  float scale, void* stream) {
  if (T < 1 || T > 31) return (int)cudaErrorInvalidValue;
  const size_t smem = tvts::time_bwd_smem(T, dh);
  dim3 grid(N, B);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (dh == 64) {
    err = cudaFuncSetAttribute(tvts::time_bwd_kernel<64>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    tvts::time_bwd_kernel<64><<<grid, tvts::TB_WARPS * 32, smem, s>>>(
        (const bf16*)qkv, (const bf16*)dO, (const float*)lse, (const float*)delta,
        (bf16*)dqkv, (float*)cls_partial, T, N, H, scale);
  } else if (dh == 80) {
    err = cudaFuncSetAttribute(tvts::time_bwd_kernel<80>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    tvts::time_bwd_kernel<80><<<grid, tvts::TB_WARPS * 32, smem, s>>>(
        (const bf16*)qkv, (const bf16*)dO, (const float*)lse, (const float*)delta,
        (bf16*)dqkv, (float*)cls_partial, T, N, H, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Row 0 of dqkv [B, S, 3*H*dh] from the groups' CLS partials [B, G, H, 3, dh].
int tvts_cls_grad_combine(const void* partial, int G, int B, int H, int dh, i64 S, void* dqkv,
                          void* stream) {
  tvts::cls_grad_combine_kernel<<<dim3(H, B), 256, 0, (cudaStream_t)stream>>>(
      (const float*)partial, G, H, dh, S, (bf16*)dqkv);
  return (int)cudaGetLastError();
}

}  // extern "C"
