// Plain C entry points of the tvts_torch Hopper kernels, loaded with ctypes
// (tvts_torch/ops/block_kernels.py builds this file with nvcc for sm_90a).
// Every function launches on the given stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() after its launches.
#include "attention.cuh"
#include "attention_bwd.cuh"
#include "cls_pool.cuh"
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
                              void* cls_partial, const i64* strides, int B, int T, int N, int H,
                              float scale, cudaStream_t s) {
  const size_t smem = tvts::space_core_smem(N, DH);
  cudaError_t err = cudaFuncSetAttribute(tvts::space_core_kernel<DH, STRIDED>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int S = 1 + T * N;
  tvts::space_core_kernel<DH, STRIDED><<<dim3(B * T, H), tvts::SP_WARPS * 32, smem, s>>>(
      core_view<DH, STRIDED>(q, k, v, out, H, S, strides), (float*)lse, (float*)cls_partial, T,
      N, scale * 1.4426950408889634f);
  err = cudaGetLastError();
  if (err != cudaSuccess || !cls_partial) return err;
  // the CLS row from the T frames' partials (packed only: rows of [B, S, H*DH])
  tvts::cls_combine_kernel<DH><<<dim3(H, B), DH, 0, s>>>(
      (const float*)cls_partial, T, H, (bf16*)out, (i64)S * H * DH, (float*)lse, S);
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

// Space attention of out [B, S, H*dh] from qkv [B, S, 3*H*dh]: the patch rows,
// and with cls_partial (f32 scratch [B, H, T, dh + 2]) also the CLS row, its
// query folded into the frames' blocks; lse != NULL: the log-sum-exp of
// every row written into lse [B, H, S] (training save).
int tvts_space_core(const void* qkv, void* out, void* lse, void* cls_partial, int B, int T,
                    int N, int H, int dh, float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dh == 64)
    return (int)launch_space_core<64, false>(qkv, nullptr, nullptr, out, lse, cls_partial,
                                             nullptr, B, T, N, H, scale, s);
  if (dh == 80)
    return (int)launch_space_core<80, false>(qkv, nullptr, nullptr, out, lse, cls_partial,
                                             nullptr, B, T, N, H, scale, s);
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
    return (int)(space ? launch_space_core<64, true>(q, k, v, out, nullptr, nullptr, strides, B,
                                                     T, N, H, scale, s)
                       : launch_time_core<64, true>(q, k, v, out, nullptr, strides, B, T, N, H,
                                                    scale, s));
  if (dh == 80)
    return (int)(space ? launch_space_core<80, true>(q, k, v, out, nullptr, nullptr, strides, B,
                                                     T, N, H, scale, s)
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

// H4, the CLS-only space tail (cls_pool.cuh): out [B, D] = basecls +
// Proj(the CLS row of the space attention of LN(x)) from x [B, S, D] alone.
// Scratch (f32): q [B, D], u [B, H, D], partial [B, C, H, D + 2], zf [B, H, D];
// att [B, D] bf16. Chunks of R rows (a multiple of 16), C * R >= S.
int tvts_cls_only(const void* x, int B, int S, int H, int dh, const void* ln_w,
                  const void* ln_b, float eps, const void* wqkv, const void* bqkv,
                  const void* wproj, const void* bproj, const void* basecls, void* out, void* q,
                  void* u, void* partial, void* zf, void* att, int C, int R, void* stream) {
  const int D = H * dh;
  if (H > tvts::CP_HEADS || D % 16 || D > 1280 || R % tvts::CP_ROWS || (i64)C * R < S ||
      dh > 128 || dh % tvts::MV_ROWS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bf16* W = (const bf16*)wqkv;
  const bf16* bias = (const bf16*)bqkv;
  const dim3 mv_grid(D / tvts::MV_ROWS, (B + tvts::MV_BATCH - 1) / tvts::MV_BATCH);
  const size_t mv_smem = (size_t)tvts::MV_BATCH * D * sizeof(float);
  tvts::ClsMatvecArgs a{};
  a.B = B;
  a.N = D;
  a.K = D;
  // q = Wq LN(x_0) + bq, f32
  a.W = W;
  a.bias = bias;
  a.in = x;
  a.in_bstride = (i64)S * D;
  a.group_rows = D;
  a.ln_w = (const float*)ln_w;
  a.ln_b = (const float*)ln_b;
  a.eps = eps;
  a.out = q;
  a.out_bstride = D;
  tvts::cls_matvec_kernel<false, true><<<mv_grid, 256, mv_smem, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  tvts::cls_u_kernel<<<dim3(H, (B + tvts::MV_BATCH - 1) / tvts::MV_BATCH,
                             (D / 2 + tvts::U_THREADS - 1) / tvts::U_THREADS),
                        tvts::U_THREADS, 0, s>>>(
      (const float*)q, W + (i64)D * D, (float*)u, B, H, dh, 1.f / sqrtf((float)dh));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = tvts::cls_pool_smem(D);
  const int pairs_per_warp = (D / 16 + 7) / 8;
  if (pairs_per_warp <= 6) {
    err = cudaFuncSetAttribute(tvts::cls_pool_kernel<6>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    tvts::cls_pool_kernel<6><<<dim3(C, B), tvts::CP_THREADS, smem, s>>>(
        (const bf16*)x, S, D, H, (const float*)ln_w, (const float*)ln_b, eps, (const float*)u,
        R, (float*)partial);
  } else {
    err = cudaFuncSetAttribute(tvts::cls_pool_kernel<10>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    tvts::cls_pool_kernel<10><<<dim3(C, B), tvts::CP_THREADS, smem, s>>>(
        (const bf16*)x, S, D, H, (const float*)ln_w, (const float*)ln_b, eps, (const float*)u,
        R, (float*)partial);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  tvts::cls_pool_merge_kernel<<<dim3(H, B), 256, 0, s>>>((const float*)partial, C, H, D,
                                                        (float*)zf);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // att = Wv_h zf_h + bv (bf16)
  a.W = W + 2 * (i64)D * D;
  a.bias = bias + 2 * D;
  a.in = zf;
  a.in_bstride = (i64)H * D;
  a.in_gstride = D;
  a.group_rows = dh;
  a.ln_w = a.ln_b = nullptr;
  a.out = att;
  tvts::cls_matvec_kernel<true, false><<<mv_grid, 256, mv_smem, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // out = basecls + Wproj att + bproj
  a.W = (const bf16*)wproj;
  a.bias = (const bf16*)bproj;
  a.in = att;
  a.in_bstride = D;
  a.in_gstride = 0;
  a.group_rows = D;
  a.res = (const bf16*)basecls;
  a.res_bstride = D;
  a.out = out;
  tvts::cls_matvec_kernel<false, false><<<mv_grid, 256, mv_smem, s>>>(a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// training backward (weight_grad.cuh, attention_bwd.cuh)
// ---------------------------------------------------------------------------

// tvts_wgrad: weight_grad.cu.

// out[i] = sum over p < P of partial[p * n + i], in order; out_f32 / out_bf16 may be NULL.
int tvts_reduce(const void* partial, int P, i64 n, void* out_f32, void* out_bf16,
                void* stream) {
  const int threads = 256;
  tvts::reduce_partials_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                                 (cudaStream_t)stream>>>((const float*)partial, P, n,
                                                         (float*)out_f32, (bf16*)out_bf16);
  return (int)cudaGetLastError();
}

// dx = res + LN_bwd(dxln) over M rows of width K (res may be NULL), in
// `blocks` blocks of 8 warps, the rows split evenly over the warps; with part
// != NULL (f32 [2][blocks][K] scratch) also dln_w = sum dxln * xhat and dln_b
// = sum dxln (f32 [K] each). ops/block_backward.py::ln_bwd_plan sizes the
// launch and checks what is checked here again.
int tvts_ln_bwd(const void* X, const void* stats, const void* dxln, const void* ln_w,
                const void* res, void* dx, void* part, void* dln_w, void* dln_b, int M, int K,
                int blocks, void* stream) {
  const void* ptrs[] = {X, dxln, ln_w, res, dx, part, dln_w, dln_b};
  for (const void* ptr : ptrs)
    if ((uintptr_t)ptr % 16) return (int)cudaErrorInvalidValue;
  if ((uintptr_t)stats % 8 || M < 1 || K < 8 || K % 8 || K > 256 * tvts::LNB_MAXC ||
      blocks < 1 || (part && (!dln_w || !dln_b)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = tvts::ln_bwd_smem(K, part != nullptr);
  cudaStream_t s = (cudaStream_t)stream;
  void (*kernels[])(const bf16*, const float2*, const float*, const float*, const bf16*, bf16*,
                    float*, int, int) = {tvts::ln_bwd_kernel<1>, tvts::ln_bwd_kernel<2>,
                                              tvts::ln_bwd_kernel<3>, tvts::ln_bwd_kernel<4>,
                                              tvts::ln_bwd_kernel<5>};
  auto kernel = kernels[(K + 255) / 256 - 1];
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, tvts::LNB_WARPS * 32, smem, s>>>(
      (const bf16*)X, (const float2*)stats, (const float*)dxln, (const float*)ln_w,
      (const bf16*)res, (bf16*)dx, (float*)part, M, K);
  err = cudaGetLastError();
  if (err != cudaSuccess || !part) return (int)err;
  tvts::ln_colsum_kernel<<<dim3((K + tvts::LNC_COLS - 1) / tvts::LNC_COLS, 2),
                           tvts::LNC_WARPS * 32, 0, s>>>(
      (const float*)part, blocks, K, (float*)dln_w, (float*)dln_b);
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

// dqkv [B, S, 3*H*dh] of the H5 space core in one pass (S = 1 + T*N rows), a
// block per (frame, head, clip); the CLS token's dq, dk, dv as f32 partials
// into cls_partial [B, T, H, 3, dh] (combined by tvts_cls_grad_combine). A
// group too large for one block's shared memory returns cudaErrorInvalidValue
// (ops/block_backward.py sends it to tvts_flash_bwd before the launch, by
// tvts_space_bwd_one_block).
int tvts_space_bwd(const void* qkv, const void* dO, const void* lse, const void* delta,
                   void* dqkv, void* cls_partial, int B, int T, int N, int H, int dh,
                   float scale, void* stream) {
  if (B < 1 || T < 1 || H < 1 || !tvts::space_bwd_one_block(N, dh))
    return (int)cudaErrorInvalidValue;
  tvts::FlashBwdArgs a;
  a.qkv = (const bf16*)qkv;
  a.dO = (const bf16*)dO;
  a.lse = (const float*)lse;
  a.delta = (const float*)delta;
  a.dqkv = (bf16*)dqkv;
  a.cls_partial = (float*)cls_partial;
  a.T = T;
  a.N = N;
  a.S = 1 + T * N;
  a.H = H;
  a.scale = scale;
  a.causal = 0;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(dh == 64 ? tvts::launch_space_bwd<64>(a, B, s)
                        : tvts::launch_space_bwd<80>(a, B, s));
}

// 1 when a space group of N patches at head dim dh fits one tvts_space_bwd
// block, else 0 (the group takes tvts_flash_bwd).
int tvts_space_bwd_one_block(int N, int dh) { return tvts::space_bwd_one_block(N, dh); }

// dqkv of the H6 time core (S = 1 + T*N rows, T <= 32), the CLS token's dq,
// dk, dv as f32 partials into cls_partial [B, N, H, 3, dh].
int tvts_time_bwd(const void* qkv, const void* dO, const void* lse, const void* delta,
                  void* dqkv, void* cls_partial, int B, int T, int N, int H, int dh,
                  float scale, void* stream) {
  if (T < 1 || T > 32 || N < 1 || H < 1) return (int)cudaErrorInvalidValue;
  const int HG = tvts::time_bwd_heads(T, H);
  const size_t smem = tvts::time_bwd_smem(T, HG, dh);
  const dim3 grid(N, B, (H + HG - 1) / HG);
  const int threads = ((T + 1) * HG + 31) / 32 * 32;
  cudaStream_t s = (cudaStream_t)stream;
  auto kernel = dh == 64 ? tvts::time_bwd_kernel<64> : dh == 80 ? tvts::time_bwd_kernel<80>
                                                                 : nullptr;
  if (!kernel) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, s>>>((const bf16*)qkv, (const bf16*)dO, (const float*)lse,
                                     (const float*)delta, (bf16*)dqkv, (float*)cls_partial, T,
                                     N, H, HG, scale);
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
