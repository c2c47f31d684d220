// Plain C entry points of the tvts_torch Hopper kernels, loaded with ctypes
// (tvts_torch/ops/block_kernels.py builds this file with nvcc for sm_90a).
// Every function launches on the given stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() after its launches.
#include "attention.cuh"
#include "attention_bwd.cuh"
#include "cls_pool.cuh"
#include "ln_gemm.cuh"
#include "text_attention.cuh"
#include "text_attention_bwd.cuh"
#include "weight_grad.cuh"

using tvts::bf16;
using tvts::i64;

// Launchers of the attention cores, packed (H1 / H2) and strided (H9).
namespace {

template <int DH, bool STRIDED, typename E = bf16>
tvts::CoreAddr<DH, STRIDED, E> core_view(const void* q, const void* k, const void* v, void* out,
                                         int H, int S, const i64* strides) {
  tvts::CoreAddr<DH, STRIDED, E> view;
  view.q = (const E*)q;
  view.k = (const E*)k;
  view.v = (const E*)v;
  view.o = (E*)out;
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

// H9's space core on f32 q, k, v (space_core_f32_kernel): patch rows only
template <int DH>
cudaError_t launch_space_core_f32(const void* q, const void* k, const void* v, void* out,
                                  const i64* strides, int B, int T, int N, int H, float scale,
                                  cudaStream_t s) {
  const size_t smem = tvts::space_core_f32_smem(N, DH);
  if (smem > (size_t)tvts::SMEM_OPTIN) return cudaErrorInvalidValue;
  auto kernel = tvts::space_core_f32_kernel<DH>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)  // two 106 KB blocks an SM at N = 196, d = 64
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(B * T, H), tvts::space_core_f32_warps(N, DH) * 32, smem, s>>>(
      core_view<DH, true, float>(q, k, v, out, H, 1 + T * N, strides), T, N,
      scale * 1.4426950408889634f);
  return cudaGetLastError();
}

// H9's time core on f32 q, k, v (time_core_f32_kernel): patch rows only, a
// persistent grid of as many blocks as fit the card at once
template <int DH>
cudaError_t launch_time_core_f32(const void* q, const void* k, const void* v, void* out,
                                 const i64* strides, int B, int T, int N, int H, float scale,
                                 cudaStream_t s) {
  const int warps = tvts::time_core_f32_warps(T, DH);
  const size_t smem = warps * tvts::time_core_f32_warp_smem(T, DH);
  auto kernel = T <= 12 ? tvts::time_core_f32_kernel<DH, 13> : tvts::time_core_f32_kernel<DH, 33>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, warps * 32, smem);
  if (err != cudaSuccess) return err;
  const i64 groups = (i64)B * N * H;
  const int blocks = (int)std::min<i64>((groups + warps - 1) / warps,
                                        (i64)sms * std::max(1, per_sm));
  kernel<<<blocks, warps * 32, smem, s>>>(
      core_view<DH, true, float>(q, k, v, out, H, 1 + T * N, strides), B, T, N, scale);
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

// 12 element strides (batch, head, row of q, k, v, out) of `elem`-byte
// elements: rows 16-byte aligned
bool strides_ok(const i64* st, int elem) {
  for (int i = 0; i < 12; ++i)
    if (st[i] * elem % 16) return false;
  return true;
}

template <int DH>
cudaError_t launch_core_strided(const void* q, const void* k, const void* v, void* out,
                                const i64* strides, int B, int T, int N, int H, float scale,
                                int space, int f32, cudaStream_t s) {
  if (f32)
    return space ? launch_space_core_f32<DH>(q, k, v, out, strides, B, T, N, H, scale, s)
                 : launch_time_core_f32<DH>(q, k, v, out, strides, B, T, N, H, scale, s);
  return space ? launch_space_core<DH, true>(q, k, v, out, nullptr, nullptr, strides, B, T, N,
                                             H, scale, s)
               : launch_time_core<DH, true>(q, k, v, out, nullptr, strides, B, T, N, H, scale,
                                            s);
}

template <int DH, typename E>
cudaError_t launch_cls_attention(const void* q, i64 q_bstride, const void* k, const void* v,
                                 i64 kv_bstride, i64 kv_rstride, int L, void* out,
                                 i64 out_bstride, void* partial, void* lse, int B, int H,
                                 float scale, cudaStream_t s) {
  const int nC = (L + tvts::CLS_CHUNK - 1) / tvts::CLS_CHUNK;
  tvts::cls_partial_kernel<DH, E><<<dim3(nC, H, B), tvts::CLS_CHUNK, 0, s>>>(
      (const E*)q, q_bstride, (const E*)k, (const E*)v, kv_bstride, kv_rstride, L, H, scale,
      (float*)partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  tvts::cls_combine_kernel<DH, E><<<dim3(H, B), DH, 0, s>>>((const float*)partial, nC, H,
                                                             (E*)out, out_bstride, (float*)lse, L);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* tvts_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Y[M, N] = epilogue(LN?(X[M, K]) @ W[N, K]^T + bias), see ln_gemm.cuh.
// ln_w == NULL: no LayerNorm. Else the row pass first writes LN(X) to Xn
// (bf16 scratch [M, K]) and the LayerNorm row statistics to stats (f32 [M, 2],
// kept by the training forward), and the product reads Xn. bias/res may be
// NULL; res only with a bf16 Y and epi 0. Yf != NULL: f32 output there
// instead of Y. epi (ln_gemm.cuh's Epilogue): 1 also writes the
// pre-activation product to Y2 (bf16); 2 / 3 read the hidden Hin (bf16 / f32)
// and write product * act'(Hin) to Y and act(Hin) to Y2; Y2 and Hin are
// [M, N] at stride ldy. blocks: the persistent grid, 1..tiles (the caller's
// plan: one block an SM).
int tvts_ln_gemm(const void* X, i64 lda, const void* ln_w, const void* ln_b, float eps,
                 void* stats, void* Xn, const void* W, const void* bias, const void* res,
                 i64 ldres, void* Y, void* Yf, i64 ldy, int M, int N, int K, int act, void* Y2,
                 const void* Hin, int epi, int blocks, void* stream) {
  // what block_kernels.py::gemm_plan and ln_rows_plan check, again: K a
  // multiple of the k step, 16-byte aligned operands and row strides (TMA's,
  // the row pass's and the epilogue's rules)
  const void* ptrs[] = {X, W, bias, res, Y, Yf, Y2, Hin, ln_w, ln_b, Xn};
  for (const void* ptr : ptrs)
    if ((uintptr_t)ptr % 16) return (int)cudaErrorInvalidValue;
  if (K % tvts::GEMM_BK != 0 || N % 8 != 0 || lda % 8 != 0 || ldy % (Yf ? 4 : 8) != 0 ||
      ldres % 8 != 0 || M < 1 || act < 0 || act > 2 || epi < 0 || epi > 3)
    return (int)cudaErrorInvalidValue;
  if (epi != tvts::EPI_PLAIN && (Yf || !Y || !Y2)) return (int)cudaErrorInvalidValue;
  if (!Yf && !Y) return (int)cudaErrorInvalidValue;
  // the residual comes in through the bf16 output's slot of the epilogue
  if (res && (Yf || epi != tvts::EPI_PLAIN)) return (int)cudaErrorInvalidValue;
  if (epi >= tvts::EPI_ACT_GRAD_BF16 && (!Hin || bias || res || ln_w))
    return (int)cudaErrorInvalidValue;
  tvts::GemmArgs a;
  a.X = (const bf16*)X;
  a.lda = lda;
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
  const tvts::LnRowsArgs ln = {(const bf16*)X, lda, M, K, (const float*)ln_w, (const float*)ln_b,
                               eps, (float2*)stats, (bf16*)Xn};
  return (int)tvts::launch_ln_gemm(a, ln_w ? &ln : nullptr, epi, blocks, (cudaStream_t)stream);
}

// The LayerNorm row pass alone (ln_gemm.cuh): Y [M, K] bf16 (contiguous) =
// LN(X [M, K] at row stride lda) and its row statistics into stats [M, 2] f32.
int tvts_ln_rows(const void* X, i64 lda, int M, int K, const void* ln_w, const void* ln_b,
                 float eps, void* stats, void* Y, void* stream) {
  const void* ptrs[] = {X, ln_w, ln_b, Y};
  for (const void* ptr : ptrs)
    if (!ptr || (uintptr_t)ptr % 16) return (int)cudaErrorInvalidValue;
  const tvts::LnRowsArgs a = {(const bf16*)X, lda, M, K, (const float*)ln_w, (const float*)ln_b,
                              eps, (float2*)stats, (bf16*)Y};
  return (int)tvts::launch_ln_rows(a, (cudaStream_t)stream);
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
// order, rows 16-byte aligned. space != 0: the space core, else the time
// core; f32 != 0: f32 elements, else bf16. The logits are scaled by `scale`
// (1 for a pre-scaled q).
int tvts_attention_core_strided(const void* q, const void* k, const void* v, void* out,
                                const i64* strides, int B, int T, int N, int H, int dh,
                                float scale, int space, int f32, void* stream) {
  if (!strides_ok(strides, f32 ? 4 : 2) || (!space && (T < 1 || T > 32)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dh == 64)
    return (int)launch_core_strided<64>(q, k, v, out, strides, B, T, N, H, scale, space, f32, s);
  if (dh == 80)
    return (int)launch_core_strided<80>(q, k, v, out, strides, B, T, N, H, scale, space, f32, s);
  return (int)cudaErrorInvalidValue;
}

// 1 when a frame of N patches at head dim dh fits one f32 space-core block
// (its launch refuses the frame otherwise), else 0.
int tvts_space_core_f32_fits(int N, int dh) {
  return tvts::space_core_f32_smem(N, dh) <= (size_t)tvts::SMEM_OPTIN;
}

// CLS global row: out[b, h*dh:(h+1)*dh] = softmax(q_b,h . k_b,h,j * scale) @ v over
// j < L. Row j of batch b sits at k + b*kv_bstride + j*kv_rstride (v alike).
// partial: f32 scratch [B, H, ceil(L / 128), dh + 2]. lse != NULL: the row's
// log-sum-exp into lse[b, h, 0] of an lse [B, H, L] (training save). f32 != 0:
// q, k, v and out are f32 (H9), else bf16.
int tvts_cls_attention(const void* q, i64 q_bstride, const void* k, const void* v,
                       i64 kv_bstride, i64 kv_rstride, int L, void* out, i64 out_bstride,
                       void* partial, void* lse, int B, int H, int dh, float scale, int f32,
                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define TVTS_CLS(D, E)                                                                        \
  launch_cls_attention<D, E>(q, q_bstride, k, v, kv_bstride, kv_rstride, L, out, out_bstride, \
                             partial, lse, B, H, scale, s)
  if (dh == 64) return (int)(f32 ? TVTS_CLS(64, float) : TVTS_CLS(64, bf16));
  if (dh == 80) return (int)(f32 ? TVTS_CLS(80, float) : TVTS_CLS(80, bf16));
#undef TVTS_CLS
  return (int)cudaErrorInvalidValue;
}

// Self-attention of out [B, S, H*dh] from qkv [B, S, 3*H*dh] (H7 core), causal
// or not; the logits scaled by `scale`. lse != NULL: also each row's
// log-sum-exp into lse [B, H, S] (training save). small: the one-block kernel
// (S <= 128, dh = 64), else the TMA + wgmma one (dh 64 or 88;
// ops/text_attention.py::text_core_plan).
int tvts_text_core(const void* qkv, void* out, void* lse, int B, int S, int H, int dh,
                   float scale, int causal, int small, void* stream) {
  if ((dh != 64 && dh != 88) || S < 1 || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  tvts::TextFwdArgs a{(bf16*)out, (float*)lse, S, H, scale, causal};
  return (int)tvts::launch_text_fwd((const bf16*)qkv, a, B, dh, small, (cudaStream_t)stream);
}

// dqkv [B, S, 3*H*dh] of the H7 core from its saves (qkv, the attention output
// O, lse) and dO. small: the one-block kernel (S <= 128); else lse2p and
// deltap [B, H, Sp] f32 are scratch, Sp = S rounded up to 64.
int tvts_text_core_bwd(const void* qkv, const void* O, const void* dO, const void* lse,
                       void* lse2p, void* deltap, void* dqkv, int B, int S, int Sp, int H,
                       int dh, float scale, int causal, int small, void* stream) {
  if (dh != 64 || S < 1 || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  tvts::TextBwdArgs a{(const bf16*)qkv, (const bf16*)O,  (const bf16*)dO, (const float*)lse,
                      (float*)lse2p,    (float*)deltap,  (bf16*)dqkv,     S,
                      Sp,               H,               scale,           causal};
  return (int)tvts::launch_text_bwd(a, B, small, (cudaStream_t)stream);
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

// dqkv [B, S, 3*H*dh] of the H5 space core by the flash pair, over S = 1 + T*N
// rows, with the CLS token's dq, dk, dv as f32 partials into cls_partial [B, T,
// H, 3, dh] (combined by tvts_cls_grad_combine): the groups over one
// tvts_space_bwd block.
int tvts_flash_bwd(const void* qkv, const void* dO, const void* lse, const void* delta,
                   void* dqkv, void* cls_partial, int B, int T, int N, int S, int H, int dh,
                   float scale, void* stream) {
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
  a.causal = 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (S != 1 + T * N) return (int)cudaErrorInvalidValue;
  if (dh == 64) return (int)tvts::launch_flash_bwd<64, true>(a, B, s);
  if (dh == 80) return (int)tvts::launch_flash_bwd<80, true>(a, B, s);
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
