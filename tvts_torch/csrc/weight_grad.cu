// wgrad (weight_grad.cuh) in a translation unit of its own, built in parallel
// with the others (tvts_torch/ops/block_kernels.py::build): its two kernels
// (with and without the LayerNorm prologue) take ptxas seconds each.
#define TVTS_WGRAD_UNIT
#include "weight_grad.cuh"

namespace tvts {

// The tensor maps (boxes of 64 columns by 64 rows, zeros past M and past N1 /
// N2), then the kernel. The caller has checked what wgrad_plan checks.
inline cudaError_t launch_wgrad(const bf16* A, i64 lda, const bf16* B, i64 ldb,
                                const WgradArgs& a, int splits, cudaStream_t stream) {
  const bool ln = a.stats != nullptr;
  // roles (weight_grad.cuh): R = A, Q = B; with the LayerNorm R = B, Q = A
  const bf16* R = ln ? B : A;
  const bf16* Q = ln ? A : B;
  const i64 ldr = ln ? ldb : lda, ldq = ln ? lda : ldb;
  const int NR = ln ? a.N2 : a.N1, NQ = ln ? a.N1 : a.N2;
  CUtensorMap tmR, tmQ;
  if (!tile_map(&tmR, R, a.M, NR, ldr, WG_BK) || !tile_map(&tmQ, Q, a.M, NQ, ldq, WG_BK))
    return cudaErrorInvalidValue;
  auto kernel = ln ? wgrad_kernel<true> : wgrad_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, WG_SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((NQ + WG_BN - 1) / WG_BN, (NR + WG_BM - 1) / WG_BM, splits);
  kernel<<<grid, wgrad_threads(ln), WG_SMEM, stream>>>(tmR, tmQ, a);
  return cudaGetLastError();
}

}  // namespace tvts

using tvts::bf16;
using tvts::i64;

extern "C" {

// partial[z] = A[rows of split z]^T B[same rows] (f32 [N1, N2] each), B optionally
// LN(x) from the row stats. Split z holds rows [z * rows_per_split, min(M, (z +
// 1) * rows_per_split)). colsum != NULL: f32 [splits * T][N1], T the tiles of
// the other operand (ceil(N2 / 256) without LN, ceil(N2 / 128) with it), row
// z * T + t the column sums of A over the stages t, t + T, .. of split z.
int tvts_wgrad(const void* A, i64 lda, const void* Bm, i64 ldb, const void* stats,
               const void* ln_w, const void* ln_b, void* partial, void* colsum, int M, int N1,
               int N2, int splits, int rows_per_split, void* stream) {
  // what ops/block_backward.py::wgrad_plan checks, again: TMA's 16-byte rule
  // on bases and row strides, whole 64-row stages a split, no empty split
  const void* ptrs[] = {A, Bm, partial, colsum, stats, ln_w, ln_b};
  for (const void* ptr : ptrs)
    if ((uintptr_t)ptr % 16) return (int)cudaErrorInvalidValue;
  if (M < 1 || N1 < 8 || N2 < 8 || N1 % 8 || N2 % 8 || lda % 8 || ldb % 8 || lda < N1 ||
      ldb < N2 || rows_per_split < 1 || rows_per_split % tvts::WG_BK || splits < 1 ||
      (i64)splits * rows_per_split < M || (i64)(splits - 1) * rows_per_split >= M ||
      (stats && (!ln_w || !ln_b)))
    return (int)cudaErrorInvalidValue;
  tvts::WgradArgs a;
  a.stats = (const float2*)stats;
  a.ln_w = (const float*)ln_w;
  a.ln_b = (const float*)ln_b;
  a.partial = (float*)partial;
  a.colsum = (float*)colsum;
  a.M = M;
  a.N1 = N1;
  a.N2 = N2;
  a.rows_per_split = rows_per_split;
  return (int)tvts::launch_wgrad((const bf16*)A, lda, (const bf16*)Bm, ldb, a, splits,
                                 (cudaStream_t)stream);
}

}  // extern "C"
