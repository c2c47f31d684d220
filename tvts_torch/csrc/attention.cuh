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
// compile-time addressing. H9 also takes f32 q, k and v, as the JAX function
// does: the CLS row takes the element type as a template parameter (f32
// loads, the same f32 arithmetic), and the space and time cores have f32
// kernels of their own (space_core_f32_kernel: 3xTF32 on the tensor cores;
// time_core_f32_kernel: f32 FMA, a persistent grid of warps that copy one
// group while they compute another).
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
// [B, S, 3D] qkv rows at `q` (bf16); strided: three tensors of element E.
template <int DH, bool STRIDED, typename E = bf16>
struct CoreAddr {
  const E *q, *k, *v;
  E* o;
  int H, S;
  CoreStrides st;

  __device__ __forceinline__ const E* row(int which, int b, int h, i64 tok) const {
    if constexpr (STRIDED) {
      const E* p = which == 0 ? q : which == 1 ? k : v;
      const i64* s = which == 0 ? st.q : which == 1 ? st.k : st.v;
      return p + b * s[0] + h * s[1] + tok * s[2];
    } else {
      const int D = H * DH;
      return q + ((i64)b * S + tok) * 3 * D + which * D + h * DH;
    }
  }
  __device__ __forceinline__ E* out_row(int b, int h, i64 tok) const {
    if constexpr (STRIDED)
      return o + b * st.o[0] + h * st.o[1] + tok * st.o[2];
    else
      return o + ((i64)b * S + tok) * H * DH + h * DH;
  }
};

// ---------------------------------------------------------------------------
// Time core (H1 and H6's forward packed; H9 time strided in bf16). It replaces the
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
// the 1 + T key and value rows of the group into shared memory (the CLS key
// and value rows once a block, not once a head).
// A thread owns each (t, h) query row, with an exact max-shifted online f32
// softmax over the 1 + T keys in the first version's order of operations
// (its training-step gates sit near their limits at H/14: a logit summed in
// another order moved the worst gradient error from 0.102 to 0.124 against a
// limit of 0.12; PERF.md). Each output row
// goes back over its own query row in shared memory and leaves in 16-byte
// stores. Writes patch rows only (the CLS row is the split-KV kernel's).
// ---------------------------------------------------------------------------
constexpr int TIME_MAX_ROWS = 128;  // query rows (threads) a block

template <int DH, bool STRIDED, typename E = bf16>
__global__ void __launch_bounds__(TIME_MAX_ROWS, 2)
    time_core_kernel(const CoreAddr<DH, STRIDED, E> view, float* __restrict__ lse, int T, int N,
                     int HG, float scale) {
  extern __shared__ __align__(16) unsigned char tsm_raw[];
  constexpr int EPV = 16 / sizeof(E);  // elements a 16-byte vector
  constexpr int VPR = DH / EPV;        // 16-byte vectors per head row
  const int n = blockIdx.x, b = blockIdx.y, h0 = blockIdx.z * HG;
  const int H = view.H, S = view.S;
  const int hg = min(HG, H - h0);
  const int RW = HG * DH;  // a token's row in shared memory: the group's heads
  E* sq = reinterpret_cast<E*>(tsm_raw);  // [T][RW]
  E* sk = sq + T * RW;        // [1 + T][RW], key s: s == 0 the CLS token, else frame s - 1
  E* sv = sk + (T + 1) * RW;  // [1 + T][RW]

  const int per_row = hg * VPR;
  for (int e = threadIdx.x; e < (3 * T + 2) * per_row; e += blockDim.x) {
    const int r = e / per_row, rem = e - r * per_row;
    const int hh = rem / VPR, c = rem - hh * VPR;
    int which, s;
    E* dst;
    if (r < T) {
      which = 0; s = r + 1; dst = sq + r * RW;
    } else if (r < 2 * T + 1) {
      which = 1; s = r - T; dst = sk + s * RW;
    } else {
      which = 2; s = r - 2 * T - 1; dst = sv + s * RW;
    }
    const i64 tok = s == 0 ? 0 : 1 + (i64)(s - 1) * N + n;
    cp_async16(dst + hh * DH + c * EPV, view.row(which, b, h0 + hh, tok) + c * EPV);
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
    load8(sq + t * RW + hh * DH + i, f);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      qf[i + e] = f[e] * scale;
      acc[i + e] = 0.f;
    }
  }
  float m = -INFINITY, l = 0.f;
  for (int s = 0; s <= T; ++s) {
    const E* kr = sk + s * RW + hh * DH;
    float dot = 0.f;
#pragma unroll
    for (int i = 0; i < DH; i += 8) {
      float f[8];
      load8(kr + i, f);
#pragma unroll
      for (int e = 0; e < 8; ++e) dot += qf[i + e] * f[e];
    }
    const float m_new = fmaxf(m, dot);
    const float corr = __expf(m - m_new);
    const float p = __expf(dot - m_new);
    l = l * corr + p;
    const E* vr = sv + s * RW + hh * DH;
#pragma unroll
    for (int i = 0; i < DH; i += 8) {
      float f[8];
      load8(vr + i, f);
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
      store8(sq + t * RW + hh * DH + i, o);  // only q read it
    }
    if (lse) lse[((i64)b * H + h0 + hh) * S + 1 + (i64)t * N + n] = m + __logf(l);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < T * per_row; e += blockDim.x) {
    const int r = e / per_row, rem = e - r * per_row;
    const int h = rem / VPR, c = rem - h * VPR;
    *reinterpret_cast<uint4*>(view.out_row(b, h0 + h, 1 + (i64)r * N + n) + c * EPV) =
        *reinterpret_cast<const uint4*>(sq + r * RW + h * DH + c * EPV);
  }
}

// Heads a block takes: at most TIME_MAX_ROWS / T, the H heads split as evenly
// as that allows.
inline int time_core_heads(int T, int H) {
  const int cap = std::max(1, TIME_MAX_ROWS / T);
  const int groups = (H + cap - 1) / cap;
  return (H + groups - 1) / groups;
}

// bytes of a block's q, k and v rows
inline size_t time_core_smem(int T, int HG, int DH) {
  return (size_t)(3 * T + 2) * HG * DH * sizeof(bf16);
}

// ---------------------------------------------------------------------------
// Space core (H2 and H5's forward packed; H9 space strided). It replaces the
// space attention inside tvts_tpu/ops/pallas_block_attention.py::
// fused_space_attention_block_v9 (:2964) and pallas_attention.py::
// _space_attention_fused (:31). Patch (t, i) attends over the CLS key plus
// frame t's N patches: per (b, t, h), N queries over 1 + N keys, the CLS key
// being key 0. With `cls_partial` the same block also carries the clip's CLS
// query as one more query row over frame t's patches (and the CLS key in the
// t = 0 block only) and writes its f32 partial (m, l, acc[DH]) to
// cls_partial [B, H, T, DH + 2]; cls_combine_kernel merges the T partials.
// Bound on the H100: bytes (q, k and v read once, the output written once;
// at B/16, B = 64: 0.28 ms of bytes against 0.09 ms of tensor-core flops).
// Design: one block per (b, t, h) owns the whole frame. Its 1 + N key and
// value rows are staged in shared memory once (16-byte cp.async, one group
// per 64-key tile, so tile 0's arithmetic starts while the later tiles are
// in flight), padded with zero rows to a multiple of 16; every 16-row query
// slab of the frame walks them there (warp w takes slabs w, w + 4, ...; its
// q fragments come straight from global memory). The arithmetic is the first
// version's, in its order: 64-key tiles in key order with the CLS key in tile
// 0, an online f32 softmax in the log2 domain rescaled once a tile, P rounded
// to bf16 for PV on mma.sync m16n8k16. Only the 16-key chunks that hold a
// live key run (N = 196: the fourth tile does 16 keys, not 64); a skipped
// chunk would have added exact zeros, so the patch rows and their lse are
// bit for bit the first version's. The CLS row keeps P in f32 for P V, as
// the TPU kernel does (pallas_block_attention.py:2940-2944): its slab (the
// last) is the first slab of its warp, which leaves the row's probabilities
// and each tile's max in shared memory; a warp with one slab fewer (the
// frame's slabs do not divide evenly over the warps: 13 at N = 196) sums
// p * v in f32 from there once its own slabs are done, off the block's
// critical path. 61 KB (d = 64, N = 196) to 96 KB (d = 80, N = 256) a
// block: two or three blocks an SM; the staged frame bounds N
// (space_core_smem against the 227 KB a block may take).
// ---------------------------------------------------------------------------
constexpr int SP_WARPS = 4;
constexpr int SP_BK = 64;  // keys a tile: the softmax's rescale points

__host__ __device__ inline int space_core_rows(int N) { return (N + 1 + 15) / 16 * 16; }
__host__ __device__ inline int space_core_tiles(int N) { return (N + 1 + SP_BK - 1) / SP_BK; }

// K and V [rows][DH + 8] bf16, then the CLS row's P [tiles * SP_BK] and each
// tile's running max [tiles] in f32
inline size_t space_core_smem(int N, int DH) {
  return (size_t)2 * space_core_rows(N) * (DH + 8) * sizeof(bf16) +
         (size_t)space_core_tiles(N) * (SP_BK + 1) * sizeof(float);
}

// A warp's 16 query rows: q fragments, output accumulators, the online
// softmax state of rows g and g + 8 (log2 domain) and whether each row is
// the CLS query outside frame 0 (key 0 masked); the CLS query's row in the
// slab, if it holds it.
template <int DH>
struct SpaceSlab {
  uint32_t qf[DH / 16][4];
  float o[DH / 8][4];
  float m[2], l[2];
  bool mask0[2];
  int cls_row;  // -1: no CLS query in this slab
};

// Query row qi of the slab's frame: qi < N the patch, qi == N the CLS token.
template <int DH, bool STRIDED>
__device__ __forceinline__ void space_slab_begin(SpaceSlab<DH>& st,
                                                 const CoreAddr<DH, STRIDED>& view, int b,
                                                 int h, int t, int N, int NQ, int q0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const i64 frame_row0 = 1 + (i64)t * N;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + g + r * 8;
    st.mask0[r] = qi == N && t > 0;
    const bf16* row = qi < NQ ? view.row(0, b, h, qi < N ? frame_row0 + qi : 0) : nullptr;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
      for (int half = 0; half < 2; ++half)  // A fragment: (row, cols t4*2 [+ 8])
        st.qf[kk][r + 2 * half] =
            row ? *reinterpret_cast<const uint32_t*>(row + kk * 16 + half * 8 + t4 * 2) : 0u;
    st.m[r] = -INFINITY;
    st.l[r] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < DH / 8; ++i) st.o[i][0] = st.o[i][1] = st.o[i][2] = st.o[i][3] = 0.f;
  st.cls_row = NQ > N && N >= q0 && N < q0 + 16 ? N - q0 : -1;
}

// The CLS row's P V in f32 (lanes on head-column pairs, four chains of keys
// a pair), from its probabilities sPc, each relative to its tile's running
// max sMt[tile], rescaled to the last tile's max; padding keys have p = 0.
template <int DH>
__device__ __forceinline__ void space_cls_pv(const bf16* sV, const float* sPc,
                                             const float* sMt, int n_keys, float* acc_out) {
  constexpr int LD = DH + 8;
  const int lane = threadIdx.x & 31, n_tiles = (n_keys + SP_BK - 1) / SP_BK;
  const int rows = (n_keys + 15) / 16 * 16;
  const float m_last = sMt[n_tiles - 1];
  for (int c2 = lane; c2 < DH / 2; c2 += 32) {
    float a0 = 0.f, a1 = 0.f;
    for (int i = 0; i < n_tiles; ++i) {
      const int k0 = i * SP_BK, kend = min(k0 + SP_BK, rows);  // a multiple of 4
      float x[4] = {0.f, 0.f, 0.f, 0.f}, y[4] = {0.f, 0.f, 0.f, 0.f};
      for (int j = k0; j < kend; j += 4) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = sPc[j + e];
          const float2 v = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(sV + (j + e) * LD + 2 * c2));
          x[e] += p * v.x;
          y[e] += p * v.y;
        }
      }
      const float w = exp2f(sMt[i] - m_last);
      a0 += w * ((x[0] + x[1]) + (x[2] + x[3]));
      a1 += w * ((y[0] + y[1]) + (y[2] + y[3]));
    }
    *reinterpret_cast<float2*>(acc_out + 2 * c2) = make_float2(a0, a1);
  }
}

template <int DH>
__device__ __forceinline__ void space_slab_tile(SpaceSlab<DH>& st, const bf16* sK,
                                                const bf16* sV, float* sPc, float* sMt,
                                                int k0, int n_keys, float scale_log2) {
  constexpr int LD = DH + 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int n16 = (min(SP_BK, n_keys - k0) + 15) >> 4;  // 16-key chunks with a live key

  // S = Q K^T for the 16 rows x the tile's live chunks (8 n-tiles of 8 keys)
  float s[SP_BK / 8][4];
#pragma unroll
  for (int i = 0; i < SP_BK / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
    for (int np = 0; np < SP_BK / 16; ++np) {
      if (np >= n16) continue;
      uint32_t kf[4];
      const int j = lane >> 3;
      ldmatrix_x4(kf, sK + (k0 + np * 16 + (lane & 7) + (j >> 1) * 8) * LD + kk * 16 +
                          (j & 1) * 8);
      mma_bf16_16816(s[2 * np], st.qf[kk], kf[0], kf[1]);
      mma_bf16_16816(s[2 * np + 1], st.qf[kk], kf[2], kf[3]);
    }

  // online softmax in the log2 domain; this thread owns rows g and g + 8
  float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < SP_BK / 8; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int key = k0 + nt * 8 + t4 * 2 + (c & 1);
      const bool live = key < n_keys && !(key == 0 && st.mask0[c >> 1]);
      const float v = live ? s[nt][c] * scale_log2 : -INFINITY;
      s[nt][c] = v;
      tmax[c >> 1] = fmaxf(tmax[c >> 1], v);
    }
  float corr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
    tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
    // finite: tile 0 holds key 0 (CLS) and, for the CLS query, a patch key
    const float m_new = fmaxf(st.m[r], tmax[r]);
    corr[r] = exp2f(st.m[r] - m_new);
    st.m[r] = m_new;
    st.l[r] *= corr[r];
  }
#pragma unroll
  for (int nt = 0; nt < SP_BK / 8; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float p = exp2f(s[nt][c] - st.m[c >> 1]);
      s[nt][c] = p;
      st.l[c >> 1] += p;
    }
#pragma unroll
  for (int i = 0; i < DH / 8; ++i) {
    st.o[i][0] *= corr[0];
    st.o[i][1] *= corr[0];
    st.o[i][2] *= corr[1];
    st.o[i][3] *= corr[1];
  }
  if (st.cls_row >= 0 && g == (st.cls_row & 7)) {  // the CLS row's f32 P, for space_cls_pv
    const int rc = st.cls_row >> 3;
#pragma unroll
    for (int nt = 0; nt < SP_BK / 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if ((c >> 1) == rc) sPc[k0 + nt * 8 + t4 * 2 + (c & 1)] = s[nt][c];
    if (t4 == 0) sMt[k0 / SP_BK] = rc ? st.m[1] : st.m[0];
  }

  // O += P V over the live chunks: the S accumulator layout is the A-fragment layout of P
#pragma unroll
  for (int kt = 0; kt < SP_BK / 16; ++kt) {
    if (kt >= n16) continue;
    uint32_t pa[4];
    pa[0] = pack_bf16x2(s[2 * kt][0], s[2 * kt][1]);
    pa[1] = pack_bf16x2(s[2 * kt][2], s[2 * kt][3]);
    pa[2] = pack_bf16x2(s[2 * kt + 1][0], s[2 * kt + 1][1]);
    pa[3] = pack_bf16x2(s[2 * kt + 1][2], s[2 * kt + 1][3]);
#pragma unroll
    for (int dp = 0; dp < DH / 16; ++dp) {
      uint32_t vf[4];
      ldmatrix_x4_trans(vf, sV + (k0 + kt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                dp * 16 + ((lane >> 4) & 1) * 8);
      mma_bf16_16816(st.o[2 * dp], pa, vf[0], vf[1]);
      mma_bf16_16816(st.o[2 * dp + 1], pa, vf[2], vf[3]);
    }
  }
}

// Patch rows: output (bf16) and lse; the CLS row: its f32 partial.
template <int DH, bool STRIDED>
__device__ __forceinline__ void space_slab_end(SpaceSlab<DH>& st,
                                               const CoreAddr<DH, STRIDED>& view, float* lse,
                                               float* cls_partial, int b, int h, int t, int T,
                                               int N, int q0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int H = view.H, S = view.S;
  const i64 frame_row0 = 1 + (i64)t * N;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    st.l[r] += __shfl_xor_sync(0xffffffffu, st.l[r], 1);
    st.l[r] += __shfl_xor_sync(0xffffffffu, st.l[r], 2);
    const int qi = q0 + g + r * 8;
    if (qi == N && cls_partial) {  // the CLS query (its acc: space_cls_pv): m in natural-log
      if (t4 == 0) {                 // units of the scaled logits
        float* out = cls_partial + (((i64)b * H + h) * T + t) * (DH + 2);
        out[0] = st.m[r] * 0.6931471805599453f;
        out[1] = st.l[r];
      }
      continue;
    }
    if (qi >= N) continue;
    if (lse && t4 == 0)  // m is in log2 units: lse = (m + log2 l) ln 2
      lse[((i64)b * H + h) * S + frame_row0 + qi] =
          (st.m[r] + __log2f(st.l[r])) * 0.6931471805599453f;
    const float inv = 1.f / st.l[r];
    bf16* dst = view.out_row(b, h, frame_row0 + qi);
#pragma unroll
    for (int i = 0; i < DH / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(dst + i * 8 + t4 * 2) =
          __floats2bfloat162_rn(st.o[i][2 * r] * inv, st.o[i][2 * r + 1] * inv);
  }
}

template <int DH, bool STRIDED>
__global__ void __launch_bounds__(SP_WARPS * 32, 2)
    space_core_kernel(const CoreAddr<DH, STRIDED> view, float* __restrict__ lse,
                      float* __restrict__ cls_partial, int T, int N, float scale_log2) {
  constexpr int LD = DH + 8;
  constexpr int VPR = DH / 8;  // 16-byte vectors per head row
  extern __shared__ __align__(16) bf16 ssm[];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int b = blockIdx.x / T, t = blockIdx.x % T, h = blockIdx.y;
  const int n_keys = N + 1, rows = space_core_rows(N);
  const int n_tiles = (n_keys + SP_BK - 1) / SP_BK;
  bf16* sK = ssm;              // [rows][LD], key s: s == 0 the CLS token, else patch s - 1
  bf16* sV = ssm + rows * LD;  // [rows][LD]
  float* sPc = reinterpret_cast<float*>(sV + rows * LD);  // [n_tiles * SP_BK] the CLS row's P
  float* sMt = sPc + n_tiles * SP_BK;                     // [n_tiles] its max at each tile
  const i64 frame_row0 = 1 + (i64)t * N;

  // stage the frame's keys and values, one cp.async group per tile
  for (int k0 = 0; k0 < n_keys; k0 += SP_BK) {
    const int kend = min(k0 + SP_BK, rows);
    for (int e = tid; e < (kend - k0) * VPR; e += SP_WARPS * 32) {
      const int r = k0 + e / VPR, c = (e % VPR) * 8;
      if (r < n_keys) {
        const i64 tok = r == 0 ? 0 : frame_row0 + r - 1;
        cp_async16(sK + r * LD + c, view.row(1, b, h, tok) + c);
        cp_async16(sV + r * LD + c, view.row(2, b, h, tok) + c);
      } else {  // padding: zero rows (their P is 0, so V must be finite)
        *reinterpret_cast<uint4*>(sK + r * LD + c) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(sV + r * LD + c) = make_uint4(0, 0, 0, 0);
      }
    }
    cp_async_commit();
  }

  const int NQ = N + (cls_partial != nullptr);
  const int n_slabs = (NQ + 15) / 16;
  // the CLS query's slab (the last) goes first on its warp; the next warp,
  // one slab fewer unless the slabs divide evenly, sums its P V
  const int cls_slab = cls_partial ? n_slabs - 1 : -1;
  const int cls_warp = cls_slab % SP_WARPS, pv_warp = (cls_warp + 1) % SP_WARPS;
  const int first = cls_partial && warp == cls_warp ? cls_slab : warp;
  SpaceSlab<DH> st;
  // each warp's first slab walks the tiles as they land
  const bool active = first < n_slabs;
  if (active) space_slab_begin(st, view, b, h, t, N, NQ, first * 16);
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait_pending(n_tiles - 1 - i);
    __syncthreads();
    if (active) space_slab_tile(st, sK, sV, sPc, sMt, i * SP_BK, n_keys, scale_log2);
  }
  if (active) space_slab_end(st, view, lse, cls_partial, b, h, t, T, N, first * 16);
  if (cls_partial) __syncthreads();  // the CLS row's P in place
  // the other slabs find every tile in place
  for (int slab = warp; slab < n_slabs; slab += SP_WARPS) {
    if (slab == first) continue;
    space_slab_begin(st, view, b, h, t, N, NQ, slab * 16);
    for (int k0 = 0; k0 < n_keys; k0 += SP_BK)
      space_slab_tile(st, sK, sV, sPc, sMt, k0, n_keys, scale_log2);
    space_slab_end(st, view, lse, cls_partial, b, h, t, T, N, slab * 16);
  }
  if (cls_partial && warp == pv_warp)
    space_cls_pv<DH>(sV, sPc, sMt, n_keys,
                     cls_partial + (((i64)b * view.H + h) * T + t) * (DH + 2) + 2);
}

// ---------------------------------------------------------------------------
// Space core in f32 (H9 space on f32 q, k, v): it replaces tvts_tpu/ops/
// pallas_attention.py::_space_attention_fused (:31) on f32 inputs, whose
// products are f32. Patch (t, i) attends over the CLS key plus frame t's N
// patches; patch rows only (the CLS row is the split-KV kernel's).
// Bound on the H100: 4 d flops a (query, key) pair at 50 to 257 keys a query
// is far above the byte line in f32 SIMT (0.171 ms at B = 8, N = 196, d = 64
// at 67 TFLOP/s, against 0.069 ms of bytes), so the products go to the tensor
// cores. A single TF32 product reads each operand with 10 mantissa bits and
// lies >= 4e-4 * max|ref| from f32, outside the f32 band, so each product is
// 3xTF32: x = hi + lo (split_tf32), a * b = lo_a hi_b + hi_a lo_b + hi_a hi_b
// on mma.sync m16n8k8 with f32 accumulation, the small terms first (what the
// splits and the dropped lo lo term lose is ~2^-20 of the product). The
// probabilities are split too: P read once as TF32 would lie ~2^-11 off. On
// this route the bound is max(bytes, three products at 495 TFLOP/s) = 0.069
// ms at B = 8, N = 196, d = 64; mma.sync's own TF32 rate on the card is ~320
// TFLOP/s, 0.116 ms for the three products.
// mma.sync over wgmma: wgmma takes tf32 operands K-major only, so V would
// have to be transposed as it is staged, the split parts of K and V would
// have to sit in shared memory (twice the frame: H/14's would not fit), and
// a warpgroup's 64-row tiles would leave N = 49 frames three quarters empty;
// a warp's 16-row slabs fit every frame size.
// Design, the bf16 space core's: one block per (b, t, h) stages the frame's
// 1 + N key and value rows in f32 once (16-byte cp.async, one group per
// 32-key tile, so tile 0's arithmetic starts while the later tiles are in
// flight), rows padded to d + 4 floats (the fragment loads hit 32 distinct
// banks) and zero rows to a multiple of 8 keys; the frame's 16-row query
// slabs walk them (warp w takes slabs w, w + W, ...; its q fragments, split
// once, come from global memory a slab ahead): 32-key tiles in key order
// with the CLS key in tile 0, an online f32 softmax in the log2 domain
// rescaled once a tile, and only the 8-key chunks that hold a live key. P V
// takes the S accumulator as its A fragment with the keys of each 8-key
// chunk permuted (k index c holds key 2c, c + 4 key 2c + 1, and V's B
// fragment reads the same keys), so no shuffle moves P between the two
// products. Each of the SM's four schedulers drives its own tensor core, so
// a block has 4 warps (W) where two 106 KB blocks fit an SM (N = 196, d =
// 64), else 8 on one block (173 KB at N = 256, d = 80); 3, 5 or 7 warps
// leave one scheduler with twice the slabs. Slabs left over after whole
// rounds of the warps would keep one warp busy longer than the rest: a
// single one (13 slabs on 4 warps at N = 196) has its key chunks split over
// the warps, whose partials are merged at the end. The staged frame bounds
// N (space_core_f32_smem). What holds it at ~2x mma.sync's rate: with 170 to
// 240 registers a thread (the split q, the accumulators, S) an SM holds 8
// warps, too few to hide the split, softmax and load latencies behind the
// tensor cores.
// ---------------------------------------------------------------------------
constexpr int SPF_MAX_WARPS = 8;
constexpr int SPF_BK = 32;  // keys a tile: the softmax's rescale points

__host__ __device__ inline int space_core_f32_rows(int N) { return (N + 1 + 7) / 8 * 8; }

// K and V [rows][DH + 4] f32
inline size_t space_core_f32_smem(int N, int DH) {
  return (size_t)2 * space_core_f32_rows(N) * (DH + 4) * sizeof(float);
}

// Warps a block: four where two blocks fit an SM's 228 KB (each block also
// holds 1 KB of the system's), else eight on the one block an SM holds.
inline int space_core_f32_warps(int N, int DH) {
  return 2 * (space_core_f32_smem(N, DH) + 1024) <= 228 * 1024 ? 4 : SPF_MAX_WARPS;
}

// x = hi + lo: hi is x truncated to TF32 (10 mantissa bits), so the mma
// reads it exactly; lo = x - hi (exact in f32) goes in as raw bits, which the
// mma reads truncated to TF32 as well: |lo| < 2^-10 |x|, so what it drops is
// < 2^-20 |x|. Two ops an element (a mask and a subtraction), against five
// for rounding both parts (cvt.rna): the split runs on every K and V element
// a slab reads, and rounding costs ~20% of the kernel's time at B = 8, N =
// 196, d = 64 on an H100 at 700 W (PERF.md).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// D = A(16x8, row) * B(8x8, col) + D, TF32 in, f32 accumulate.
__device__ __forceinline__ void mma_tf32_1688(float (&c)[4], const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c[i] += a * b[i] for M accumulators in 3xTF32, from the split A fragment
// and each B fragment's two elements: lo hi, hi lo, hi hi, each product over
// all M before the next (M independent mma between two that depend)
template <int M>
__device__ __forceinline__ void mma_3xtf32(float (&c)[M][4], const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4], const float (&b)[M][2]) {
  uint32_t hi[M][2], lo[M][2];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    split_tf32(b[i][0], hi[i][0], lo[i][0]);
    split_tf32(b[i][1], hi[i][1], lo[i][1]);
  }
#pragma unroll
  for (int i = 0; i < M; ++i) mma_tf32_1688(c[i], a_lo, hi[i][0], hi[i][1]);
#pragma unroll
  for (int i = 0; i < M; ++i) mma_tf32_1688(c[i], a_hi, lo[i][0], lo[i][1]);
#pragma unroll
  for (int i = 0; i < M; ++i) mma_tf32_1688(c[i], a_hi, hi[i][0], hi[i][1]);
}

// A warp's 16 query rows: split q fragments (A fragment of the k step kk:
// rows g, g + 8, columns 8 kk + t4 and + 4), output accumulators, the online
// softmax state of rows g and g + 8 (log2 domain).
template <int DH>
struct SpaceSlabF32 {
  uint32_t qh[DH / 8][4], ql[DH / 8][4];
  float o[DH / 8][4];
  float m[2], l[2];
};

// The raw q A fragments of the slab at query row q0 (rows g and g + 8,
// columns 8 kk + t4 and + 4), 0 past N: loaded a pass ahead of their use.
template <int DH>
__device__ __forceinline__ void space_f32_q_load(const CoreAddr<DH, true, float>& view, int b,
                                                 int h, int t, int N, int q0,
                                                 float (&q)[DH / 8][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + g + r * 8;
    const float* row = qi < N ? view.row(0, b, h, 1 + (i64)t * N + qi) : nullptr;
#pragma unroll
    for (int kk = 0; kk < DH / 8; ++kk)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        q[kk][r + 2 * half] = row ? row[kk * 8 + half * 4 + t4] : 0.f;
  }
}

// q takes the logit scale (log2 units) before its split, so S comes out
// scaled.
template <int DH>
__device__ __forceinline__ void space_f32_slab_begin(SpaceSlabF32<DH>& st,
                                                     const float (&q)[DH / 8][4],
                                                     float scale_log2) {
#pragma unroll
  for (int kk = 0; kk < DH / 8; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(q[kk][i] * scale_log2, st.qh[kk][i], st.ql[kk][i]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    st.m[r] = -INFINITY;
    st.l[r] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < DH / 8; ++i) st.o[i][0] = st.o[i][1] = st.o[i][2] = st.o[i][3] = 0.f;
}

// One key tile of a slab, keys k0.. below n_keys. FULL: all SPF_BK keys are
// live, so the chunk loops unroll without a branch and no key is masked;
// the last tile of a frame (or of a split slab's share) runs its live
// chunks one at a time.
template <int DH, bool FULL>
__device__ __forceinline__ void space_f32_slab_tile(SpaceSlabF32<DH>& st, const float* sK,
                                                    const float* sV, int k0, int n_keys) {
  constexpr int LD = DH + 4;
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  // 8-key chunks with a live key
  const int n8 = FULL ? SPF_BK / 8 : (min(SPF_BK, n_keys - k0) + 7) >> 3;

  // S = Q K^T for the 16 rows x the tile's live chunks; B fragment: key g, columns t4 and + 4
  float s[SPF_BK / 8][4];
#pragma unroll
  for (int i = 0; i < SPF_BK / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DH / 8; ++kk) {
    if (FULL) {
      float kb[SPF_BK / 8][2];
#pragma unroll
      for (int nt = 0; nt < SPF_BK / 8; ++nt) {
        const float* kr = sK + (k0 + nt * 8 + g) * LD + kk * 8 + t4;
        kb[nt][0] = kr[0];
        kb[nt][1] = kr[4];
      }
      mma_3xtf32(s, st.qh[kk], st.ql[kk], kb);
    } else {
#pragma unroll
      for (int nt = 0; nt < SPF_BK / 8; ++nt) {
        if (nt >= n8) continue;
        const float* kr = sK + (k0 + nt * 8 + g) * LD + kk * 8 + t4;
        const float kb[1][2] = {{kr[0], kr[4]}};
        mma_3xtf32(reinterpret_cast<float(&)[1][4]>(s[nt]), st.qh[kk], st.ql[kk], kb);
      }
    }
  }

  // online softmax in the log2 domain; this thread owns rows g and g + 8
  float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < SPF_BK / 8; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int key = k0 + nt * 8 + t4 * 2 + (c & 1);
      if (!FULL && key >= n_keys) s[nt][c] = -INFINITY;
      tmax[c >> 1] = fmaxf(tmax[c >> 1], s[nt][c]);
    }
  float corr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
    tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
    const float m_new = fmaxf(st.m[r], tmax[r]);  // finite: every tile holds a live key
    corr[r] = exp2f(st.m[r] - m_new);
    st.m[r] = m_new;
    st.l[r] *= corr[r];
  }
#pragma unroll
  for (int nt = 0; nt < SPF_BK / 8; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float p = exp2f(s[nt][c] - st.m[c >> 1]);
      s[nt][c] = p;
      st.l[c >> 1] += p;
    }
#pragma unroll
  for (int i = 0; i < DH / 8; ++i) {
    st.o[i][0] *= corr[0];
    st.o[i][1] *= corr[0];
    st.o[i][2] *= corr[1];
    st.o[i][3] *= corr[1];
  }

  // O += P V over the live chunks: k index t4 is key 2 t4 and t4 + 4 key
  // 2 t4 + 1, so the A fragment of P is the S accumulator as it lies
#pragma unroll
  for (int kt = 0; kt < SPF_BK / 8; ++kt) {
    if (!FULL && kt >= n8) continue;
    uint32_t ph[4], pl[4];
    split_tf32(s[kt][0], ph[0], pl[0]);  // row g, key 2 t4
    split_tf32(s[kt][2], ph[1], pl[1]);  // row g + 8, key 2 t4
    split_tf32(s[kt][1], ph[2], pl[2]);  // row g, key 2 t4 + 1
    split_tf32(s[kt][3], ph[3], pl[3]);  // row g + 8, key 2 t4 + 1
    const float* vr = sV + (k0 + kt * 8 + 2 * t4) * LD + g;
    float vb[DH / 8][2];
#pragma unroll
    for (int dt = 0; dt < DH / 8; ++dt) {
      vb[dt][0] = vr[dt * 8];
      vb[dt][1] = vr[LD + dt * 8];
    }
    mma_3xtf32(st.o, ph, pl, vb);
  }
}

template <int DH>
__device__ __forceinline__ void space_f32_slab_end(SpaceSlabF32<DH>& st,
                                                   const CoreAddr<DH, true, float>& view, int b,
                                                   int h, int t, int N, int q0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    st.l[r] += __shfl_xor_sync(0xffffffffu, st.l[r], 1);
    st.l[r] += __shfl_xor_sync(0xffffffffu, st.l[r], 2);
    const int qi = q0 + g + r * 8;
    if (qi >= N) continue;
    const float inv = 1.f / st.l[r];
    float* dst = view.out_row(b, h, 1 + (i64)t * N + qi);
#pragma unroll
    for (int i = 0; i < DH / 8; ++i)
      *reinterpret_cast<float2*>(dst + i * 8 + t4 * 2) =
          make_float2(st.o[i][2 * r] * inv, st.o[i][2 * r + 1] * inv);
  }
}

// A split slab's partial, warp by warp: each lane's o and its rows' m and l
// (log2 domain, l summed over the row's four lanes), at sP + (warp * 32 +
// lane) * (DH / 2 + 4); then the merge of the warps' partials by lane.
template <int DH>
__device__ __forceinline__ void space_f32_slab_park(SpaceSlabF32<DH>& st, float* sP) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* p = sP + (warp * 32 + lane) * (DH / 2 + 4);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    st.l[r] += __shfl_xor_sync(0xffffffffu, st.l[r], 1);
    st.l[r] += __shfl_xor_sync(0xffffffffu, st.l[r], 2);
    p[DH / 2 + r] = st.m[r];
    p[DH / 2 + 2 + r] = st.l[r];
  }
#pragma unroll
  for (int i = 0; i < DH / 8; ++i)
    *reinterpret_cast<float4*>(p + 4 * i) =
        make_float4(st.o[i][0], st.o[i][1], st.o[i][2], st.o[i][3]);
}

template <int DH>
__device__ __forceinline__ void space_f32_slab_merge(const float* sP, int warps,
                                                     const CoreAddr<DH, true, float>& view,
                                                     int b, int h, int t, int N, int q0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, o[DH / 8][4] = {};
  for (int w = 0; w < warps; ++w) {
    const float* p = sP + (w * 32 + lane) * (DH / 2 + 4);
#pragma unroll
    for (int r = 0; r < 2; ++r) m[r] = fmaxf(m[r], p[DH / 2 + r]);
  }
  for (int w = 0; w < warps; ++w) {
    const float* p = sP + (w * 32 + lane) * (DH / 2 + 4);
    const float c[2] = {exp2f(p[DH / 2] - m[0]), exp2f(p[DH / 2 + 1] - m[1])};
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] += c[r] * p[DH / 2 + 2 + r];
#pragma unroll
    for (int i = 0; i < DH / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][e] += c[e >> 1] * p[4 * i + e];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + g + r * 8;
    if (qi >= N) continue;
    const float inv = 1.f / l[r];
    float* dst = view.out_row(b, h, 1 + (i64)t * N + qi);
#pragma unroll
    for (int i = 0; i < DH / 8; ++i)
      *reinterpret_cast<float2*>(dst + i * 8 + t4 * 2) =
          make_float2(o[i][2 * r] * inv, o[i][2 * r + 1] * inv);
  }
}

template <int DH>
__global__ void __launch_bounds__(SPF_MAX_WARPS * 32)
    space_core_f32_kernel(const CoreAddr<DH, true, float> view, int T, int N,
                          float scale_log2) {
  constexpr int LD = DH + 4;
  constexpr int VPR = DH / 4;  // 16-byte vectors per head row
  extern __shared__ __align__(16) float sf[];
  const int tid = threadIdx.x, warp = tid >> 5, warps = blockDim.x >> 5;
  const int b = blockIdx.x / T, t = blockIdx.x % T, h = blockIdx.y;
  const int n_keys = N + 1, rows = space_core_f32_rows(N);
  const int n_tiles = (n_keys + SPF_BK - 1) / SPF_BK;
  float* sK = sf;              // [rows][LD], key s: s == 0 the CLS token, else patch s - 1
  float* sV = sf + rows * LD;  // [rows][LD]
  const i64 frame_row0 = 1 + (i64)t * N;

  // stage the frame's keys and values, one cp.async group per tile
  for (int k0 = 0; k0 < n_keys; k0 += SPF_BK) {
    const int kend = min(k0 + SPF_BK, rows);
    for (int e = tid; e < (kend - k0) * VPR; e += blockDim.x) {
      const int r = k0 + e / VPR, c = (e % VPR) * 4;
      if (r < n_keys) {
        const i64 tok = r == 0 ? 0 : frame_row0 + r - 1;
        cp_async16(sK + r * LD + c, view.row(1, b, h, tok) + c);
        cp_async16(sV + r * LD + c, view.row(2, b, h, tok) + c);
      } else {  // padding: zero rows (their P is 0, so V must be finite)
        *reinterpret_cast<float4*>(sK + r * LD + c) = make_float4(0.f, 0.f, 0.f, 0.f);
        *reinterpret_cast<float4*>(sV + r * LD + c) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    cp_async_commit();
  }

  const int n_slabs = (N + 15) / 16;
  // one slab over after whole rounds of the warps (13 slabs on 4 at N = 196)
  // would keep a warp busy a quarter longer than the rest: its keys are
  // split over the warps instead, and their partials merged at the end in
  // the staged frame's place
  const bool split = n_slabs > warps && n_slabs % warps == 1 &&
                     warps * 32 * (DH / 2 + 4) <= 2 * rows * LD;
  const int n_whole = n_slabs - split;
  SpaceSlabF32<DH> st;
  // warp w takes slabs w', w' + W, ... (W warps; w' = w rotated by the block,
  // so that a warp with a slab more falls on another of the SM's four
  // schedulers in each block), then, if split, its share of the split slab's
  // 8-key chunks, keys [k_lo, k_hi); each pass loads the next one's q. Its
  // first slab walks the tiles as they land (every warp joins that pass's
  // barriers, a slab or not), the others find every tile in place; one call
  // site a tile kind keeps the code small.
  auto pass_q0 = [&](int slab) {  // the query row of the pass at `slab`; -1: none
    if (slab < n_whole) return slab * 16;
    return split && slab < n_whole + warps ? n_whole * 16 : -1;
  };
  const int first = (warp + blockIdx.x + blockIdx.y) % warps;
  float q[DH / 8][4];
  int q0 = pass_q0(first);
  if (q0 < 0) {  // no slab: join the first pass's barriers
    for (int i = 0; i < n_tiles; ++i) {
      cp_async_wait_pending(n_tiles - 1 - i);
      __syncthreads();
    }
  } else {
    space_f32_q_load(view, b, h, t, N, q0, q);
  }
  for (int slab = first; q0 >= 0; slab += warps) {
    const bool share = slab >= n_whole;
    const int chunks = rows / 8;
    const int k_lo = share ? warp * chunks / warps * 8 : 0;
    const int k_hi = share ? min((warp + 1) * chunks / warps * 8, n_keys) : n_keys;
    space_f32_slab_begin(st, q, scale_log2);
    const int next = pass_q0(slab + warps);
    if (next >= 0) space_f32_q_load(view, b, h, t, N, next, q);
    for (int k0 = k_lo, i = 0; k0 < k_hi; k0 += SPF_BK, ++i) {
      if (slab == first) {
        cp_async_wait_pending(n_tiles - 1 - i);
        __syncthreads();
      }
      if (k_hi - k0 >= SPF_BK)
        space_f32_slab_tile<DH, true>(st, sK, sV, k0, k_hi);
      else
        space_f32_slab_tile<DH, false>(st, sK, sV, k0, k_hi);
    }
    if (share) break;
    space_f32_slab_end(st, view, b, h, t, N, q0);
    q0 = next;
  }
  if (split) {  // every warp is done with K and V: their place takes the partials
    __syncthreads();
    space_f32_slab_park(st, sf);
    __syncthreads();
    if (warp == 0) space_f32_slab_merge(sf, warps, view, b, h, t, N, n_whole * 16);
  }
}

// ---------------------------------------------------------------------------
// Time core in f32 (H9 time on f32 q, k, v): it replaces tvts_tpu/ops/
// pallas_attention.py::_time_attention_fused (:69) on f32 inputs. Patch
// (t, n) attends over the CLS key plus location n in every frame: per
// (b, n, h), T <= 32 queries over 1 + T keys; patch rows only.
// Bound on the H100: bytes (q, k and v read once, the output written once,
// 4 bytes an element: 0.069 ms at B = 8, N = 196, H = 12, d = 64; the 1 + T
// keys a query are 0.8 GFLOP of f32 FMA there, 0.012 ms at 67 TFLOP/s).
// What a byte-bound kernel needs is memory-level parallelism, so this is not
// the bf16 time core (whose order of operations the training gates hold, and
// whose block loads, then computes, then stores): a persistent grid of
// blocks of up to four warps, each warp walking (b, n, h) groups in turn
// with its own two buffers in shared memory: while it computes one group,
// 16-byte cp.async copies bring the next group's T query rows and 1 + T key
// and value rows (neighbouring lanes on neighbouring addresses). Eight lanes
// take a query row, each every eighth 16-byte vector of the head dim, so a
// logit is four short f32 chains a lane and three shuffles, and four rows
// run at once. The softmax is exact and max-shifted in f32: the 1 + T
// logits first (in registers), then their max, then p and P V; the output
// leaves from registers in 16-byte stores. The key loops run a compile-time
// count of keys, KEYS >= 1 + T (13 for T <= 12, else 33), without a branch:
// keys past T read key T again and get p = 0, so the logits' loads and
// shuffles interleave across keys. Two buffers of (3 T + 2) d f32 a
// warp: 76 KB a block at T = 12, d = 64 (two blocks an SM); fewer warps a
// block where four do not fit (three at T = 32, d = 80).
// ---------------------------------------------------------------------------
constexpr int TF_WARPS = 4;  // warps a block, at most
constexpr int TF_LANES = 8;  // lanes a query row

// shared memory of one warp: two buffers of a group's q, k and v rows
inline size_t time_core_f32_warp_smem(int T, int DH) {
  return (size_t)2 * (3 * T + 2) * DH * sizeof(float);
}

inline int time_core_f32_warps(int T, int DH) {
  return std::max(1, std::min(TF_WARPS, (int)(SMEM_OPTIN / time_core_f32_warp_smem(T, DH))));
}

// Copy group `item` = (b, n, h)'s q rows (frames 0..T-1), then its k and v
// rows (key 0 the CLS token, key s frame s - 1) into buf, a warp's lanes on
// consecutive 16-byte vectors.
template <int DH>
__device__ __forceinline__ void time_f32_stage(const CoreAddr<DH, true, float>& view, i64 item,
                                               int T, int N, float* buf) {
  constexpr int VPR = DH / 4;
  const int lane = threadIdx.x & 31, h = (int)(item % view.H);
  const i64 bn = item / view.H;
  const int n = (int)(bn % N), b = (int)(bn / N);
  for (int e = lane; e < (3 * T + 2) * VPR; e += 32) {
    const int r = e / VPR, c = (e - r * VPR) * 4;
    const int which = r < T ? 0 : r <= 2 * T ? 1 : 2;
    const int s = which == 0 ? r + 1 : which == 1 ? r - T : r - 2 * T - 1;
    const i64 tok = s == 0 ? 0 : 1 + (i64)(s - 1) * N + n;
    cp_async16(buf + r * DH + c, view.row(which, b, h, tok) + c);
  }
}

template <int DH, int KEYS>
__global__ void __launch_bounds__(TF_WARPS * 32)
    time_core_f32_kernel(const CoreAddr<DH, true, float> view, int B, int T, int N,
                         float scale) {
  constexpr int VPR = DH / 4;                           // 16-byte vectors a head row
  constexpr int VPL = (VPR + TF_LANES - 1) / TF_LANES;  // of them a lane takes, at most
  extern __shared__ __align__(16) float tf_sm[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int j = lane % TF_LANES, rg = lane / TF_LANES;  // vector offset, row in the 4 at once
  const int H = view.H, buf_floats = (3 * T + 2) * DH;
  float* bufs = tf_sm + (size_t)warp * 2 * buf_floats;
  const i64 n_items = (i64)B * N * H, stride = (i64)gridDim.x * warps;
  i64 item = (i64)blockIdx.x * warps + warp;
  if (item < n_items) time_f32_stage(view, item, T, N, bufs);
  cp_async_commit();
  for (int cur = 0; item < n_items; item += stride, cur ^= 1) {
    if (item + stride < n_items)
      time_f32_stage(view, item + stride, T, N, bufs + (cur ^ 1) * buf_floats);
    cp_async_commit();
    cp_async_wait_pending(1);  // this group's rows have landed
    __syncwarp();
    const float4* sq = reinterpret_cast<const float4*>(bufs + cur * buf_floats);
    const float4* sk = sq + T * VPR;
    const float4* sv = sk + (T + 1) * VPR;
    const int h = (int)(item % H);
    const i64 bn = item / H;
    const int n = (int)(bn % N), b = (int)(bn / N);
    for (int t0 = 0; t0 < T; t0 += 32 / TF_LANES) {
      const int t = min(t0 + rg, T - 1);  // past T: row T - 1 again, not stored
      float4 q[VPL], acc[VPL];
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        const int c = j + i * TF_LANES;
        q[i] = c < VPR ? sq[t * VPR + c] : make_float4(0.f, 0.f, 0.f, 0.f);
        q[i].x *= scale; q[i].y *= scale; q[i].z *= scale; q[i].w *= scale;
        acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      float logit[KEYS], m = -INFINITY;
#pragma unroll
      for (int s = 0; s < KEYS; ++s) {
        const int key = min(s, T);
        float dx = 0.f, dy = 0.f, dz = 0.f, dw = 0.f;
#pragma unroll
        for (int i = 0; i < VPL; ++i) {  // a vector past the row: q is 0 there
          const float4 k = sk[key * VPR + min(j + i * TF_LANES, VPR - 1)];
          dx += q[i].x * k.x; dy += q[i].y * k.y; dz += q[i].z * k.z; dw += q[i].w * k.w;
        }
        float dot = (dx + dy) + (dz + dw);
#pragma unroll
        for (int o = 1; o < TF_LANES; o <<= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
        logit[s] = s <= T ? dot : -INFINITY;
        m = fmaxf(m, logit[s]);
      }
      float l = 0.f;
#pragma unroll
      for (int s = 0; s < KEYS; ++s) {
        const float p = __expf(logit[s] - m);  // 0 past T
        l += p;
#pragma unroll
        for (int i = 0; i < VPL; ++i) {  // a vector past the row: not stored
          const float4 v = sv[min(s, T) * VPR + min(j + i * TF_LANES, VPR - 1)];
          acc[i].x += p * v.x; acc[i].y += p * v.y; acc[i].z += p * v.z; acc[i].w += p * v.w;
        }
      }
      if (t0 + rg < T) {
        const float inv = 1.f / l;
        float4* dst = reinterpret_cast<float4*>(view.out_row(b, h, 1 + (i64)t * N + n));
#pragma unroll
        for (int i = 0; i < VPL; ++i) {
          const int c = j + i * TF_LANES;
          if (c < VPR)
            dst[c] = make_float4(acc[i].x * inv, acc[i].y * inv, acc[i].z * inv, acc[i].w * inv);
        }
      }
    }
    __syncwarp();  // every lane is done with this buffer before it is refilled
  }
}

// ---------------------------------------------------------------------------
// CLS global row of H1 and H9 (H2 folds its CLS query into the space core,
// whose T partials cls_combine_kernel merges too; E: the element type of q,
// k, v and the output, bf16 or f32 for H9): one query per (b, h) over
// L keys. The TPU kernels carry the online-softmax state across sequential
// grid steps; CUDA blocks run in no order, so this is split-KV: each block
// writes a partial (m, l, acc[DH]) in f32 for its chunk of keys, and
// cls_combine_kernel merges the chunks of each (b, h) in a fixed order (no
// atomics: the result does not vary run to run).
// ---------------------------------------------------------------------------
constexpr int CLS_CHUNK = 128;

template <int DH, typename E = bf16>
__global__ void __launch_bounds__(CLS_CHUNK)
    cls_partial_kernel(const E* __restrict__ q, i64 q_bstride, const E* __restrict__ k,
                       const E* __restrict__ v, i64 kv_bstride, i64 kv_rstride, int L,
                       int H, float scale, float* __restrict__ partial) {
  __shared__ float sq[DH];
  __shared__ float sp[CLS_CHUNK];
  __shared__ float red[CLS_CHUNK / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nC = gridDim.x;
  for (int i = tid; i < DH; i += CLS_CHUNK)
    sq[i] = to_f32(q[(i64)b * q_bstride + h * DH + i]) * scale;
  __syncthreads();

  const int j = c * CLS_CHUNK + tid;
  float logit = -INFINITY;
  if (j < L) {
    const E* kr = k + (i64)b * kv_bstride + (i64)j * kv_rstride + h * DH;
    float dot = 0.f;
#pragma unroll
    for (int i = 0; i < DH; i += 8) {
      float f[8];
      load8(kr + i, f);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dot += sq[i + 2 * e] * f[2 * e] + sq[i + 2 * e + 1] * f[2 * e + 1];
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
    const E* vc = v + (i64)b * kv_bstride + (i64)c * CLS_CHUNK * kv_rstride + h * DH + i;
    float acc = 0.f;
    for (int jj = 0; jj < nj; ++jj) acc += sp[jj] * to_f32(vc[(i64)jj * kv_rstride]);
    out[2 + i] = acc;
  }
  if (tid == 0) {
    float lsum = 0.f;
    for (int w = 0; w < CLS_CHUNK / 32; ++w) lsum += red[w];
    out[0] = mx;
    out[1] = lsum;
  }
}

template <int DH, typename E = bf16>
__global__ void cls_combine_kernel(const float* __restrict__ partial, int nC, int H,
                                   E* __restrict__ out, i64 out_bstride,
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
  store1(out + (i64)b * out_bstride + h * DH + i, acc / lsum);
  if (lse && i == 0) lse[((i64)b * H + h) * lse_S] = mx + __logf(lsum);
}

}  // namespace tvts
