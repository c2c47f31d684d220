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
// does: the time core and the CLS row take the element type as a template
// parameter (f32 loads, the same f32 arithmetic), and the space core has an
// f32 kernel of its own (space_core_f32_kernel: SIMT, no tensor cores).
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
// Time core (H1 and H6's forward packed; H9 time strided, bf16 or f32). It replaces the
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
// the 1 + T key and value rows of the group into shared memory in their own
// element type (the CLS key and value rows once a block, not once a head;
// f32 doubles the bytes, 125 KB a block at T = 32, d = 80, and the arithmetic
// is the same).
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

// bytes of a block's q, k and v rows at `elem` bytes an element
inline size_t time_core_smem(int T, int HG, int DH, int elem = 2) {
  return (size_t)(3 * T + 2) * HG * DH * elem;
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
// Space core in f32 (H9 on f32 q, k, v): tvts_tpu/ops/pallas_attention.py::
// _space_attention_fused (:31) takes f32 as well as bf16, with f32 products;
// the bf16 core above runs mma.sync on bf16 fragments, and TF32 mma would
// round the products, so this instance is SIMT FMA. Patch (t, i) attends
// over the CLS key plus frame t's N patches; patch rows only (the CLS row is
// the split-KV kernel's). Bound on the H100: the f32 FMA rate (3 d FMAs per
// (query, key) pair with the rescale, against 4 d bytes of q, k, v and out
// per query: far above the byte line at 50 to 257 keys a query).
// Design: one block per (b, t, h) stages the frame's 1 + N key and value
// rows in f32 in shared memory once (16-byte cp.async; 2 (N + 1) d * 4 bytes:
// 164 KB at N = 256, d = 80, against the 227 KB a block may take, which
// bounds N: space_core_f32_smem); a thread per query row (up to 256 a block,
// rows strided over the threads beyond) keeps its q and output in registers
// and walks the keys in order with the time core's exact max-shifted online
// f32 softmax, each logit one f32 chain over the head dim. Every thread of a
// warp reads the same key row, so the shared-memory reads are broadcasts.
// ---------------------------------------------------------------------------
constexpr int SPF_MAX_THREADS = 256;

inline size_t space_core_f32_smem(int N, int DH) { return (size_t)2 * (N + 1) * DH * 4; }

template <int DH>
__global__ void __launch_bounds__(SPF_MAX_THREADS)
    space_core_f32_kernel(const CoreAddr<DH, true, float> view, int T, int N, float scale) {
  extern __shared__ __align__(16) unsigned char sf_raw[];
  constexpr int VPR = DH / 4;  // 16-byte vectors per head row
  float* sK = reinterpret_cast<float*>(sf_raw);  // [1 + N][DH], key 0 the CLS token
  float* sV = sK + (N + 1) * DH;                 // [1 + N][DH]
  const int b = blockIdx.x / T, t = blockIdx.x % T, h = blockIdx.y;
  const i64 frame_row0 = 1 + (i64)t * N;
  for (int e = threadIdx.x; e < (N + 1) * VPR; e += blockDim.x) {
    const int r = e / VPR, c = (e - r * VPR) * 4;
    const i64 tok = r == 0 ? 0 : frame_row0 + r - 1;
    cp_async16(sK + r * DH + c, view.row(1, b, h, tok) + c);
    cp_async16(sV + r * DH + c, view.row(2, b, h, tok) + c);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  for (int qi = threadIdx.x; qi < N; qi += blockDim.x) {
    const float* qr = view.row(0, b, h, frame_row0 + qi);
    float qf[DH], acc[DH];
#pragma unroll
    for (int i = 0; i < DH; i += 8) {
      float f[8];
      load8(qr + i, f);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        qf[i + e] = f[e] * scale;
        acc[i + e] = 0.f;
      }
    }
    float m = -INFINITY, l = 0.f;
    for (int s = 0; s <= N; ++s) {
      const float* kr = sK + s * DH;
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
      const float* vr = sV + s * DH;
#pragma unroll
      for (int i = 0; i < DH; i += 8) {
        float f[8];
        load8(vr + i, f);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[i + e] = acc[i + e] * corr + p * f[e];
      }
      m = m_new;
    }
    const float inv = 1.f / l;
    float* dst = view.out_row(b, h, frame_row0 + qi);
#pragma unroll
    for (int i = 0; i < DH; i += 8) {
      float o[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) o[e] = acc[i + e] * inv;
      store8(dst + i, o);
    }
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
