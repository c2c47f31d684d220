// Attention core of the fused text-attention sub-path (H7), forward: plain
// multi-head self-attention over the [B, S, 3D] qkv rows that ln_gemm writes,
// causal (text tower, S = 77) or not (sort head, S = 917 .. 1181; the joint
// space-time blocks of VideoMAE V2's ViT-g/14, S = 2048). Head dim 64 (every
// text and sort config of the repo) or 88 (ViT-g, the TMA kernel only);
// ops/text_attention.py::text_core_plan refuses anything else before a launch.
//
// Replaces the core of tvts_tpu/ops/pallas_text_attention.py::
// fused_text_attention_block (:102, kernel :43-99), which keeps a whole [S, S]
// score matrix per head in VMEM; at head dim 88 it replaces no TPU kernel (the
// JAX package runs the joint towers as plain XLA attention).
//
// Numerics as the TPU kernel: the logits are scale * (q . k) in f32 (for d =
// 64 the scale is 2^-3, so this is the TPU's q scaled and rounded to bf16
// before the product, bit for bit); P is rounded to bf16 for P V while the row
// sum uses the f32 probabilities; the output is divided by that sum. With a
// non-null `lse` [B, H, S] f32 the kernels also write each row's natural-log
// log-sum-exp of the scaled logits, the save of the training backward
// (text_attention_bwd.cuh); null is the inference path. Keys >= S (the next
// sequence's rows, or zeros past B * S) are masked; with `causal` a key past
// its query is masked too; no row >= S is written.
//
// Bound on the H100: at S = 1181 (the sort head, B = 20, H = 8) the tensor
// cores, 4 * d * S^2 flops a (sequence, head): 0.058 ms; as many exp2 as
// logits take as long again on the SFUs (16 a clock an SM: at d = 64 the two
// rates meet), so only their overlap approaches the bound. At S = 77 (B =
// 80) the bytes, 0.008 ms. Two kernels:
// - text_attn_fwd_kernel (S > TX_SMALL_MAX): a block per (192-query tile,
//   head, sequence). One producer warp loads the block's Q tile once and
//   keeps TMA loads of 64-key K and V tiles in flight into a TXF_STAGES ring
//   (3-D tensor maps over qkv as [B * S, 3H, d], boxes of 64 columns of one
//   head slice, 128-byte swizzle; at d = 88 two boxes a tile, the second
//   holding columns 64..87 and the zeros the map fills in past the slice, so
//   Q K^T runs over 96 columns with no padded copy of qkv and no read of the
//   next head's columns). Three consumer warpgroups own 64 query rows
//   each (three, not two: each K and V tile is read for more queries, and
//   one more warpgroup hides latency; 0.171 against 0.176 ms at the sort
//   shape, 0.087 against 0.097 at H/14's, PERF.md): S = Q K^T on wgmma
//   m64n64k16 from shared memory, the online softmax in registers (the
//   accumulator's rows g and g + 8 of each warp reduce over a quad), O += P V
//   on wgmma m64n64k16 (d = 88: m64n88k16, V's two atoms one LBO apart) with
//   P from registers (the accumulator layout packs into wgmma's A-fragment
//   layout) and V as the MN-major B. At d = 88 a row is 176 bytes, two swizzle
//   atoms, so a stage of the ring is 32 KB and a block 177 KB of shared
//   memory; the tensor cores do 96 / 88 of the logits' work. Pipelined within
//   each warpgroup: tile j's logits and tile j - 1's P V are issued together
//   and tile j's softmax runs while P V does; across warpgroups in no fixed
//   order.
// - text_attn_fwd_small_kernel (S <= TX_SMALL_MAX, the text tower's 77): a
//   block per (head, sequence) reads the sequence's q, k and v rows of its
//   head once (16-byte cp.async), a warp per 16 query rows on mma.sync
//   m16n8k16: the 16-key chunks it needs (up to its own when causal) in
//   registers at once, then an online softmax and P V over 64-key groups,
//   the first kernel's sequence of roundings (P rounded against the running
//   max of each 64-key tile). An exact softmax over all keys, which is the
//   TPU kernel's sequence, moved the H/14 step-0 gate of every kernel from
//   0.1121 to 0.1324 against its 0.12 limit (PERF.md): the gate holds
//   the kernels to an eager path that rounds its logits to bf16, and the
//   text tower's gradients follow the rounding of P. mma.sync, not wgmma:
//   77 rows would fill two 64-row warpgroup tiles to 60%, and the shape is
//   bound by its bytes; the first kernel read each sequence's keys and
//   values once for each 64-query tile.
#pragma once

#include <math.h>

#include "hopper.cuh"

namespace tvts {

constexpr float TX_LOG2E = 1.4426950408889634f;
constexpr float TX_LN2 = 0.6931471805599453f;
// the longest sequence the one-block kernels take (a warp per 16 rows, 8 warps)
constexpr int TX_SMALL_MAX = 128;

// ---------------------------------------------------------------------------
// S > TX_SMALL_MAX: TMA ring + wgmma
// ---------------------------------------------------------------------------
constexpr int TXF_WG = 3;       // consumer warpgroups, 64 query rows each
constexpr int TXF_BK = 64;      // keys a tile (txf_issue_logits: m64n64k16)
constexpr int TXF_STAGES = 4;
constexpr int TXF_BQ = 64 * TXF_WG;               // query rows a block
constexpr int TXF_THREADS = 128 * TXF_WG + 32;    // and one producer warp
constexpr int TXF_ATOM_Q = TXF_BQ * 128;          // a Q tile's 64 columns: rows of 128 bytes
constexpr int TXF_ATOM_T = TXF_BK * 128;          // a K or V tile's 64 columns

// The shapes of a head dim DH (64, or 88 for ViT-g): a row of a head spans
// ATOMS 64-column swizzle atoms (88: columns 0..63, then 64..87 and the zeros
// head_map fills in up to 127); Q K^T reduces over KSTEPS k16 steps (88 -> 96:
// columns 88..95 are those zeros in both operands); P V has N = DH, an
// accumulator of DH / 2 floats a thread, CHUNKS 8-column chunks of it.
template <int DH>
struct TxfHead {
  static_assert(DH == 64 || DH == 88, "the TMA forward takes head dim 64 or 88");
  static constexpr int ATOMS = (DH + 63) / 64;
  static constexpr int KSTEPS = (DH + 15) / 16;
  static constexpr int CHUNKS = DH / 8;
  static constexpr int TILE = TXF_ATOM_T * ATOMS;  // one K or V tile in the ring
  static constexpr int SMEM =
      1024 + TXF_ATOM_Q * ATOMS + TXF_STAGES * 2 * TILE + (1 + 2 * TXF_STAGES) * 8;
};

struct TextFwdArgs {
  bf16* out;   // [B, S, D]
  float* lse;  // [B, H, S] or null
  int S, H;
  float scale;
  int causal;
};

// key tiles a query tile walks: up to its last row when causal
__device__ __forceinline__ int text_fwd_key_tiles(int S, int q0, int causal) {
  const int k_end = causal ? min(S, q0 + TXF_BQ) : S;
  return (k_end + TXF_BK - 1) / TXF_BK;
}

// issues the logits of a warpgroup's 64 rows against a tile of TXF_BK = 64
// keys: S = Q K^T over the head's KSTEPS k16 steps, both from shared memory
// (q: the warpgroup's rows in the first atom, atoms TXF_ATOM_Q apart; k: the
// tile, atoms TXF_ATOM_T apart; the caller fences, commits and waits)
template <int DH>
__device__ __forceinline__ void txf_issue_logits(float (&d)[32], uint32_t q, uint32_t k) {
#pragma unroll
  for (int kk = 0; kk < TxfHead<DH>::KSTEPS; ++kk) {
    const int atom = kk / 4, step = 2 * (kk % 4);
    wgmma_ss_n64(d, sw128_desc(q + atom * TXF_ATOM_Q) + step,
                 sw128_desc(k + atom * TXF_ATOM_T) + step, kk);
  }
}

// issues O += P V over a tile of 64 keys (P from registers, V MN-major: a
// 64-column atom after another, TXF_ATOM_T apart)
template <int DH>
__device__ __forceinline__ void txf_issue_pv(float (&o)[DH / 2], const uint32_t (&p)[4][4],
                                             uint32_t v_tile) {
  const uint64_t dv = sw128_mn_desc(v_tile, TXF_ATOM_T);
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    if constexpr (DH == 64)
      wgmma_rs_n64<1>(o, p[kc], dv + kc * (2048 >> 4), 1);
    else
      wgmma_rs_n88<1>(o, p[kc], dv + kc * (2048 >> 4), 1);
  }
}

// The online softmax of one tile of N keys from k0 on, for this thread's rows
// qrow[0..1], in place: the logits in sc become the f32 probabilities.
// Masked keys -inf (key 0 is visible to every row, so each row's max is
// finite from the first tile on); the max of the raw logits, then p =
// exp2(logit * scale * log2(e) - m) in one multiply-add; the row sums l of
// the f32 p; corr is the factor the earlier output is to be rescaled by (m
// in the log2 domain).
template <int N>
__device__ __forceinline__ void txf_softmax(float (&sc)[N / 2], float (&m)[2], float (&l)[2],
                                            float (&corr)[2], int k0, int S, int causal,
                                            const int (&qrow)[2], int qfirst, int t4,
                                            float scale_log2) {
  if (k0 + N > S || (causal && k0 + N - 1 > qfirst)) {
#pragma unroll
    for (int i = 0; i < N / 8; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = k0 + 8 * i + 2 * t4 + (c & 1);
        if (key >= S || (causal && key > qrow[c >> 1])) sc[4 * i + c] = -INFINITY;
      }
  }
  float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < N / 8; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) tmax[c >> 1] = fmaxf(tmax[c >> 1], sc[4 * i + c]);
  float neg_m[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
    tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
    const float m_new = fmaxf(m[r], tmax[r] * scale_log2);
    corr[r] = exp2f(m[r] - m_new);
    m[r] = m_new;
    neg_m[r] = -m_new;
    l[r] *= corr[r];
  }
#pragma unroll
  for (int i = 0; i < N / 8; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      sc[4 * i + c] = exp2f(fmaf(sc[4 * i + c], scale_log2, neg_m[c >> 1]));
      l[c >> 1] += sc[4 * i + c];
    }
}

// the probabilities of a tile (accumulator layout) rounded to bf16 as the A
// fragments of its P V product: 8-key chunk i is half of fragment i / 2
template <int N>
__device__ __forceinline__ void txf_pack(const float (&p)[N / 2], uint32_t (&pa)[N / 16][4]) {
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    pa[i >> 1][2 * (i & 1)] = pack_bf16x2(p[4 * i], p[4 * i + 1]);
    pa[i >> 1][2 * (i & 1) + 1] = pack_bf16x2(p[4 * i + 2], p[4 * i + 3]);
  }
}

// tm_q, tm_kv: head_map over qkv [B * S, 3 * H * DH] with boxes of TXF_BQ and
// TXF_BK rows (slices 0..H-1 q, H..2H-1 k, 2H..3H-1 v)
template <int DH>
__global__ void __launch_bounds__(TXF_THREADS, 1)
    text_attn_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_kv, const TextFwdArgs a) {
  using Head = TxfHead<DH>;
  extern __shared__ uint8_t txf_smem[];
  const uint32_t raw = smem_addr(txf_smem);
  const uint32_t sq = (raw + 1023) & ~1023u;  // the swizzle pattern repeats every 1 KB
  const uint32_t ring = sq + Head::ATOMS * TXF_ATOM_Q;
  const uint32_t qbar = ring + TXF_STAGES * 2 * Head::TILE;
  const uint32_t full = qbar + 8, empty = full + 8 * TXF_STAGES;

  const int tid = threadIdx.x, wg = tid >> 7;
  const int q0 = blockIdx.x * TXF_BQ, h = blockIdx.y, b = blockIdx.z;
  const int S = a.S, D = a.H * DH;
  const int nkt = text_fwd_key_tiles(S, q0, a.causal);
  // warpgroups with a live query row (the last tile may leave some idle)
  const int live = min(TXF_WG, (S - q0 + 63) / 64);
  if (tid == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < TXF_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, live);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int row0 = b * S;  // the sequence's first row in the maps
  if (wg == TXF_WG) {
    // ---- producer: Q once, then K and V tiles through the ring -------------
    if (tid == TXF_WG * 128) {
      mbar_expect_tx(qbar, Head::ATOMS * TXF_ATOM_Q);
      for (int c = 0; c < Head::ATOMS; ++c)
        tma_load_3d(sq + c * TXF_ATOM_Q, &tm_q, qbar, 64 * c, h, row0 + q0);
      for (int j = 0; j < nkt; ++j) {
        const int s = j % TXF_STAGES;
        if (j >= TXF_STAGES) mbar_wait(empty + 8 * s, ((j / TXF_STAGES) & 1) ^ 1);
        const uint32_t dst = ring + s * 2 * Head::TILE;
        mbar_expect_tx(full + 8 * s, 2 * Head::TILE);
        for (int c = 0; c < Head::ATOMS; ++c) {
          tma_load_3d(dst + c * TXF_ATOM_T, &tm_kv, full + 8 * s, 64 * c, a.H + h,
                      row0 + j * TXF_BK);
          tma_load_3d(dst + Head::TILE + c * TXF_ATOM_T, &tm_kv, full + 8 * s, 64 * c,
                      2 * a.H + h, row0 + j * TXF_BK);
        }
      }
    }
    return;
  }
  if (wg >= live) return;

  // ---- consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63 ------------
  const int wt = tid & 127, warp = wt >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int qrow[2] = {q0 + 64 * wg + 16 * warp + g, q0 + 64 * wg + 16 * warp + g + 8};
  const float scale_log2 = a.scale * TX_LOG2E;
  float o[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // m: log2 domain
  const uint32_t q_rows = sq + wg * 64 * 128;
  mbar_wait(qbar, 0);

  // Pipelined within the warpgroup: tile j's logits and tile j - 1's P V are
  // in flight together, and tile j's softmax runs while P V does. While a
  // wgmma is in flight no register it reads is written (the softmax works
  // in place on the fresh logits; its P is packed into the fragments after
  // the wait), and each write of such a register is fenced where it happens,
  // so that the compiler moves none into a pipeline stage: ptxas would then
  // serialize every wgmma of the kernel.
  constexpr int NB = TXF_BK;
  float corr[2];
  uint32_t pa[NB / 16][4];
  fence_regs(o);
  mbar_wait(full, 0);
  {
    float sc[NB / 2];
    wgmma_fence();
    txf_issue_logits<DH>(sc, q_rows, ring);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    txf_softmax<NB>(sc, m, l, corr, 0, S, a.causal, qrow, q0 + 64 * wg, t4, scale_log2);
    txf_pack<NB>(sc, pa);
    fence_frags(pa);
  }
  for (int j = 1; j < nkt; ++j) {
    const int s = j % TXF_STAGES, sp = (j - 1) % TXF_STAGES;
    mbar_wait(full + 8 * s, (j / TXF_STAGES) & 1);
    float sc[NB / 2];
    wgmma_fence();
    txf_issue_logits<DH>(sc, q_rows, ring + s * 2 * Head::TILE);
    wgmma_commit();
    txf_issue_pv<DH>(o, pa, ring + sp * 2 * Head::TILE + Head::TILE);
    wgmma_commit();
    wgmma_wait<1>();  // the logits
    fence_regs(sc);
    txf_softmax<NB>(sc, m, l, corr, j * NB, S, a.causal, qrow, q0 + 64 * wg, t4, scale_log2);
    wgmma_wait<0>();  // P V of tile j - 1: its stage is free, its P dead
    fence_regs(o);
    fence_frags(pa);
    if (wt == 0) mbar_arrive(empty + 8 * sp);
#pragma unroll
    for (int i = 0; i < Head::CHUNKS; ++i) {  // the output so far to tile j's max
      o[4 * i] *= corr[0];
      o[4 * i + 1] *= corr[0];
      o[4 * i + 2] *= corr[1];
      o[4 * i + 3] *= corr[1];
    }
    txf_pack<NB>(sc, pa);
    fence_regs(o);
    fence_frags(pa);
  }
  {
    const int sl = (nkt - 1) % TXF_STAGES;
    wgmma_fence();
    txf_issue_pv<DH>(o, pa, ring + sl * 2 * Head::TILE + Head::TILE);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    fence_frags(pa);
    if (wt == 0) mbar_arrive(empty + 8 * sl);
  }

  bf16* out = a.out + ((i64)b * S) * D + h * DH;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (qrow[r] >= S) continue;
    if (a.lse && t4 == 0)  // natural-log lse of the scaled logits
      a.lse[((i64)b * a.H + h) * S + qrow[r]] = (m[r] + __log2f(l[r])) * TX_LN2;
    const float inv = 1.f / l[r];
    bf16* dst = out + (i64)qrow[r] * D;
#pragma unroll
    for (int i = 0; i < Head::CHUNKS; ++i)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * i + 2 * t4) =
          __floats2bfloat162_rn(o[4 * i + 2 * r] * inv, o[4 * i + 2 * r + 1] * inv);
  }
}

// ---------------------------------------------------------------------------
// S <= TX_SMALL_MAX: one block per (head, sequence), mma.sync
// ---------------------------------------------------------------------------
constexpr int TX_LD = 64 + 8;  // staged row: 64 bf16 and 16 bytes of padding

// 16-row slabs of a sequence of S rows
__host__ __device__ inline int text_small_slabs(int S) { return (S + 15) / 16; }

// rows [0, 16 * slabs) of the q, k, v (and dO) columns of head h of sequence b,
// by 16-byte cp.async; rows >= S are zeros. `dst` holds one [16 * slabs][TX_LD]
// array a column block; `cols` the column offsets in the source rows.
__device__ __forceinline__ void text_small_stage(bf16* dst, int narr, const bf16* const* src,
                                                 const i64* ld, int S, int slabs) {
  const int rows = 16 * slabs, per = rows * 8;
  for (int e = threadIdx.x; e < narr * per; e += blockDim.x) {
    const int arr = e / per, r = (e % per) >> 3, c = (e & 7) * 8;
    bf16* d = dst + ((i64)arr * rows + r) * TX_LD + c;
    if (r < S)
      cp_async16(d, src[arr] + (i64)r * ld[arr] + c);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(256)
    text_attn_fwd_small_kernel(const bf16* __restrict__ qkv, const TextFwdArgs a) {
  extern __shared__ __align__(16) uint8_t txs_smem[];
  const int S = a.S, D = a.H * 64, h = blockIdx.x, b = blockIdx.y;
  const int slabs = text_small_slabs(S), rows = 16 * slabs;
  bf16* sm = reinterpret_cast<bf16*>(txs_smem);
  {
    const bf16* base = qkv + (i64)b * S * 3 * D + h * 64;
    const bf16* src[3] = {base, base + D, base + 2 * D};
    const i64 ld[3] = {3 * D, 3 * D, 3 * D};
    text_small_stage(sm, 3, src, ld, S, slabs);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  bf16 (*sQ)[TX_LD] = reinterpret_cast<bf16 (*)[TX_LD]>(sm);
  bf16 (*sK)[TX_LD] = sQ + rows;
  bf16 (*sV)[TX_LD] = sK + rows;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3, jj = lane >> 3;
  const int r0 = 16 * warp;
  const int qrow[2] = {r0 + g, r0 + g + 8};
  const int nchunks = a.causal ? warp + 1 : slabs;  // 16-key chunks this slab attends
  const float scale_log2 = a.scale * TX_LOG2E;

  uint32_t qf[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    ldmatrix_x4(qf[kk], &sQ[r0 + (lane & 15)][kk * 16 + (lane >> 4) * 8]);
  // the logits of every chunk at once: [chunk][8-key half][fragment]
  float sc[TX_SMALL_MAX / 16][2][4];
#pragma unroll
  for (int c = 0; c < TX_SMALL_MAX / 16; ++c) {
    if (c >= nchunks) break;
#pragma unroll
    for (int n = 0; n < 2; ++n) sc[c][n][0] = sc[c][n][1] = sc[c][n][2] = sc[c][n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t kf[4];
      ldmatrix_x4(kf, &sK[16 * c + (lane & 7) + (jj >> 1) * 8][kk * 16 + (jj & 1) * 8]);
      mma_bf16_16816(sc[c][0], qf[kk], kf[0], kf[1]);
      mma_bf16_16816(sc[c][1], qf[kk], kf[2], kf[3]);
    }
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, key = 16 * c + 8 * n + 2 * t4 + (e & 1);
        const bool masked = key >= S || (a.causal && key > qrow[r]);
        sc[c][n][e] = masked ? -INFINITY : sc[c][n][e] * scale_log2;
      }
  }
  float mx[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, o[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
#pragma unroll
  for (int g0 = 0; g0 < TX_SMALL_MAX / 16; g0 += 4) {  // online over 64-key groups
    if (g0 >= nchunks) break;
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int c = g0; c < g0 + 4; ++c) {
      if (c >= nchunks) break;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) tmax[e >> 1] = fmaxf(tmax[e >> 1], sc[c][n][e]);
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
      const float m_new = fmaxf(mx[r], tmax[r]);
      corr[r] = exp2f(mx[r] - m_new);
      mx[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      o[i][0] *= corr[0];
      o[i][1] *= corr[0];
      o[i][2] *= corr[1];
      o[i][3] *= corr[1];
    }
#pragma unroll
    for (int c = g0; c < g0 + 4; ++c) {
      if (c >= nchunks) break;
      float p[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[n][e] = exp2f(sc[c][n][e] - mx[e >> 1]);
          l[e >> 1] += p[n][e];
        }
      const uint32_t pa[4] = {pack_bf16x2(p[0][0], p[0][1]), pack_bf16x2(p[0][2], p[0][3]),
                              pack_bf16x2(p[1][0], p[1][1]), pack_bf16x2(p[1][2], p[1][3])};
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, &sV[16 * c + (lane & 7) + ((lane >> 3) & 1) * 8]
                                 [dp * 16 + ((lane >> 4) & 1) * 8]);
        mma_bf16_16816(o[2 * dp], pa, vf[0], vf[1]);
        mma_bf16_16816(o[2 * dp + 1], pa, vf[2], vf[3]);
      }
    }
  }
  bf16* out = a.out + (i64)b * S * D + h * 64;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (qrow[r] >= S) continue;
    if (a.lse && t4 == 0)
      a.lse[((i64)b * a.H + h) * S + qrow[r]] = (mx[r] + __log2f(l[r])) * TX_LN2;
    const float inv = 1.f / l[r];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(out + (i64)qrow[r] * D + 8 * i + 2 * t4) =
          __floats2bfloat162_rn(o[i][2 * r] * inv, o[i][2 * r + 1] * inv);
  }
}

// shared memory of the one-block kernels: `arrays` staged [16 * slabs][TX_LD]
// bf16 arrays, then `floats` f32 arrays of 16 * slabs
inline size_t text_small_smem(int S, int arrays, int floats) {
  const int rows = 16 * text_small_slabs(S);
  return (size_t)arrays * rows * TX_LD * 2 + (size_t)floats * rows * 4;
}

template <int DH>
inline cudaError_t launch_text_fwd_tma(const bf16* qkv, const TextFwdArgs& a, int B,
                                       cudaStream_t stream) {
  CUtensorMap tm_q, tm_kv;
  const i64 rows = (i64)B * a.S;
  if (!head_map(&tm_q, qkv, rows, 3 * a.H, DH, TXF_BQ) ||
      !head_map(&tm_kv, qkv, rows, 3 * a.H, DH, TXF_BK))
    return cudaErrorInvalidValue;
  constexpr int smem = TxfHead<DH>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(text_attn_fwd_kernel<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  text_attn_fwd_kernel<DH><<<dim3((a.S + TXF_BQ - 1) / TXF_BQ, a.H, B), TXF_THREADS, smem,
                             stream>>>(tm_q, tm_kv, a);
  return cudaGetLastError();
}

// out [B, S, H * dh] (and lse [B, H, S] when non-null) from qkv [B, S, 3 * H *
// dh]. small: the one-block kernel (S <= TX_SMALL_MAX, dh = 64), else the TMA +
// wgmma kernel (dh 64 or 88); ops/text_attention.py::text_core_plan chooses and
// checks alignment.
inline cudaError_t launch_text_fwd(const bf16* qkv, const TextFwdArgs& a, int B, int dh,
                                   int small, cudaStream_t stream) {
  const int S = a.S;
  if (small) {
    if (S > TX_SMALL_MAX || dh != 64) return cudaErrorInvalidValue;
    const size_t smem = text_small_smem(S, 3, 0);
    cudaError_t err = cudaFuncSetAttribute(
        text_attn_fwd_small_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    text_attn_fwd_small_kernel<<<dim3(a.H, B), 32 * text_small_slabs(S), smem, stream>>>(qkv,
                                                                                        a);
    return cudaGetLastError();
  }
  if (dh == 64) return launch_text_fwd_tma<64>(qkv, a, B, stream);
  if (dh == 88) return launch_text_fwd_tma<88>(qkv, a, B, stream);
  return cudaErrorInvalidValue;
}

}  // namespace tvts
