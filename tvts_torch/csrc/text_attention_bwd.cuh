// Attention core of the H7 text sub-path, backward: dqkv [B, S, 3D] bf16 from
// the forward's saves (the qkv rows, q not pre-scaled; the attention output O
// [B, S, D]; the natural-log lse [B, H, S]) and dO = dL/dO [B, S, D]. Head dim
// 64 only (ops/text_attention.py::text_core_plan refuses anything else).
//
// Replaces the core of tvts_tpu/ops/pallas_text_attention.py::
// fused_text_attention_block_bwd (:264, kernel :134-262; whole [S, S]
// probabilities per head in VMEM). The delta identity of flash attention:
// with P = exp(scale q.k - lse) recomputed from the saved lse, dP = dO v^T and
// delta = rowsum(dO * O), dS = P * (dP - delta), dq = scale * dS k, dk = scale
// * dS^T q, dv = P^T dO. P and dS are rounded to bf16 for the products, the
// sums are f32. Each output element is written once by one block in a fixed
// order: no atomics, two runs give the same bits. Causal masks a key past its
// query; keys and queries >= S (the next sequence's rows in a box, or zeros
// past B * S) take no part, and no row >= S is written.
//
// Bound on the H100: at the sort head's S = 1181 (B = 20, H = 8) the tensor
// cores, 10 * d * S^2 flops a (sequence, head) for the logits, dP, dq, dk and
// dv (0.144 ms); the two kernels below recompute the logits and dP in both
// passes, 14 * d * S^2 (0.20 ms at the peak), with 2 * S^2 exp2. At S = 77 the
// bytes (qkv, O and dO read once, dqkv written once). Kernels:
// - S > TX_SMALL_MAX: text_bwd_dq_kernel, a block per 128 queries (two
//   warpgroups of 64) that walks 64-key tiles: its Q, dO and O rows come by
//   TMA once; it computes its rows' delta and lse * log2(e) and writes them
//   into arrays padded to a multiple of 64 rows (+inf and 0 past S, so that
//   a padded query's P is 0 without a mask); K and V come through a TMA ring;
//   S = Q K^T and dP = dO V^T on wgmma m64n64k16 with Q and dO from registers,
//   dQ += dS K on wgmma with dS from registers and K as the MN-major B. Then
//   text_bwd_dkv_kernel, a block per 128 keys that walks 64-query tiles: Q,
//   dO and the tile's padded lse and delta through the ring; S^T = K Q^T and
//   dP^T = V dO^T with K and V from registers; dV += P^T dO and dK += dS^T Q
//   with P^T and dS^T from registers and dO, Q as the MN-major B. Both are
//   pipelined within each warpgroup (the next tile's products in flight
//   while this tile's probabilities are made) and have no producer warp: a
//   ninth warp would cap the registers at 168, too few for the operands in
//   flight, so thread 0 issues the loads.
// - S <= TX_SMALL_MAX (the text tower's 77): text_bwd_small_kernel, a block
//   per (head, sequence), stages q, k, v and dO of the sequence's head once
//   (16-byte cp.async), computes delta from dO and O itself, and a warp per
//   16-row slab computes that slab's dq (walking the 16-key chunks up to its
//   own when causal) and its dk, dv (the 16-query chunks from its own on), on
//   mma.sync m16n8k16: the flash pair's arithmetic in one launch.
#pragma once

#include "text_attention.cuh"

namespace tvts {

struct TextBwdArgs {
  const bf16* qkv;     // [B, S, 3D]
  const bf16* O;       // [B, S, D]
  const bf16* dO;      // [B, S, D]
  const float* lse;    // [B, H, S]
  float* lse2p;        // [B, H, Sp] scratch: lse * log2(e), +inf past S
  float* deltap;       // [B, H, Sp] scratch: delta, 0 past S
  bf16* dqkv;          // [B, S, 3D]
  int S, Sp, H;
  float scale;
  int causal;
};

// ---------------------------------------------------------------------------
// S > TX_SMALL_MAX: the dq pass (with the padded lse and delta), then dk/dv
// ---------------------------------------------------------------------------
constexpr int TXB_ROWS = 128;  // keys (dkv) or queries (dq) a block: two warpgroups
constexpr int TXB_STEP = 64;   // queries (dkv) or keys (dq) a ring tile
constexpr int TXB_STAGES = 8;  // the loop waits on its loads' latency: 8 beat 4 (PERF.md)
constexpr int TXB_THREADS = 256;  // two warpgroups; thread 0 also loads
constexpr int TXB_BLOCK = TXB_ROWS * 128;  // a [128 x 64] bf16 tile
constexpr int TXB_TILE = TXB_STEP * 128;   // a [64 x 64] bf16 tile
// dk/dv: K and V, the ring of Q and dO with the lse and delta of each stage,
// the barriers; dq: Q, dO and O, the ring of K and V, the warpgroups' lse and
// delta, the barriers
constexpr int TXB_DKV_SMEM = 1024 + 2 * TXB_BLOCK +
                             TXB_STAGES * (2 * TXB_TILE + 2 * TXB_STEP * 4) +
                             (1 + 2 * TXB_STAGES) * 8;
constexpr int TXB_DQ_SMEM = 1024 + 3 * TXB_BLOCK + TXB_STAGES * 2 * TXB_TILE + 2 * 2 * 64 * 4 +
                            (1 + 2 * TXB_STAGES) * 8;

// padded rows of the lse and delta scratch
inline int text_bwd_rows(int S) { return (S + TXB_STEP - 1) / TXB_STEP * TXB_STEP; }

// the first query tile a dkv block walks (causal: its own keys' tile) and the
// key tiles a dq block walks (causal: up to its last query)
__device__ __forceinline__ int text_dkv_first_query(int k0, int causal) { return causal ? k0 : 0; }
__device__ __forceinline__ int text_dq_key_tiles(int S, int q0, int causal) {
  const int k_end = causal ? min(S, q0 + TXB_ROWS) : S;
  return (k_end + TXB_STEP - 1) / TXB_STEP;
}

// pack the accumulator entries of 8-column chunk i (rows g: v0, v1; g + 8:
// v2, v3) into half of wgmma's 16-column A fragment i / 2
__device__ __forceinline__ void pack_chunk(uint32_t (&frag)[4][4], int i, float v0, float v1,
                                           float v2, float v3) {
  frag[i >> 1][2 * (i & 1)] = pack_bf16x2(v0, v1);
  frag[i >> 1][2 * (i & 1) + 1] = pack_bf16x2(v2, v3);
}

// issues D = A B^T over d = 64 for a warpgroup's 64 rows (A from registers)
// against the 64 K-major rows of B (the caller fences, commits and waits)
__device__ __forceinline__ void txb_issue_abt(float (&d)[32], const uint32_t (&a)[4][4],
                                              uint64_t db) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs_n64(d, a[kk], db + 2 * kk, kk);
}

// issues D += A B over 64 rows of B: A from registers, B the MN-major [64 x
// 64] tile at `tile`
__device__ __forceinline__ void txb_issue_rs(float (&d)[32], const uint32_t (&a)[4][4],
                                             uint32_t tile) {
  const uint64_t db = sw128_mn_desc(tile, TXB_TILE);
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) wgmma_rs_n64<1>(d, a[kc], db + kc * (2048 >> 4), 1);
}

__global__ void __launch_bounds__(TXB_THREADS, 1)
    text_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_kv,
                        const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_do, const TextBwdArgs a) {
  extern __shared__ uint8_t txb_smem[];
  const uint32_t raw = smem_addr(txb_smem);
  const uint32_t sk = (raw + 1023) & ~1023u, sv = sk + TXB_BLOCK;
  const uint32_t ring = sv + TXB_BLOCK;                      // [stage] Q, dO
  const uint32_t lsd = ring + TXB_STAGES * 2 * TXB_TILE;     // [stage] lse2, delta
  const uint32_t kvbar = lsd + TXB_STAGES * 2 * TXB_STEP * 4;
  const uint32_t full = kvbar + 8, empty = full + 8 * TXB_STAGES;
  const float* lsd_ptr = reinterpret_cast<const float*>(txb_smem + (lsd - raw));

  const int tid = threadIdx.x, wg = tid >> 7;
  const int k0 = blockIdx.x * TXB_ROWS, h = blockIdx.y, b = blockIdx.z;
  const int S = a.S, D = a.H * 64;
  const int qb = text_dkv_first_query(k0, a.causal);
  const int nqt = (S - qb + TXB_STEP - 1) / TXB_STEP;
  const int live = min(2, (S - k0 + 63) / 64);  // warpgroups with a live key
  if (tid == 0) {
    mbar_init(kvbar, 1);
    for (int s = 0; s < TXB_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, live);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // No producer warp (a ninth warp would cap the registers at 168, too few
  // for this loop's in-flight operands): thread 0 loads K and V and the
  // first stages, and at tile j refills the stage of tile j - 2 (both
  // warpgroups have released it by then unless the other is two tiles
  // behind): refilling the stage just released would hold warpgroup 0 at
  // every tile until warpgroup 1 caught up, and the two would no longer
  // overlap one's products with the other's probabilities.
  const int row0 = b * S;
  const i64 lrow = ((i64)b * a.H + h) * a.Sp;
  auto load_tile = [&](int j) {
    const int s = j % TXB_STAGES, q0 = qb + j * TXB_STEP;
    const uint32_t dst = ring + s * 2 * TXB_TILE, l = lsd + s * 2 * TXB_STEP * 4;
    mbar_expect_tx(full + 8 * s, 2 * TXB_TILE + 2 * TXB_STEP * 4);
    tma_load_2d(dst, &tm_q, full + 8 * s, h * 64, row0 + q0);
    tma_load_2d(dst + TXB_TILE, &tm_do, full + 8 * s, h * 64, row0 + q0);
    bulk_load(l, a.lse2p + lrow + q0, TXB_STEP * 4, full + 8 * s);
    bulk_load(l + TXB_STEP * 4, a.deltap + lrow + q0, TXB_STEP * 4, full + 8 * s);
  };
  if (tid == 0) {
    mbar_expect_tx(kvbar, 2 * TXB_BLOCK);
    tma_load_2d(sk, &tm_kv, kvbar, D + h * 64, row0 + k0);
    tma_load_2d(sv, &tm_kv, kvbar, 2 * D + h * 64, row0 + k0);
    for (int j = 0; j < min(TXB_STAGES, nqt); ++j) load_tile(j);
  }
  if (wg >= live) return;

  // ---- consumers: warpgroup wg owns keys k0 + 64 wg .. + 63 -----------------
  const int wt = tid & 127, warp = wt >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int kfirst = k0 + 64 * wg;
  const int krow[2] = {kfirst + 16 * warp + g, kfirst + 16 * warp + g + 8};
  const float scale_log2 = a.scale * TX_LOG2E;
  float dk[32], dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
  uint32_t kf[4][4], vf[4][4];  // this warpgroup's K and V rows, the A operands
  mbar_wait(kvbar, 0);
  load_a_frags(kf, sk + wg * 64 * 128, warp, lane);
  load_a_frags(vf, sv + wg * 64 * 128, warp, lane);
  fence_frags(kf);
  fence_frags(vf);

  // Pipelined within the warpgroup: tile j's S^T and dP^T and tile j - 1's
  // dV and dK products are in flight together, and tile j's P^T and dS^T are
  // made (in place, in the fresh S^T and dP^T registers) while the latter
  // run; they are packed into the A fragments after the wait (the forward's
  // note on what may be written while a wgmma is in flight).
  uint32_t pp[4][4], pd[4][4];
  auto issue_sdp = [&](float (&st)[32], float (&dpt)[32], int s) {
    const uint32_t qt = ring + s * 2 * TXB_TILE;
    txb_issue_abt(st, kf, sw128_desc(qt));
    txb_issue_abt(dpt, vf, sw128_desc(qt + TXB_TILE));
  };
  // P^T into st, dS^T into dpt
  auto probs = [&](float (&st)[32], float (&dpt)[32], int j) {
    const int s = j % TXB_STAGES, q0 = qb + j * TXB_STEP;
    const float* l2 = lsd_ptr + s * 2 * TXB_STEP;
    const bool edge = a.causal && q0 < kfirst + 63;  // some key past some query
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float2 lq = *reinterpret_cast<const float2*>(l2 + 8 * i + 2 * t4);
      const float2 dq = *reinterpret_cast<const float2*>(l2 + TXB_STEP + 8 * i + 2 * t4);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = 8 * i + 2 * t4 + (c & 1);
        float pv = exp2f(fmaf(st[4 * i + c], scale_log2, -((c & 1) ? lq.y : lq.x)));
        if (edge && krow[c >> 1] > q0 + col) pv = 0.f;
        st[4 * i + c] = pv;
        dpt[4 * i + c] = pv * (dpt[4 * i + c] - ((c & 1) ? dq.y : dq.x));
      }
    }
  };
  auto pack = [&](const float (&st)[32], const float (&dpt)[32]) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      pack_chunk(pp, i, st[4 * i], st[4 * i + 1], st[4 * i + 2], st[4 * i + 3]);
      pack_chunk(pd, i, dpt[4 * i], dpt[4 * i + 1], dpt[4 * i + 2], dpt[4 * i + 3]);
    }
    fence_frags(pp);
    fence_frags(pd);
  };
  auto issue_grads = [&](int s) {  // dV += P^T dO, dK += dS^T Q (both MN-major)
    const uint32_t qt = ring + s * 2 * TXB_TILE;
    txb_issue_rs(dv, pp, qt + TXB_TILE);
    txb_issue_rs(dk, pd, qt);
  };
  fence_regs(dk);
  fence_regs(dv);
  mbar_wait(full, 0);
  {
    float st[32], dpt[32];
    wgmma_fence();
    issue_sdp(st, dpt, 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);
    probs(st, dpt, 0);
    pack(st, dpt);
  }
  for (int j = 1; j < nqt; ++j) {
    const int s = j % TXB_STAGES, sp = (j - 1) % TXB_STAGES;
    mbar_wait(full + 8 * s, (j / TXB_STAGES) & 1);
    float st[32], dpt[32];
    wgmma_fence();
    issue_sdp(st, dpt, s);
    wgmma_commit();
    issue_grads(sp);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(st);
    fence_regs(dpt);
    probs(st, dpt, j);
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    fence_frags(pp);
    fence_frags(pd);
    if (wt == 0) mbar_arrive(empty + 8 * sp);
    if (tid == 0 && j >= 2 && j - 2 + TXB_STAGES < nqt) {  // see the refill note above
      const int t = j - 2;
      mbar_wait(empty + 8 * (t % TXB_STAGES), (t / TXB_STAGES) & 1);
      load_tile(t + TXB_STAGES);
    }
    pack(st, dpt);
  }
  wgmma_fence();
  issue_grads((nqt - 1) % TXB_STAGES);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(dv);
  fence_regs(dk);
  fence_frags(pp);
  fence_frags(pd);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (krow[r] >= S) continue;
    bf16* dst = a.dqkv + ((i64)b * S + krow[r]) * 3 * D + h * 64;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      *reinterpret_cast<__nv_bfloat162*>(dst + D + 8 * i + 2 * t4) =
          __floats2bfloat162_rn(dk[4 * i + 2 * r] * a.scale, dk[4 * i + 2 * r + 1] * a.scale);
      *reinterpret_cast<__nv_bfloat162*>(dst + 2 * D + 8 * i + 2 * t4) =
          __floats2bfloat162_rn(dv[4 * i + 2 * r], dv[4 * i + 2 * r + 1]);
    }
  }
}

__global__ void __launch_bounds__(TXB_THREADS, 1)
    text_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_do,
                       const __grid_constant__ CUtensorMap tm_o,
                       const __grid_constant__ CUtensorMap tm_kv, const TextBwdArgs a) {
  extern __shared__ uint8_t txb_smem[];
  const uint32_t raw = smem_addr(txb_smem);
  const uint32_t sq = (raw + 1023) & ~1023u, so = sq + TXB_BLOCK, sout = so + TXB_BLOCK;
  const uint32_t ring = sout + TXB_BLOCK;  // [stage] K, V
  const uint32_t rows = ring + TXB_STAGES * 2 * TXB_TILE;  // [warpgroup] lse2, delta
  const uint32_t qbar = rows + 2 * 2 * 64 * 4;
  const uint32_t full = qbar + 8, empty = full + 8 * TXB_STAGES;
  float* rows_ptr = reinterpret_cast<float*>(txb_smem + (rows - raw));

  const int tid = threadIdx.x, wg = tid >> 7;
  const int q0 = blockIdx.x * TXB_ROWS, h = blockIdx.y, b = blockIdx.z;
  const int S = a.S, D = a.H * 64;
  const int nkt = text_dq_key_tiles(S, q0, a.causal);
  const int live = min(2, (S - q0 + 63) / 64);
  if (tid == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < TXB_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, live);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // no producer warp, as the dk/dv kernel: thread 0 loads Q, dO and O of the
  // block's rows and the first stages, and refills as the dk/dv kernel does
  const int row0 = b * S;
  auto load_tile = [&](int j) {
    const int s = j % TXB_STAGES;
    const uint32_t dst = ring + s * 2 * TXB_TILE;
    mbar_expect_tx(full + 8 * s, 2 * TXB_TILE);
    tma_load_2d(dst, &tm_kv, full + 8 * s, D + h * 64, row0 + j * TXB_STEP);
    tma_load_2d(dst + TXB_TILE, &tm_kv, full + 8 * s, 2 * D + h * 64, row0 + j * TXB_STEP);
  };
  if (tid == 0) {
    mbar_expect_tx(qbar, 3 * TXB_BLOCK);
    tma_load_2d(sq, &tm_q, qbar, h * 64, row0 + q0);
    tma_load_2d(so, &tm_do, qbar, h * 64, row0 + q0);
    tma_load_2d(sout, &tm_o, qbar, h * 64, row0 + q0);
    for (int j = 0; j < min(TXB_STAGES, nkt); ++j) load_tile(j);
  }
  if (wg >= live) return;

  // ---- warpgroup wg owns queries q0 + 64 wg .. + 63 --------------------------
  const int wt = tid & 127, warp = wt >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int qfirst = q0 + 64 * wg;
  const int qrow[2] = {qfirst + 16 * warp + g, qfirst + 16 * warp + g + 8};
  const i64 lrow = ((i64)b * a.H + h) * a.Sp;
  const float scale_log2 = a.scale * TX_LOG2E;
  float dq[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq[i] = 0.f;
  uint32_t qf[4][4], of[4][4];  // this warpgroup's Q and dO rows, the A operands
  mbar_wait(qbar, 0);
  load_a_frags(qf, sq + wg * 64 * 128, warp, lane);
  load_a_frags(of, so + wg * 64 * 128, warp, lane);
  fence_frags(qf);
  fence_frags(of);
  // The rows' delta = rowsum(dO * O) (two threads a row, 32 columns each)
  // and lse in the log2 domain: into shared memory for this warpgroup, and
  // into the padded arrays (+inf and 0 past S, so that a padded query's P is
  // 0 without a mask) that the dk/dv kernel, launched after this one, reads.
  float* s_lse2 = rows_ptr + wg * 2 * 64;
  float* s_delta = s_lse2 + 64;
  {
    const int r = wt >> 1, half = wt & 1, qr = qfirst + r;
    const uint8_t* base = txb_smem + (sq - raw) + (64 * wg + r) * 128;
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int chunk = ((4 * half + i) ^ (r & 7)) * 16;
      float fd[8], fo[8];
      unpack_bf16x8(*reinterpret_cast<const uint4*>(base + TXB_BLOCK + chunk), fd);
      unpack_bf16x8(*reinterpret_cast<const uint4*>(base + 2 * TXB_BLOCK + chunk), fo);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc = fmaf(fd[e], fo[e], acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (!half) {  // live rows are < Sp
      const float l2 = qr < S ? a.lse[((i64)b * a.H + h) * S + qr] * TX_LOG2E : INFINITY;
      const float dl = qr < S ? acc : 0.f;
      s_lse2[r] = l2;
      s_delta[r] = dl;
      a.lse2p[lrow + qr] = l2;
      a.deltap[lrow + qr] = dl;
    }
    named_sync(1 + wg, 128);
  }
  const float lse2[2] = {s_lse2[16 * warp + g], s_lse2[16 * warp + g + 8]};
  const float dl[2] = {s_delta[16 * warp + g], s_delta[16 * warp + g + 8]};

  // Pipelined as the dk/dv kernel: tile j's S and dP and tile j - 1's dQ
  // product in flight together, tile j's dS made in place (in dp) while the
  // latter runs and packed after the wait.
  uint32_t pd[4][4];
  auto issue_sdp = [&](float (&sc)[32], float (&dp)[32], int s) {
    const uint32_t kt = ring + s * 2 * TXB_TILE;
    txb_issue_abt(sc, qf, sw128_desc(kt));
    txb_issue_abt(dp, of, sw128_desc(kt + TXB_TILE));
  };
  auto dscores = [&](const float (&sc)[32], float (&dp)[32], int j) {  // dS into dp
    const int k0 = j * TXB_STEP;
    const bool edge = k0 + TXB_STEP > S || (a.causal && k0 + TXB_STEP - 1 > qfirst);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = c >> 1, key = k0 + 8 * i + 2 * t4 + (c & 1);
        float p = exp2f(fmaf(sc[4 * i + c], scale_log2, -lse2[r]));
        if (edge && (key >= S || (a.causal && key > qrow[r]))) p = 0.f;
        dp[4 * i + c] = p * (dp[4 * i + c] - dl[r]);
      }
  };
  auto pack = [&](const float (&ds)[32]) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      pack_chunk(pd, i, ds[4 * i], ds[4 * i + 1], ds[4 * i + 2], ds[4 * i + 3]);
    fence_frags(pd);
  };
  fence_regs(dq);
  mbar_wait(full, 0);
  {
    float sc[32], dp[32];
    wgmma_fence();
    issue_sdp(sc, dp, 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    dscores(sc, dp, 0);
    pack(dp);
  }
  for (int j = 1; j < nkt; ++j) {
    const int s = j % TXB_STAGES, sp = (j - 1) % TXB_STAGES;
    mbar_wait(full + 8 * s, (j / TXB_STAGES) & 1);
    float sc[32], dp[32];
    wgmma_fence();
    issue_sdp(sc, dp, s);
    wgmma_commit();
    txb_issue_rs(dq, pd, ring + sp * 2 * TXB_TILE);  // dQ += dS K (K MN-major)
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(sc);
    fence_regs(dp);
    dscores(sc, dp, j);
    wgmma_wait<0>();
    fence_regs(dq);
    fence_frags(pd);
    if (wt == 0) mbar_arrive(empty + 8 * sp);
    if (tid == 0 && j >= 2 && j - 2 + TXB_STAGES < nkt) {  // see the refill note above
      const int t = j - 2;
      mbar_wait(empty + 8 * (t % TXB_STAGES), (t / TXB_STAGES) & 1);
      load_tile(t + TXB_STAGES);
    }
    pack(dp);
  }
  wgmma_fence();
  txb_issue_rs(dq, pd, ring + ((nkt - 1) % TXB_STAGES) * 2 * TXB_TILE);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(dq);
  fence_frags(pd);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qrow[r] >= S) continue;
    bf16* dst = a.dqkv + ((i64)b * S + qrow[r]) * 3 * D + h * 64;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * i + 2 * t4) =
          __floats2bfloat162_rn(dq[4 * i + 2 * r] * a.scale, dq[4 * i + 2 * r + 1] * a.scale);
  }
}

// ---------------------------------------------------------------------------
// S <= TX_SMALL_MAX: one block per (head, sequence), mma.sync
// ---------------------------------------------------------------------------
// acc[2][4] = A[16 x 64] B[16 x 64]^T for the 16 rows of `af` (ldmatrix A
// fragments) against rows [r0, r0 + 16) of a staged array
__device__ __forceinline__ void small_abt(float (&acc)[2][4], const uint32_t (&af)[4][4],
                                          bf16 (*sB)[TX_LD], int r0, int lane) {
  const int j = lane >> 3;
#pragma unroll
  for (int n = 0; n < 2; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t bf[4];
    ldmatrix_x4(bf, &sB[r0 + (lane & 7) + (j >> 1) * 8][kk * 16 + (j & 1) * 8]);
    mma_bf16_16816(acc[0], af[kk], bf[0], bf[1]);
    mma_bf16_16816(acc[1], af[kk], bf[2], bf[3]);
  }
}

// out[16 x 64] += A (accumulator layout, rounded to bf16) @ rows [r0, r0 + 16)
// of a staged array
__device__ __forceinline__ void small_av(float (&out)[8][4], const float (&a)[2][4],
                                         bf16 (*sB)[TX_LD], int r0, int lane) {
  const uint32_t pa[4] = {pack_bf16x2(a[0][0], a[0][1]), pack_bf16x2(a[0][2], a[0][3]),
                          pack_bf16x2(a[1][0], a[1][1]), pack_bf16x2(a[1][2], a[1][3])};
#pragma unroll
  for (int dp = 0; dp < 4; ++dp) {
    uint32_t bf[4];
    ldmatrix_x4_trans(bf, &sB[r0 + (lane & 7) + ((lane >> 3) & 1) * 8]
                             [dp * 16 + ((lane >> 4) & 1) * 8]);
    mma_bf16_16816(out[2 * dp], pa, bf[0], bf[1]);
    mma_bf16_16816(out[2 * dp + 1], pa, bf[2], bf[3]);
  }
}

__device__ __forceinline__ void small_frags(uint32_t (&f)[4][4], bf16 (*sA)[TX_LD], int r0,
                                            int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    ldmatrix_x4(f[kk], &sA[r0 + (lane & 15)][kk * 16 + (lane >> 4) * 8]);
}

__global__ void __launch_bounds__(256) text_bwd_small_kernel(const TextBwdArgs a) {
  extern __shared__ __align__(16) uint8_t txs_smem[];
  const int S = a.S, D = a.H * 64, h = blockIdx.x, b = blockIdx.y;
  const int slabs = text_small_slabs(S), rows = 16 * slabs;
  bf16* sm = reinterpret_cast<bf16*>(txs_smem);
  {
    const bf16* base = a.qkv + (i64)b * S * 3 * D + h * 64;
    const bf16* src[4] = {base, base + D, base + 2 * D, a.dO + (i64)b * S * D + h * 64};
    const i64 ld[4] = {3 * D, 3 * D, 3 * D, D};
    text_small_stage(sm, 4, src, ld, S, slabs);
  }
  bf16 (*sQ)[TX_LD] = reinterpret_cast<bf16 (*)[TX_LD]>(sm);
  bf16 (*sK)[TX_LD] = sQ + rows;
  bf16 (*sV)[TX_LD] = sK + rows;
  bf16 (*sdO)[TX_LD] = sV + rows;
  float* s_lse2 = reinterpret_cast<float*>(sdO + rows);
  float* s_delta = s_lse2 + rows;
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  // delta = rowsum(dO * O) in attn_delta_kernel's order; lse in the log2 domain
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    if (r >= S) {
      s_lse2[r] = INFINITY;
      s_delta[r] = 0.f;
      continue;
    }
    const bf16* o = a.O + ((i64)b * S + r) * D + h * 64;
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < 64; i += 8) {
      float fd[8], fo[8];
      unpack_bf16x8(*reinterpret_cast<const uint4*>(&sdO[r][i]), fd);
      unpack_bf16x8(*reinterpret_cast<const uint4*>(o + i), fo);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc += fd[2 * e] * fo[2 * e] + fd[2 * e + 1] * fo[2 * e + 1];
    }
    s_lse2[r] = a.lse[((i64)b * a.H + h) * S + r] * TX_LOG2E;
    s_delta[r] = acc;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3, r0 = 16 * warp;
  const int row[2] = {r0 + g, r0 + g + 8};
  const float scale_log2 = a.scale * TX_LOG2E;
  bf16* dst0 = a.dqkv + (i64)b * S * 3 * D + h * 64;

  {  // dq of slab `warp`: the key chunks up to its own when causal
    uint32_t qf[4][4], of[4][4];
    small_frags(qf, sQ, r0, lane);
    small_frags(of, sdO, r0, lane);
    const float lse2[2] = {s_lse2[row[0]], s_lse2[row[1]]};
    const float dl[2] = {s_delta[row[0]], s_delta[row[1]]};
    float dq[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;
    const int kc_end = a.causal ? warp + 1 : slabs;
    for (int kc = 0; kc < kc_end; ++kc) {
      float s[2][4], dp[2][4];
      small_abt(s, qf, sK, 16 * kc, lane);
      small_abt(dp, of, sV, 16 * kc, lane);
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int key = 16 * kc + 8 * n + 2 * t4 + (c & 1), r = c >> 1;
          const bool masked = key >= S || (a.causal && key > row[r]);
          const float p = masked ? 0.f : exp2f(s[n][c] * scale_log2 - lse2[r]);
          s[n][c] = p * (dp[n][c] - dl[r]);  // dS
        }
      small_av(dq, s, sK, 16 * kc, lane);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (row[r] >= S) continue;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        *reinterpret_cast<__nv_bfloat162*>(dst0 + (i64)row[r] * 3 * D + 8 * i + 2 * t4) =
            __floats2bfloat162_rn(dq[i][2 * r] * a.scale, dq[i][2 * r + 1] * a.scale);
    }
  }
  {  // dk, dv of key slab `warp`: the query chunks from its own on when causal
    uint32_t kf[4][4], vf[4][4];
    small_frags(kf, sK, r0, lane);
    small_frags(vf, sV, r0, lane);
    float dk[8][4], dv[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) dk[i][c] = dv[i][c] = 0.f;
    for (int qc = a.causal ? warp : 0; qc < slabs; ++qc) {
      // transposed tiles: rows are this slab's keys, columns 16 queries
      float p[2][4], ds[2][4];
      small_abt(p, kf, sQ, 16 * qc, lane);
      small_abt(ds, vf, sdO, 16 * qc, lane);
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int query = 16 * qc + 8 * n + 2 * t4 + (c & 1), key = row[c >> 1];
          // queries >= S: s_lse2 is +inf there, so P is 0
          const bool masked = a.causal && key > query;
          const float pv = masked ? 0.f : exp2f(p[n][c] * scale_log2 - s_lse2[query]);
          p[n][c] = pv;
          ds[n][c] = pv * (ds[n][c] - s_delta[query]);
        }
      small_av(dv, p, sdO, 16 * qc, lane);
      small_av(dk, ds, sQ, 16 * qc, lane);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (row[r] >= S) continue;
      bf16* dst = dst0 + (i64)row[r] * 3 * D;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        *reinterpret_cast<__nv_bfloat162*>(dst + D + 8 * i + 2 * t4) =
            __floats2bfloat162_rn(dk[i][2 * r] * a.scale, dk[i][2 * r + 1] * a.scale);
        *reinterpret_cast<__nv_bfloat162*>(dst + 2 * D + 8 * i + 2 * t4) =
            __floats2bfloat162_rn(dv[i][2 * r], dv[i][2 * r + 1]);
      }
    }
  }
}

// dqkv of the H7 core. small: the one-block kernel (S <= TX_SMALL_MAX; it
// needs neither scratch array), else the padded lse and delta, then the dk/dv
// and dq passes; ops/text_attention.py::text_core_plan chooses and checks
// alignment. B sequences.
inline cudaError_t launch_text_bwd(const TextBwdArgs& a, int B, int small, cudaStream_t stream) {
  const int S = a.S;
  if (small) {
    if (S > TX_SMALL_MAX) return cudaErrorInvalidValue;
    const size_t smem = text_small_smem(S, 4, 2);
    cudaError_t err = cudaFuncSetAttribute(
        text_bwd_small_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    text_bwd_small_kernel<<<dim3(a.H, B), 32 * text_small_slabs(S), smem, stream>>>(a);
    return cudaGetLastError();
  }
  if (a.Sp != text_bwd_rows(S)) return cudaErrorInvalidValue;
  const i64 rows = (i64)B * S, D = (i64)a.H * 64;
  CUtensorMap qkv128, qkv64, do128, do64, o128;
  if (!tile_map(&qkv128, a.qkv, rows, 3 * D, 3 * D, TXB_ROWS) ||
      !tile_map(&qkv64, a.qkv, rows, 3 * D, 3 * D, TXB_STEP) ||
      !tile_map(&do128, a.dO, rows, D, D, TXB_ROWS) ||
      !tile_map(&do64, a.dO, rows, D, D, TXB_STEP) || !tile_map(&o128, a.O, rows, D, D, TXB_ROWS))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      text_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TXB_DQ_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(text_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               TXB_DKV_SMEM);
  if (err != cudaSuccess) return err;
  // dq first: it writes the padded lse and delta that dk/dv reads
  const dim3 grid((S + TXB_ROWS - 1) / TXB_ROWS, a.H, B);
  text_bwd_dq_kernel<<<grid, TXB_THREADS, TXB_DQ_SMEM, stream>>>(qkv128, do128, o128, qkv64, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  text_bwd_dkv_kernel<<<grid, TXB_THREADS, TXB_DKV_SMEM, stream>>>(qkv128, qkv64, do64, a);
  return cudaGetLastError();
}

}  // namespace tvts
