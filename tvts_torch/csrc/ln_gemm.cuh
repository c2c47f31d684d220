// ln_gemm: Y = epilogue(A @ W^T + b), the building block that carries every
// matrix product of the sub-path kernels H1-H8 and the H7 forward (qkv, proj,
// c_fc, c_proj, the backwards' dx products), and before a LayerNorm product
// the row pass that writes its A = LN(x). Together they replace the products
// inside tvts_tpu/ops/pallas_block_attention.py's fused_*_block kernels (MXU
// dots on VMEM-resident weights there) and those kernels' LayerNorm prologues
// (LN_3 / LN_1 / LN_2 of the VMEM-resident x, rounded to bf16 before the dot).
//
// A [M, K] bf16 (row stride lda), W [N, K] bf16 (the nn.Linear layout, so both
// operands are K-major, the layout wgmma reads from shared memory), f32
// accumulation. Epilogue: bias, activation (none / quick_gelu / exact erf
// gelu), residual add from a separate `res` tensor, bf16 store (or an f32
// store to `Yf`, which the training backward uses for dL/dLN(x) = dqkv @ Wqkv
// ahead of the LayerNorm backward; it passes the transposed weight, so the
// product is the untransposed-weight one, dY @ W).
//
// Two more epilogues serve the differentiable MLP sub-path (H8), chosen by the
// EPI template parameter so that the inference kernels' code does not change:
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
// The LayerNorm row pass (ln_rows_kernel), bound by its bytes: x read once,
// LN(x) written once in bf16 (2MK + 2MK + 8M bytes: 0.104 ms at the B/16
// extraction's M = 112,944, K = 768). One warp a row holds the row in
// registers (lane l the 16-byte chunks at columns 8l + 256i), so x leaves
// device memory once; f32 two-pass statistics (mean, then mean of squared
// deviations, rsqrtf(v + eps)) go to `stats`, which the training backward
// reads, and bf16((x - mean) * rstd * w + b) to a contiguous [M, K] buffer.
// The product then reads that buffer as an ordinary A operand.
// Why the LayerNorm is not in the product: applied there, it rewrote each
// stage's A tile in the shared-memory ring between the wgmmas (a 16-byte load
// and store a thread, a proxy fence and a named barrier a stage) and did so
// once for every 256-column tile, so that each row of x was normalised
// N / 256 times (9 and 12 times for B/16's qkv and c_fc, 15 and 20 at H/14).
// Those products ran at 328-367 TFLOP/s against 454-654 for the plain
// mainloop (B/16 shapes at M = 150,592, chip_smoke.py phase 6) and took 49% /
// 58% of the B/16 / H/14 extraction's device time (PERF.md).
//
// The product, bound on the H100 by the tensor cores for every product the
// port issues (K = 512..5120 at M in the tens of thousands: 2MNK flops against
// 2(MK + NK + MN) bytes is far above the card's 295 flops a byte). Design, for
// sm_90a only: a 128 x 256 output tile per block, K in steps of 64 (one
// 128-byte swizzle atom of bf16). One producer warp keeps TMA loads
// (cp.async.bulk.tensor, 128-byte swizzle, zero fill past the ragged M and N
// edges) in flight into a ring of GEMM_STAGES stages against full / empty
// mbarriers; two consumer warpgroups, 64 rows each, run wgmma.mma_async
// m64n256k16 with f32 accumulators in registers, A and W both read from the
// ring by descriptor. The epilogue writes the f32 accumulators (m64nN: per 8
// columns, rows g and g + 8 of each warp's 16, columns 2t..2t+1) into the
// drained ring and applies bias, activation and residual there row-major,
// every global load and store a 16-byte vector with the loads of a batch of
// rows ahead of its stores: straight from the fragments, 4-byte accesses and
// each store holding back the next load cost 2-3x at the B/16 shapes
// (PERF.md).
// Not yet: a persistent tile scheduler, clusters with TMA multicast, fp8.
#pragma once

#include "hopper.cuh"

namespace tvts {

enum Act { ACT_NONE = 0, ACT_QUICK_GELU = 1, ACT_GELU = 2 };
enum Epilogue { EPI_PLAIN = 0, EPI_SAVE_PRE = 1, EPI_ACT_GRAD_BF16 = 2, EPI_ACT_GRAD_F32 = 3 };

constexpr int GEMM_BM = 128;  // two consumer warpgroups of 64 rows
constexpr int GEMM_BN = 256;
constexpr int GEMM_BK = 64;   // bf16 elements in one 128-byte swizzle atom
constexpr int GEMM_STAGES = 4;
// warpgroups 0 and 1 consume, one more warp produces (9 warps: 168 registers
// a thread, the 128 accumulators and the rest)
constexpr int GEMM_THREADS = 288;
constexpr int GEMM_A_BYTES = GEMM_BM * GEMM_BK * 2;
constexpr int GEMM_W_BYTES = GEMM_BN * GEMM_BK * 2;
constexpr int GEMM_STAGE_BYTES = GEMM_A_BYTES + GEMM_W_BYTES;
// the ring, 1 KB of slack to align it to the swizzle pattern, 2 barriers a stage
constexpr int GEMM_SMEM = GEMM_STAGES * GEMM_STAGE_BYTES + 1024 + 2 * GEMM_STAGES * 8;
// The epilogue stages each warpgroup's 64 x 256 f32 tile in the drained ring,
// rows padded by 8 floats so that the fragments' float2 writes meet no bank
// conflict, and leaves it in row-major 16-byte vectors.
constexpr int EPI_LD = GEMM_BN + 8;
static_assert(2 * 64 * EPI_LD * 4 <= GEMM_STAGES * GEMM_STAGE_BYTES, "epilogue staging");
static_assert(GEMM_BK == 64, "tile_map's boxes are one 128-byte swizzle row wide");

#ifndef TVTS_GEMM_PART  // the units of ln_gemm.cu hold one product kernel each
// The LayerNorm row pass (notes above). A lane holds LN_ROWS_CHUNKS 16-byte
// chunks, so K <= 8 * 32 * LN_ROWS_CHUNKS; K % 8 == 0, 16-byte aligned rows,
// ln_w and ln_b. The sums run in the order of the first two-pass statistics
// kernel (a lane's chunks in column order, then the warp's butterfly), and
// the products and the eps add are written as _rn intrinsics, which are never
// fused, in the fmas and roundings that kernel and the in-ring prologue
// compiled to; so the statistics and the bf16 rows are bit for bit theirs.
// Left to the compiler, v / K + eps fused into one fma here (the first
// kernel added eps after a branch) and rstd differed in its last bit on some
// rows.
constexpr int LN_ROWS_CHUNKS = 20;  // K <= 5120
constexpr int LN_ROWS_THREADS = 256;  // 8 rows a block

struct LnRowsArgs {
  const bf16* X;
  i64 lda;
  int M, K;
  const float* ln_w;
  const float* ln_b;
  float eps;
  float2* stats;  // [M] (mean, rstd)
  bf16* Y;        // [M, K] contiguous
};

template <int C>
__global__ void __launch_bounds__(LN_ROWS_THREADS) ln_rows_kernel(const LnRowsArgs a) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= a.M) return;
  const bf16* x = a.X + (i64)row * a.lda;
  uint4 u[C];
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const int k = lane * 8 + 256 * i;
    u[i] = k < a.K ? *reinterpret_cast<const uint4*>(x + k) : make_uint4(0, 0, 0, 0);
  }
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < C; ++i) {
    if (lane * 8 + 256 * i >= a.K) continue;
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u[i]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float2 f = __bfloat1622float2(h[j]);
      s += f.x + f.y;
    }
  }
  const float mean = warp_sum(s) / a.K;
  float v = 0.f;
#pragma unroll
  for (int i = 0; i < C; ++i) {
    if (lane * 8 + 256 * i >= a.K) continue;
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u[i]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float2 f = __bfloat1622float2(h[j]);
      const float dx = __fsub_rn(f.x, mean), dy = __fsub_rn(f.y, mean);
      v = __fadd_rn(v, __fmaf_rn(dx, dx, __fmul_rn(dy, dy)));
    }
  }
  v = warp_sum(v) / a.K;
  const float rstd = rsqrtf(__fadd_rn(v, a.eps));
  if (lane == 0) a.stats[row] = make_float2(mean, rstd);
  bf16* y = a.Y + (i64)row * a.K;
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const int k = lane * 8 + 256 * i;
    if (k >= a.K) continue;
    const float4 w0 = __ldg(reinterpret_cast<const float4*>(a.ln_w + k));
    const float4 w1 = __ldg(reinterpret_cast<const float4*>(a.ln_w + k + 4));
    const float4 b0 = __ldg(reinterpret_cast<const float4*>(a.ln_b + k));
    const float4 b1 = __ldg(reinterpret_cast<const float4*>(a.ln_b + k + 4));
    const float w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
    float f[8];
    unpack_bf16x8(u[i], f);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      f[e] = __fmaf_rn(__fmul_rn(__fsub_rn(f[e], mean), rstd), w[e], b[e]);
    *reinterpret_cast<uint4*>(y + k) = pack_bf16x8(f);
  }
}

template <int C>
cudaError_t launch_ln_rows_at(const LnRowsArgs& a, cudaStream_t stream) {
  const int rows_a_block = LN_ROWS_THREADS / 32;
  ln_rows_kernel<C><<<(a.M + rows_a_block - 1) / rows_a_block, LN_ROWS_THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

// The row pass with the fewest registers that hold a row: a lane's chunks
// exactly up to K = 2048, then in steps.
inline cudaError_t launch_ln_rows(const LnRowsArgs& a, cudaStream_t stream) {
  if (a.M < 1 || a.K < 8 || a.K % 8 || a.K > 256 * LN_ROWS_CHUNKS || a.lda < a.K ||
      a.lda % 8 || !a.ln_w || !a.ln_b || !a.stats || !a.Y)
    return cudaErrorInvalidValue;
  switch ((a.K + 255) / 256) {
    case 1: return launch_ln_rows_at<1>(a, stream);
    case 2: return launch_ln_rows_at<2>(a, stream);
    case 3: return launch_ln_rows_at<3>(a, stream);
    case 4: return launch_ln_rows_at<4>(a, stream);
    case 5: return launch_ln_rows_at<5>(a, stream);
    case 6: return launch_ln_rows_at<6>(a, stream);
    case 7: return launch_ln_rows_at<7>(a, stream);
    case 8: return launch_ln_rows_at<8>(a, stream);
    case 9: case 10: case 11: case 12: return launch_ln_rows_at<12>(a, stream);
    case 13: case 14: case 15: case 16: return launch_ln_rows_at<16>(a, stream);
    default: return launch_ln_rows_at<LN_ROWS_CHUNKS>(a, stream);
  }
}
#endif

struct GemmArgs {
  const bf16* X;
  i64 lda;
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

// F32_OUT and EPI are template parameters, not runtime branches: a runtime
// test in the epilogue cost the bf16 kernel 4-6% (one A/B call on the H100,
// PERF.md).
template <bool F32_OUT, int EPI>
__global__ void __launch_bounds__(GEMM_THREADS, 1)
    ln_gemm_kernel(const __grid_constant__ CUtensorMap tmA,
                   const __grid_constant__ CUtensorMap tmW, const GemmArgs a) {
  extern __shared__ uint8_t gemm_smem[];
  const uint32_t raw = smem_addr(gemm_smem);
  const uint32_t ring = (raw + 1023) & ~1023u;  // the swizzle pattern repeats every 1 KB
  const uint32_t full = ring + GEMM_STAGES * GEMM_STAGE_BYTES;
  const uint32_t empty = full + GEMM_STAGES * 8;
  uint8_t* ring_ptr = gemm_smem + (ring - raw);

  const int tid = threadIdx.x, wg = tid >> 7;
  const int m0 = blockIdx.y * GEMM_BM, n0 = blockIdx.x * GEMM_BN;
  const int KT = a.K / GEMM_BK;
  if (tid == 0) {
    for (int s = 0; s < GEMM_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);   // the producer's expect_tx
      mbar_init(empty + 8 * s, 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread keeps the ring full --------------------------
    if (tid == 2 * 128) {
      for (int kt = 0; kt < KT; ++kt) {
        const int s = kt % GEMM_STAGES;
        if (kt >= GEMM_STAGES) mbar_wait(empty + 8 * s, ((kt / GEMM_STAGES) & 1) ^ 1);
        const uint32_t dst = ring + s * GEMM_STAGE_BYTES;
        mbar_expect_tx(full + 8 * s, GEMM_STAGE_BYTES);
        tma_load_2d(dst, &tmA, full + 8 * s, kt * GEMM_BK, m0);
        tma_load_2d(dst + GEMM_A_BYTES, &tmW, full + 8 * s, kt * GEMM_BK, n0);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 ----------------
  const int wt = tid & 127, warp = wt >> 5, lane = tid & 31;
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;

  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % GEMM_STAGES;
    mbar_wait(full + 8 * s, (kt / GEMM_STAGES) & 1);
    const uint32_t tile = ring + s * GEMM_STAGE_BYTES;
    const uint64_t dA = sw128_desc(tile + wg * 64 * 128);
    const uint64_t dW = sw128_desc(tile + GEMM_A_BYTES);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) wgmma_ss(acc, dA + 2 * j, dW + 2 * j, 1);
    wgmma_commit();
    // the previous stage's wgmmas are done: hand it back to the producer
    wgmma_wait<1>();
    if (kt > 0 && wt == 0) mbar_arrive(empty + 8 * ((kt - 1) % GEMM_STAGES));
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // ---- epilogue ------------------------------------------------------------
  // Both warpgroups are out of the ring (every stage consumed and every wgmma
  // done): each stages its f32 tile there, from the accumulator layout (per 8
  // columns i, rows g and g + 8 of the warp's 16, columns 2t..2t+1) ...
  named_sync(1, 256);
  float* st = reinterpret_cast<float*>(ring_ptr) + wg * 64 * EPI_LD;
  {
    const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int i = 0; i < GEMM_BN / 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(st + (16 * warp + g + 8 * h) * EPI_LD + 8 * i + 2 * t4) =
            make_float2(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
  }
  named_sync(2 + wg, 128);
  // ... and reads it back row-major: lane l owns columns 8l..8l+7 of the rows
  // warp, warp + 4, ... of its warpgroup's 64, so that every load and store
  // is a 16-byte vector and a warp covers a 512-byte row. Each batch issues
  // its loads before any store (the output may alias nothing the compiler
  // can prove, so a store would otherwise hold back the next load).
  const int col = n0 + 8 * lane;
  if (col >= a.N) return;
  float bias[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) bias[e] = 0.f;
  if (EPI < EPI_ACT_GRAD_BF16 && a.bias)
    unpack_bf16x8(*reinterpret_cast<const uint4*>(a.bias + col), bias);
  constexpr int BATCH = 8;  // rows a batch; 16 rows a thread
#pragma unroll 1
  for (int r0 = 0; r0 < 16; r0 += BATCH) {
    uint4 side[BATCH][2];  // residual (bf16) or the hidden h (bf16 in [0], f32 in [0..1])
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int row = m0 + 64 * wg + warp + 4 * (r0 + j);
      side[j][0] = side[j][1] = make_uint4(0, 0, 0, 0);
      if (row >= a.M) continue;
      if constexpr (EPI == EPI_ACT_GRAD_F32) {
        const uint4* hp = reinterpret_cast<const uint4*>(static_cast<const float*>(a.Hin) +
                                                         (i64)row * a.ldy + col);
        side[j][0] = hp[0];
        side[j][1] = hp[1];
      } else if constexpr (EPI == EPI_ACT_GRAD_BF16) {
        side[j][0] = *reinterpret_cast<const uint4*>(static_cast<const bf16*>(a.Hin) +
                                                     (i64)row * a.ldy + col);
      } else if (a.res) {
        side[j][0] = *reinterpret_cast<const uint4*>(a.res + (i64)row * a.ldres + col);
      }
    }
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int r = warp + 4 * (r0 + j), row = m0 + 64 * wg + r;
      if (row >= a.M) continue;
      const float4 lo = *reinterpret_cast<const float4*>(st + r * EPI_LD + 8 * lane);
      const float4 hi = *reinterpret_cast<const float4*>(st + r * EPI_LD + 8 * lane + 4);
      float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      const i64 at = (i64)row * a.ldy + col;
      if constexpr (EPI >= EPI_ACT_GRAD_BF16) {
        float h[8];
        if constexpr (EPI == EPI_ACT_GRAD_F32) {
          const uint4 p = side[j][0], q = side[j][1];
          const uint32_t w[8] = {p.x, p.y, p.z, p.w, q.x, q.y, q.z, q.w};
#pragma unroll
          for (int e = 0; e < 8; ++e) h[e] = __uint_as_float(w[e]);
        } else {
          unpack_bf16x8(side[j][0], h);
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          float d;
          act_and_grad(h[e], a.act, h[e], d);
          v[e] *= d;
        }
        *reinterpret_cast<uint4*>(a.Y + at) = pack_bf16x8(v);
        *reinterpret_cast<uint4*>(a.Y2 + at) = pack_bf16x8(h);
        continue;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] += bias[e];
      if constexpr (EPI == EPI_SAVE_PRE) {
        const uint4 pre = pack_bf16x8(v);
        *reinterpret_cast<uint4*>(a.Y2 + at) = pre;
        unpack_bf16x8(pre, v);
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = activate(v[e], a.act);
      if (a.res) {
        float r8[8];
        unpack_bf16x8(side[j][0], r8);
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] += r8[e];
      }
      if constexpr (F32_OUT) {
        float4* yp = reinterpret_cast<float4*>(a.Yf + at);
        yp[0] = make_float4(v[0], v[1], v[2], v[3]);
        yp[1] = make_float4(v[4], v[5], v[6], v[7]);
      } else {
        *reinterpret_cast<uint4*>(a.Y + at) = pack_bf16x8(v);
      }
    }
  }
}

// Each instantiation is compiled in a translation unit of its own
// (ln_gemm.cu, the units built in parallel): they take most of the build.
template <bool F32_OUT, int EPI>
cudaError_t launch_gemm(const CUtensorMap& tmA, const CUtensorMap& tmW, const GemmArgs& a,
                        cudaStream_t stream) {
  auto kernel = ln_gemm_kernel<F32_OUT, EPI>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, GEMM_SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((a.N + GEMM_BN - 1) / GEMM_BN, (a.M + GEMM_BM - 1) / GEMM_BM);
  kernel<<<grid, GEMM_THREADS, GEMM_SMEM, stream>>>(tmA, tmW, a);
  return cudaGetLastError();
}

// The five kernels (f32 store, epilogue). ln_gemm.cu instantiates variant
// TVTS_GEMM_PART; every other unit only declares them.
#define TVTS_GEMM_VARIANT_0 false, EPI_PLAIN
#define TVTS_GEMM_VARIANT_1 true, EPI_PLAIN
#define TVTS_GEMM_VARIANT_2 false, EPI_SAVE_PRE
#define TVTS_GEMM_VARIANT_3 false, EPI_ACT_GRAD_BF16
#define TVTS_GEMM_VARIANT_4 false, EPI_ACT_GRAD_F32
#define TVTS_GEMM_LAUNCHER(...)                                                             \
  template cudaError_t launch_gemm<__VA_ARGS__>(const CUtensorMap&, const CUtensorMap&, \
                                                const GemmArgs&, cudaStream_t)
#ifndef TVTS_GEMM_PART
extern TVTS_GEMM_LAUNCHER(TVTS_GEMM_VARIANT_0);
extern TVTS_GEMM_LAUNCHER(TVTS_GEMM_VARIANT_1);
extern TVTS_GEMM_LAUNCHER(TVTS_GEMM_VARIANT_2);
extern TVTS_GEMM_LAUNCHER(TVTS_GEMM_VARIANT_3);
extern TVTS_GEMM_LAUNCHER(TVTS_GEMM_VARIANT_4);

// With `ln` (its X, lda, M and K those of `a`): the LayerNorm row pass writes
// LN(X) to ln->Y, which the product then reads as A at row stride K; else the
// product of X. The caller has checked K % GEMM_BK == 0, 16-byte aligned
// pointers and row strides (ops/block_kernels.py::gemm_plan, ln_rows_plan); a
// tensor map that cannot be made returns cudaErrorInvalidValue before any
// launch.
inline cudaError_t launch_ln_gemm(const GemmArgs& a, const LnRowsArgs* ln, int epi,
                                  cudaStream_t stream) {
  GemmArgs args = a;
  if (ln) {
    args.X = ln->Y;
    args.lda = a.K;
  }
  CUtensorMap tmA, tmW;
  if (!tile_map(&tmA, args.X, a.M, a.K, args.lda, GEMM_BM) ||
      !tile_map(&tmW, a.W, a.N, a.K, a.K, GEMM_BN))
    return cudaErrorInvalidValue;
  if (ln) {
    cudaError_t err = launch_ln_rows(*ln, stream);
    if (err != cudaSuccess) return err;
  }
  const bool f32 = a.Yf != nullptr;
  if (epi == EPI_PLAIN)
    return f32 ? launch_gemm<true, EPI_PLAIN>(tmA, tmW, args, stream)
               : launch_gemm<false, EPI_PLAIN>(tmA, tmW, args, stream);
  if (epi == EPI_SAVE_PRE) return launch_gemm<false, EPI_SAVE_PRE>(tmA, tmW, args, stream);
  if (epi == EPI_ACT_GRAD_BF16)
    return launch_gemm<false, EPI_ACT_GRAD_BF16>(tmA, tmW, args, stream);
  if (epi == EPI_ACT_GRAD_F32) return launch_gemm<false, EPI_ACT_GRAD_F32>(tmA, tmW, args, stream);
  return cudaErrorInvalidValue;
}
#endif

}  // namespace tvts
