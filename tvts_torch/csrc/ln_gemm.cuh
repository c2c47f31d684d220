// ln_gemm: Y = epilogue(prologue(X) @ W^T + b), the building block that carries
// every matrix product of the sub-path kernels H1-H8 and the H7 forward (qkv,
// proj, c_fc, c_proj, the backwards' dx products). It replaces the products
// inside tvts_tpu/ops/pallas_block_attention.py's fused_*_block kernels
// (MXU dots on VMEM-resident weights there).
//
// X [M, K] bf16 (row stride lda), W [N, K] bf16 (the nn.Linear layout, so both
// operands are K-major, the layout wgmma reads from shared memory), f32
// accumulation. Prologue: optional LayerNorm, its f32 row statistics from
// row_stats_kernel, applied to the A tile in shared memory and rounded to
// bf16 before the product (the JAX kernels also round LN(x) to bf16).
// Epilogue: bias, activation (none / quick_gelu / exact erf gelu), residual
// add from a separate `res` tensor, bf16 store (or an f32 store to `Yf`, which
// the training backward uses for dL/dLN(x) = dqkv @ Wqkv ahead of the LayerNorm
// backward; it passes the transposed weight, so the product is the
// untransposed-weight one, dY @ W).
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
// Bound on the H100: the tensor cores for every product the port issues
// (K = 512..5120 at M in the tens of thousands: 2MNK flops against
// 2(MK + NK + MN) bytes is far above the card's 295 flops a byte). Design, for
// sm_90a only: a 128 x 256 output tile per block, K in steps of 64 (one
// 128-byte swizzle atom of bf16). One producer warp keeps TMA loads
// (cp.async.bulk.tensor, 128-byte swizzle, zero fill past the ragged M and N
// edges) in flight into a ring of GEMM_STAGES stages against full / empty
// mbarriers; two consumer warpgroups, 64 rows each, run wgmma.mma_async
// m64n256k16 with f32 accumulators in registers, A and W both read from the
// ring by descriptor. The LayerNorm prologue rewrites a warpgroup's A rows of
// the next stage in place, (x - mean) * rstd * w + b in f32 rounded to bf16,
// while the wgmmas of the current stage run (a register-A form with the
// fragments made in registers held 144 registers across the wgmmas; ptxas
// serialised them and spilled at the 168 registers a 9-warp block allows),
// so that the LayerNorm's cost hides under the tensor cores'. The epilogue
// writes the f32 accumulators (m64nN: per 8 columns, rows g and g + 8 of each
// warp's 16, columns 2t..2t+1) into the drained ring and applies bias,
// activation and residual there row-major, every global load and store a
// 16-byte vector with the loads of a batch of rows ahead of its stores:
// straight from the fragments, 4-byte accesses and each store holding back
// the next load cost 2-3x at the B/16 shapes (PERF.md).
// Not yet: a persistent tile scheduler, clusters with TMA multicast, fp8.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: the driver is reached at run time)

#include "common.cuh"

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

#ifndef TVTS_GEMM_PART  // the units of ln_gemm.cu hold one product kernel each
// One warp per row, two passes in f32 (mean, then mean of squared deviations),
// as LayerNormF32 computes them. Requires K % 8 == 0 and 16-byte aligned rows.
__global__ void row_stats_kernel(const bf16* __restrict__ X, i64 lda, int M, int K,
                                 float eps, float2* __restrict__ stats) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const bf16* x = X + (i64)row * lda;
  float s = 0.f;
  for (int k = lane * 8; k < K; k += 256) {
    uint4 u = *reinterpret_cast<const uint4*>(x + k);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(h[i]);
      s += f.x + f.y;
    }
  }
  const float mean = warp_sum(s) / K;
  float v = 0.f;
  for (int k = lane * 8; k < K; k += 256) {
    uint4 u = *reinterpret_cast<const uint4*>(x + k);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(h[i]);
      v += (f.x - mean) * (f.x - mean) + (f.y - mean) * (f.y - mean);
    }
  }
  v = warp_sum(v) / K;
  if (lane == 0) stats[row] = make_float2(mean, rsqrtf(v + eps));
}
#endif

struct GemmArgs {
  const bf16* X;
  i64 lda;
  const float2* stats;  // null: no LayerNorm prologue
  const float* ln_w;
  const float* ln_b;
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


// ---------------------------------------------------------------------------
// Hopper primitives: mbarriers, TMA, wgmma
// ---------------------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Returns once the phase of parity `parity` has completed. A phase that never
// completes (a fault in the pipeline) traps: an error, not a hung card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  while (!done) {
    if (clock64() - t0 > (1ll << 35)) __trap();  // ~20 s at the H100's clocks
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One box of a 2-D tensor map into shared memory; completes on `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// Barrier `id` (1..15) over `count` threads: the consumers only.
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Tells the compiler that the registers an asynchronous wgmma fills change
// here, so that no read of them moves above the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Descriptor of a K-major bf16 tile in shared memory under the 128-byte
// swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart (SBO), the
// leading offset unused; a k16 step within the atom adds 32 bytes to the
// start address (the tile itself 1024-byte aligned).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// D[64 x 256] (+)= A[64 x 16] B[16 x 256], both from shared memory by
// descriptor. scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss(float (&d)[128], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}


// LN, F32_OUT and EPI are template parameters, not runtime branches: a runtime
// test in the epilogue cost the bf16 kernel 4-6% (one A/B call on the H100,
// PERF.md), and the prologue decides between two mainloops.
template <bool LN, bool F32_OUT, int EPI>
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

  // The LayerNorm prologue rewrites this warpgroup's 64 A rows of a stage in
  // place, x -> bf16((x - mean) * rstd * w + b), before its wgmmas read them;
  // thread wt owns the 16-byte chunk wt % 8 of rows wt / 8 + 16 j (j < 4). The
  // 128-byte swizzle keeps logical chunk c of row r at chunk c ^ (r % 8), and
  // r % 8 is the same for all four rows, so each thread needs the LayerNorm
  // weights of one 8-column chunk a stage.
  auto normalize = [&](int kt) {
    const int s = kt % GEMM_STAGES;
    mbar_wait(full + 8 * s, (kt / GEMM_STAGES) & 1);
    uint8_t* rows = ring_ptr + s * GEMM_STAGE_BYTES + wg * 64 * 128;
    const int r0 = wt >> 3, chunk = wt & 7;
    const int k = kt * GEMM_BK + 8 * (chunk ^ (r0 & 7));
    const float4 w0 = __ldg(reinterpret_cast<const float4*>(a.ln_w + k));
    const float4 w1 = __ldg(reinterpret_cast<const float4*>(a.ln_w + k + 4));
    const float4 b0 = __ldg(reinterpret_cast<const float4*>(a.ln_b + k));
    const float4 b1 = __ldg(reinterpret_cast<const float4*>(a.ln_b + k + 4));
    const float w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = m0 + 64 * wg + r0 + 16 * j;
      const float2 st = row < a.M ? __ldg(a.stats + row) : make_float2(0.f, 1.f);
      uint4* p = reinterpret_cast<uint4*>(rows + (r0 + 16 * j) * 128 + chunk * 16);
      float x[8];
      unpack_bf16x8(*p, x);
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = (x[e] - st.x) * st.y * w[e] + b[e];
      *p = pack_bf16x8(x);
    }
    // the rewritten rows, written by the generic proxy, are read by wgmma
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    named_sync(2 + wg, 128);
  };

  if constexpr (LN) normalize(0);
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % GEMM_STAGES;
    if constexpr (!LN) mbar_wait(full + 8 * s, (kt / GEMM_STAGES) & 1);
    const uint32_t tile = ring + s * GEMM_STAGE_BYTES;
    const uint64_t dA = sw128_desc(tile + wg * 64 * 128);
    const uint64_t dW = sw128_desc(tile + GEMM_A_BYTES);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) wgmma_ss(acc, dA + 2 * j, dW + 2 * j, 1);
    wgmma_commit();
    // the next stage's LayerNorm runs while these wgmmas do
    if constexpr (LN)
      if (kt + 1 < KT) normalize(kt + 1);
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

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver that the runtime already loaded, so
// the library needs no -lcuda.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiledFn)p;
  }
  return fn;
}

// A [rows, K] bf16 at row stride `ld` elements, read in boxes of GEMM_BK x
// box_rows under the 128-byte swizzle; zeros past the last row.
inline bool tile_map(CUtensorMap* map, const bf16* base, i64 rows, i64 K, i64 ld, int box_rows) {
  EncodeTiledFn encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {GEMM_BK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, (void*)base, dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Each instantiation is compiled in a translation unit of its own
// (ln_gemm.cu, the units built in parallel): they take most of the build.
template <bool LN, bool F32_OUT, int EPI>
cudaError_t launch_gemm(const CUtensorMap& tmA, const CUtensorMap& tmW, const GemmArgs& a,
                        cudaStream_t stream) {
  auto kernel = ln_gemm_kernel<LN, F32_OUT, EPI>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, GEMM_SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((a.N + GEMM_BN - 1) / GEMM_BN, (a.M + GEMM_BM - 1) / GEMM_BM);
  kernel<<<grid, GEMM_THREADS, GEMM_SMEM, stream>>>(tmA, tmW, a);
  return cudaGetLastError();
}

// The seven kernels (prologue, f32 store, epilogue). ln_gemm.cu instantiates
// variant TVTS_GEMM_PART; every other unit only declares them.
#define TVTS_GEMM_VARIANT_0 true, false, EPI_PLAIN
#define TVTS_GEMM_VARIANT_1 true, true, EPI_PLAIN
#define TVTS_GEMM_VARIANT_2 true, false, EPI_SAVE_PRE
#define TVTS_GEMM_VARIANT_3 false, false, EPI_PLAIN
#define TVTS_GEMM_VARIANT_4 false, true, EPI_PLAIN
#define TVTS_GEMM_VARIANT_5 false, false, EPI_ACT_GRAD_BF16
#define TVTS_GEMM_VARIANT_6 false, false, EPI_ACT_GRAD_F32
#define TVTS_GEMM_LAUNCHER(...)                                                             \
  template cudaError_t launch_gemm<__VA_ARGS__>(const CUtensorMap&, const CUtensorMap&, \
                                                const GemmArgs&, cudaStream_t)
#ifndef TVTS_GEMM_PART
extern TVTS_GEMM_LAUNCHER(TVTS_GEMM_VARIANT_0);
extern TVTS_GEMM_LAUNCHER(TVTS_GEMM_VARIANT_1);
extern TVTS_GEMM_LAUNCHER(TVTS_GEMM_VARIANT_2);
extern TVTS_GEMM_LAUNCHER(TVTS_GEMM_VARIANT_3);
extern TVTS_GEMM_LAUNCHER(TVTS_GEMM_VARIANT_4);
extern TVTS_GEMM_LAUNCHER(TVTS_GEMM_VARIANT_5);
extern TVTS_GEMM_LAUNCHER(TVTS_GEMM_VARIANT_6);

// The LayerNorm row statistics (when ln_w is set), then the product. The
// caller has checked K % GEMM_BK == 0, 16-byte aligned pointers and row
// strides (ops/block_kernels.py::gemm_plan); a tensor map that cannot be made
// returns cudaErrorInvalidValue before any launch.
inline cudaError_t launch_ln_gemm(const GemmArgs& a, float eps, float2* stats, int epi,
                                  cudaStream_t stream) {
  CUtensorMap tmA, tmW;
  if (!tile_map(&tmA, a.X, a.M, a.K, a.lda, GEMM_BM) ||
      !tile_map(&tmW, a.W, a.N, a.K, a.K, GEMM_BN))
    return cudaErrorInvalidValue;
  GemmArgs args = a;
  const bool ln = a.ln_w != nullptr, f32 = a.Yf != nullptr;
  if (ln) {
    row_stats_kernel<<<(a.M + 7) / 8, 256, 0, stream>>>(a.X, a.lda, a.M, a.K, eps, stats);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  args.stats = ln ? stats : nullptr;
  if (epi == EPI_PLAIN && ln)
    return f32 ? launch_gemm<true, true, EPI_PLAIN>(tmA, tmW, args, stream)
               : launch_gemm<true, false, EPI_PLAIN>(tmA, tmW, args, stream);
  if (epi == EPI_PLAIN)
    return f32 ? launch_gemm<false, true, EPI_PLAIN>(tmA, tmW, args, stream)
               : launch_gemm<false, false, EPI_PLAIN>(tmA, tmW, args, stream);
  if (epi == EPI_SAVE_PRE && ln)
    return launch_gemm<true, false, EPI_SAVE_PRE>(tmA, tmW, args, stream);
  if (epi == EPI_ACT_GRAD_BF16 && !ln)
    return launch_gemm<false, false, EPI_ACT_GRAD_BF16>(tmA, tmW, args, stream);
  if (epi == EPI_ACT_GRAD_F32 && !ln)
    return launch_gemm<false, false, EPI_ACT_GRAD_F32>(tmA, tmW, args, stream);
  return cudaErrorInvalidValue;  // no caller asks for another combination: no kernel
}
#endif

}  // namespace tvts
