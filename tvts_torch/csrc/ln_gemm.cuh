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
// port issues (K = 512..6144 at M in the tens of thousands: 2MNK flops against
// 2(MK + NK + MN) bytes is far above the card's 295 flops a byte). Design, for
// sm_90a only: 128 x 256 output tiles, K in steps of 64 (one 128-byte swizzle
// atom of bf16); a persistent grid of min(tiles, SMs) blocks, one an SM, each
// walking the tiles blockIdx.x, blockIdx.x + gridDim.x, ... One producer warp
// keeps TMA loads (cp.async.bulk.tensor, 128-byte swizzle, zero fill past the
// ragged M and N edges) in flight into a ring of GEMM_STAGES stages against
// full / empty mbarriers, across tile boundaries; two consumer warpgroups, 64
// rows each, run wgmma.mma_async m64n256k16 with f32 accumulators in
// registers, A and W both read from the ring by descriptor. The epilogue has
// a buffer of its own (GEMM_EPI_BYTES, two slots of whole TMA boxes): the
// consumers apply bias, activation and residual to the accumulators in
// fragment order and write each piece into its slot under the 128-byte
// swizzle by stmatrix (the residual read back by ldmatrix), then go on to
// the next tile; a storer warp hands the piece to a TMA store and, once the
// store has read the slot, brings the next piece's residual (or the hidden h
// of the act' epilogues) into it by TMA. The next tile's ring fill, the
// stores and the residual's reads thus run under tensor-core work; what
// stays exposed a tile is the consumers' epilogue arithmetic and
// shared-memory writes. Fitted to the B/16 proj (K = 768) and c_proj (K =
// 3072) at M = 150,592 on the H100 (chip_smoke.gemm_fit, PERF.md): the first
// design (one tile a block, the f32 tile staged through the drained ring,
// 16-byte global loads and stores from the consumers) paid 5.4 us a tile on
// top of 0.73 us a k step; this one 3.3 us on top of 0.77. A first version
// of this one, writing 4-byte bf16 pairs with a runtime activation test on
// every element, paid 8-9 us a tile: its epilogue alone took 7.4 us. Three
// stages beside a 64 KB buffer ran the three benchmark cells 0-0.8% faster
// than four stages beside 32 KB (pieces of 64 columns), although four read a
// k step in ~0.69 us against ~0.76 and ran a walk of one K = 3072 tile (c_proj
// at M = 5,504) 13% faster.
// Not yet: the partial last N tile at N = 1408 / 4224, W multicast in 2 x 1
// clusters, the last wave's tail, fp8.
#pragma once

#include "hopper.cuh"

namespace tvts {

enum Act { ACT_NONE = 0, ACT_QUICK_GELU = 1, ACT_GELU = 2 };
enum Epilogue { EPI_PLAIN = 0, EPI_SAVE_PRE = 1, EPI_ACT_GRAD_BF16 = 2, EPI_ACT_GRAD_F32 = 3 };

constexpr int GEMM_BM = 128;  // two consumer warpgroups of 64 rows
constexpr int GEMM_BN = 256;
constexpr int GEMM_BK = 64;   // bf16 elements in one 128-byte swizzle atom
constexpr int GEMM_STAGES = 3;
// warpgroups 0 and 1 consume, one more warp produces and one stores (10
// warps: the 128 accumulators a consumer thread and the rest in 200 registers)
constexpr int GEMM_CONSUMERS = 256;
constexpr int GEMM_THREADS = GEMM_CONSUMERS + 64;
constexpr int GEMM_A_BYTES = GEMM_BM * GEMM_BK * 2;
constexpr int GEMM_W_BYTES = GEMM_BN * GEMM_BK * 2;
constexpr int GEMM_STAGE_BYTES = GEMM_A_BYTES + GEMM_W_BYTES;
// The epilogue buffer: the tile's output in TMA boxes of 128 rows by one
// 128-byte swizzle row (64 bf16 or 32 f32 columns, 16 KB), in one or two
// slots (GemmEpi).
constexpr int GEMM_BOX_BYTES = GEMM_BM * 128;
constexpr int GEMM_EPI_BYTES = 4 * GEMM_BOX_BYTES;
// full and empty a stage, a ready barrier a slot
constexpr int GEMM_BARRIERS = 2 * GEMM_STAGES + 2;
// 1 KB of slack to align the ring to the swizzle pattern, the ring, the
// epilogue buffer, the barriers
constexpr int GEMM_SMEM =
    1024 + GEMM_STAGES * GEMM_STAGE_BYTES + GEMM_EPI_BYTES + 8 * GEMM_BARRIERS;
static_assert(GEMM_SMEM <= SMEM_OPTIN, "ring and epilogue buffer in one block");
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

// The epilogue's pieces for one variant: a piece is all 128 rows of the tile
// and as many of its columns as one slot holds, in the slot's TMA boxes; the
// f32 output takes 4 bytes an element, the two bf16 outputs of EPI_SAVE_PRE
// and EPI_ACT_GRAD_* 2 + 2 (Y in the slot's first half, Y2 in its second).
// Two slots when a piece of at least one box of each output fits in half the
// buffer, so that one piece is written while the store of the other drains;
// else one slot.
template <bool F32_OUT, int EPI>
struct GemmEpi {
  static constexpr int ELEM = (F32_OUT || EPI != EPI_PLAIN) ? 4 : 2;
  static constexpr int MIN_PIECE = EPI == EPI_PLAIN ? GEMM_BOX_BYTES : 2 * GEMM_BOX_BYTES;
  static constexpr int SLOTS = GEMM_EPI_BYTES / 2 >= MIN_PIECE ? 2 : 1;
  static constexpr int SLOT = GEMM_EPI_BYTES / SLOTS;
  static constexpr int COLS = SLOT / (GEMM_BM * ELEM);
  static constexpr int PIECES = GEMM_BN / COLS;
  static constexpr int Y2_OFF = SLOT / 2;
  static_assert(COLS * PIECES == GEMM_BN && COLS % (F32_OUT ? 32 : 64) == 0, "piece of boxes");
};

// Byte offset of (row r, column c) in a piece's boxes as TMA lays them out
// under the 128-byte swizzle: row r's 16-byte chunk k at chunk k ^ (r % 8).
// The 16-byte rows of an 8 x 8 matrix (stmatrix / ldmatrix, rows r .. r + 7
// of one chunk) then fall in 8 different chunks, all 32 banks.
__device__ __forceinline__ uint32_t bf16_at(int r, int c) {
  return (c >> 6) * GEMM_BOX_BYTES + r * 128 + ((((c >> 3) & 7) ^ (r & 7)) << 4) + ((c & 7) << 1);
}
__device__ __forceinline__ uint32_t f32_at(int r, int c) {
  return (c >> 5) * GEMM_BOX_BYTES + r * 128 + ((((c >> 2) & 7) ^ (r & 7)) << 4) + ((c & 3) << 2);
}

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// One piece of a consumer thread's epilogue (piece j of the tile, into the slot
// at shared address `slot`, `ptr` its generic pointer, global columns col0 ..
// col0 + COLS - 1; the warp's 16 rows from wrow). Per 8 columns i, a thread
// holds rows g8 and g8 + 8 of its warp's 16, columns 2 t4 .. 2 t4 + 1
// (acc[4 i + 2 h], acc[4 i + 2 h + 1]); the arithmetic per element is the
// row-major pass's of the first design: bias, activation (from the
// bf16-rounded h under EPI_SAVE_PRE), residual, one rounding. ACT is a
// template parameter, so no element tests it. The bf16 outputs and side
// inputs move by stmatrix / ldmatrix, an x4 a pair of 8-column chunks: matrix
// k is rows 8 (k % 2) .. + 7 of chunk 2 p + k / 2; the f32 output and h by
// 8-byte accesses, in fragment order.
template <bool F32_OUT, int EPI, int ACT>
__device__ __forceinline__ void epilogue_piece(const float (&acc)[128], int j, uint32_t slot,
                                               uint8_t* ptr, bool side, const GemmArgs& a,
                                               int col0, int wrow, int lane) {
  using E = GemmEpi<F32_OUT, EPI>;
  constexpr int CH = E::COLS / 8;  // 8-column chunks a piece
  const int g8 = lane >> 2, t4 = lane & 3;
  uint32_t bw[CH];  // the bias pairs of this thread's columns, loaded together
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int col = col0 + 8 * c + 2 * t4;
    bw[c] = EPI < EPI_ACT_GRAD_BF16 && a.bias && col < a.N
                ? __ldg(reinterpret_cast<const unsigned int*>(a.bias + col))
                : 0u;
  }
  if constexpr (F32_OUT) {
#pragma unroll
    for (int c = 0; c < CH; ++c)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = j * CH + c;
        const float v0 = activate(acc[4 * i + 2 * h] + bf16_lo(bw[c]), ACT);
        const float v1 = activate(acc[4 * i + 2 * h + 1] + bf16_hi(bw[c]), ACT);
        *reinterpret_cast<float2*>(ptr + f32_at(wrow + g8 + 8 * h, 8 * c + 2 * t4)) =
            make_float2(v0, v1);
      }
    return;
  } else {
    float hf[EPI == EPI_ACT_GRAD_F32 ? CH : 1][2][2];
    if constexpr (EPI == EPI_ACT_GRAD_F32) {
      // h (f32) fills the slot where the two bf16 outputs go: read all of it
      // before any output is written
#pragma unroll
      for (int c = 0; c < CH; ++c)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 f =
              *reinterpret_cast<const float2*>(ptr + f32_at(wrow + g8 + 8 * h, 8 * c + 2 * t4));
          hf[c][h][0] = f.x;
          hf[c][h][1] = f.y;
        }
      named_sync(1, GEMM_CONSUMERS);
    }
    const int mk = lane >> 3;  // the matrix whose row this lane addresses
    const int mrow = wrow + (lane & 7) + 8 * (mk & 1);
#pragma unroll
    for (int p = 0; p < CH / 2; ++p) {
      const uint32_t at = slot + bf16_at(mrow, 8 * (2 * p + (mk >> 1)));
      uint32_t in[4] = {0u, 0u, 0u, 0u}, out[4], out2[4];
      if (EPI == EPI_PLAIN && side) ldmatrix_x4(at, in);
      if constexpr (EPI == EPI_ACT_GRAD_BF16) ldmatrix_x4(at + E::Y2_OFF, in);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int c = 2 * p + (k >> 1), h = k & 1, i = j * CH + c;
        float v0 = acc[4 * i + 2 * h], v1 = acc[4 * i + 2 * h + 1];
        if constexpr (EPI >= EPI_ACT_GRAD_BF16) {
          float h0, h1, d0, d1;
          if constexpr (EPI == EPI_ACT_GRAD_F32) {
            h0 = hf[c][h][0];
            h1 = hf[c][h][1];
          } else {
            h0 = bf16_lo(in[k]);
            h1 = bf16_hi(in[k]);
          }
          act_and_grad(h0, ACT, h0, d0);
          act_and_grad(h1, ACT, h1, d1);
          out[k] = pack_bf16x2(v0 * d0, v1 * d1);
          out2[k] = pack_bf16x2(h0, h1);
        } else {
          v0 += bf16_lo(bw[c]);
          v1 += bf16_hi(bw[c]);
          if constexpr (EPI == EPI_SAVE_PRE) {
            out2[k] = pack_bf16x2(v0, v1);
            v0 = bf16_lo(out2[k]);
            v1 = bf16_hi(out2[k]);
          }
          v0 = activate(v0, ACT);
          v1 = activate(v1, ACT);
          if (EPI == EPI_PLAIN && side) {
            v0 += bf16_lo(in[k]);
            v1 += bf16_hi(in[k]);
          }
          out[k] = pack_bf16x2(v0, v1);
        }
      }
      stmatrix_x4(at, out);
      if constexpr (EPI != EPI_PLAIN) stmatrix_x4(at + E::Y2_OFF, out2);
    }
  }
}

// F32_OUT and EPI are template parameters, not runtime branches: a runtime
// test in the epilogue cost the bf16 kernel 4-6% (one A/B call on the H100,
// PERF.md).
//
// Persistent: a block an SM walks the tiles blockIdx.x, blockIdx.x +
// gridDim.x, ... (N fastest, then M: the order in which a grid of one tile a
// block ran them). Three roles. The producer warp keeps the ring full across
// tile boundaries (its ring position and phases run over the whole walk), so
// the ring fills for the next tile while the consumers run this tile's
// epilogue. The two consumer warpgroups run the mainloop, then write each
// piece of the epilogue from the accumulators into its slot and arrive at the
// slot's named barrier. The storer warp waits there, hands the piece to a TMA
// store, waits until the store has read the slot, and makes the slot ready
// for its next piece (slot_ready), bringing that piece's side input (the
// residual, or the hidden h) into it by TMA first. So no consumer waits on
// global memory: stores drain and side inputs land under the mainloop.
template <bool F32_OUT, int EPI>
__global__ void __launch_bounds__(GEMM_THREADS, 1)
    ln_gemm_kernel(const __grid_constant__ CUtensorMap tmA,
                   const __grid_constant__ CUtensorMap tmW,
                   const __grid_constant__ CUtensorMap tmY,
                   const __grid_constant__ CUtensorMap tmY2,
                   const __grid_constant__ CUtensorMap tmSide, const GemmArgs a) {
  using E = GemmEpi<F32_OUT, EPI>;
  extern __shared__ uint8_t gemm_smem[];
  const uint32_t raw = smem_addr(gemm_smem);
  const uint32_t ring = (raw + 1023) & ~1023u;  // the swizzle pattern repeats every 1 KB
  const uint32_t epi = ring + GEMM_STAGES * GEMM_STAGE_BYTES;
  const uint32_t full = epi + GEMM_EPI_BYTES;
  const uint32_t empty = full + GEMM_STAGES * 8;
  const uint32_t slot_ready = empty + GEMM_STAGES * 8;  // a slot may be written
  uint8_t* epi_ptr = gemm_smem + (epi - raw);

  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int tiles_n = (a.N + GEMM_BN - 1) / GEMM_BN;
  const int tiles = tiles_n * ((a.M + GEMM_BM - 1) / GEMM_BM);
  const int KT = a.K / GEMM_BK;
  // the side input, which the epilogue reads from its slot: the residual
  // (bf16), or the hidden h (bf16 into Y2's half, f32 over the slot)
  const bool side = (EPI == EPI_PLAIN && !F32_OUT) ? a.res != nullptr : EPI >= EPI_ACT_GRAD_BF16;
  if (tid == 0) {
    for (int s = 0; s < GEMM_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);   // the producer's expect_tx
      mbar_init(empty + 8 * s, 2);  // one arrival per consumer warpgroup
    }
    for (int s = 0; s < 2; ++s) mbar_init(slot_ready + 8 * s, 1);  // the storer's (expect_tx)
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= GEMM_CONSUMERS && tid < GEMM_CONSUMERS + 32) {
    // ---- producer: one thread keeps the ring full --------------------------
    if (lane == 0) {
      int stage = 0, phase = 0, g = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / tiles_n) * GEMM_BM, n0 = (tile % tiles_n) * GEMM_BN;
        for (int kt = 0; kt < KT; ++kt, ++g) {
          if (g >= GEMM_STAGES) mbar_wait(empty + 8 * stage, phase ^ 1);
          const uint32_t dst = ring + stage * GEMM_STAGE_BYTES;
          mbar_expect_tx(full + 8 * stage, GEMM_STAGE_BYTES);
          tma_load_2d(dst, &tmA, full + 8 * stage, kt * GEMM_BK, m0);
          tma_load_2d(dst + GEMM_A_BYTES, &tmW, full + 8 * stage, kt * GEMM_BK, n0);
          if (++stage == GEMM_STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  if (tid >= GEMM_CONSUMERS) {
    // ---- storer: the whole warp at the named barriers, lane 0 for TMA ------
    // Piece q of the walk (piece q % PIECES of the block's (q / PIECES)-th
    // tile) goes to slot q % SLOTS.
    const int total = (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x * E::PIECES;
    auto make_ready = [&](int q) {
      const uint32_t bar = slot_ready + 8 * (q % E::SLOTS);
      if (!side) {
        mbar_arrive(bar);
        return;
      }
      const int tile = blockIdx.x + q / E::PIECES * gridDim.x;
      const int m0 = (tile / tiles_n) * GEMM_BM;
      const int c0 = (tile % tiles_n) * GEMM_BN + q % E::PIECES * E::COLS;
      const uint32_t dst =
          epi + q % E::SLOTS * E::SLOT + (EPI == EPI_ACT_GRAD_BF16 ? E::Y2_OFF : 0);
      constexpr int BOX_COLS = EPI == EPI_ACT_GRAD_F32 ? 32 : 64;
      int boxes = 0;  // the boxes that start inside N (TMA fills the rest of a box with zeros)
      for (int b = 0; b < E::COLS / BOX_COLS; ++b) boxes += c0 + b * BOX_COLS < a.N;
      mbar_expect_tx(bar, boxes * GEMM_BOX_BYTES);
      for (int b = 0; b < boxes; ++b)
        tma_load_2d(dst + b * GEMM_BOX_BYTES, &tmSide, bar, c0 + b * BOX_COLS, m0);
    };
    if (lane == 0)
      for (int q = 0; q < E::SLOTS && q < total; ++q) make_ready(q);
    for (int q = 0; q < total; ++q) {
      const int s = q % E::SLOTS;
      __syncwarp();
      named_sync(2 + s, GEMM_CONSUMERS + 32);  // the consumers have written piece q
      if (lane == 0) {
        const int tile = blockIdx.x + q / E::PIECES * gridDim.x;
        const int m0 = (tile / tiles_n) * GEMM_BM;
        const int c0 = (tile % tiles_n) * GEMM_BN + q % E::PIECES * E::COLS;
        const uint32_t src = epi + s * E::SLOT;
        if constexpr (F32_OUT) {
          for (int b = 0; b < E::COLS / 32 && c0 + 32 * b < a.N; ++b)
            tma_store_2d(&tmY, src + b * GEMM_BOX_BYTES, c0 + 32 * b, m0);
        } else {
          for (int b = 0; b < E::COLS / 64 && c0 + 64 * b < a.N; ++b) {
            tma_store_2d(&tmY, src + b * GEMM_BOX_BYTES, c0 + 64 * b, m0);
            if (EPI != EPI_PLAIN)
              tma_store_2d(&tmY2, src + E::Y2_OFF + b * GEMM_BOX_BYTES, c0 + 64 * b, m0);
          }
        }
        bulk_commit();
        bulk_wait_read<0>();
        if (q + E::SLOTS < total) make_ready(q + E::SLOTS);
      }
    }
    if (lane == 0) bulk_wait_all();  // the block's shared memory outlives its stores
    return;
  }

  // ---- consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 ----------------
  const int wt = tid & 127, warp = wt >> 5;
  float acc[128];
  int stage = 0, phase = 0, q = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int n0 = (tile % tiles_n) * GEMM_BN;
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    int prev = 0;
    for (int kt = 0; kt < KT; ++kt) {
      mbar_wait(full + 8 * stage, phase);
      const uint32_t tile_s = ring + stage * GEMM_STAGE_BYTES;
      const uint64_t dA = sw128_desc(tile_s + wg * 64 * 128);
      const uint64_t dW = sw128_desc(tile_s + GEMM_A_BYTES);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j) wgmma_ss(acc, dA + 2 * j, dW + 2 * j, 1);
      wgmma_commit();
      // the previous stage's wgmmas are done: hand it back to the producer
      wgmma_wait<1>();
      if (kt > 0 && wt == 0) mbar_arrive(empty + 8 * prev);
      prev = stage;
      if (++stage == GEMM_STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (wt == 0) mbar_arrive(empty + 8 * prev);

    // ---- epilogue, a piece at a time (epilogue_piece) -----------------------
    const int wrow = 64 * wg + 16 * warp;
#pragma unroll
    for (int j = 0; j < E::PIECES; ++j, ++q) {
      const int s = q % E::SLOTS, col0 = n0 + j * E::COLS;
      const uint32_t slot = epi + s * E::SLOT;
      uint8_t* ptr = epi_ptr + s * E::SLOT;
      mbar_wait(slot_ready + 8 * s, (q / E::SLOTS) & 1);
      if (a.act == ACT_GELU)
        epilogue_piece<F32_OUT, EPI, ACT_GELU>(acc, j, slot, ptr, side, a, col0, wrow, lane);
      else if (a.act == ACT_QUICK_GELU)
        epilogue_piece<F32_OUT, EPI, ACT_QUICK_GELU>(acc, j, slot, ptr, side, a, col0, wrow, lane);
      else
        epilogue_piece<F32_OUT, EPI, ACT_NONE>(acc, j, slot, ptr, side, a, col0, wrow, lane);
      // the piece is in its slot: hand it to the storer (async-proxy reads
      // after these generic writes) and go on
      fence_proxy_async();
      named_arrive(2 + s, GEMM_CONSUMERS + 32);
    }
  }
}

// The TMA maps of a product: A and W read in 128- and 256-row boxes, the
// outputs and the side input in 128-row boxes one 128-byte swizzle row wide.
// A map that the variant does not use is a copy of Y's.
struct GemmMaps {
  CUtensorMap A, W, Y, Y2, Side;
};

// Each instantiation is compiled in a translation unit of its own
// (ln_gemm.cu, the units built in parallel): they take most of the build.
// Grid: `blocks` of the caller's plan (ops/block_kernels.py::gemm_plan:
// min(tiles, SMs), one an SM; a product of fewer tiles than SMs runs one tile
// a block).
template <bool F32_OUT, int EPI>
cudaError_t launch_gemm(const GemmMaps& m, const GemmArgs& a, int blocks, cudaStream_t stream) {
  auto kernel = ln_gemm_kernel<F32_OUT, EPI>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, GEMM_SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, GEMM_THREADS, GEMM_SMEM, stream>>>(m.A, m.W, m.Y, m.Y2, m.Side, a);
  return cudaGetLastError();
}

// The five kernels (f32 store, epilogue). ln_gemm.cu instantiates variant
// TVTS_GEMM_PART; every other unit only declares them.
#define TVTS_GEMM_VARIANT_0 false, EPI_PLAIN
#define TVTS_GEMM_VARIANT_1 true, EPI_PLAIN
#define TVTS_GEMM_VARIANT_2 false, EPI_SAVE_PRE
#define TVTS_GEMM_VARIANT_3 false, EPI_ACT_GRAD_BF16
#define TVTS_GEMM_VARIANT_4 false, EPI_ACT_GRAD_F32
#define TVTS_GEMM_LAUNCHER(...) \
  template cudaError_t launch_gemm<__VA_ARGS__>(const GemmMaps&, const GemmArgs&, int, \
                                                cudaStream_t)
#ifndef TVTS_GEMM_PART
extern TVTS_GEMM_LAUNCHER(TVTS_GEMM_VARIANT_0);
extern TVTS_GEMM_LAUNCHER(TVTS_GEMM_VARIANT_1);
extern TVTS_GEMM_LAUNCHER(TVTS_GEMM_VARIANT_2);
extern TVTS_GEMM_LAUNCHER(TVTS_GEMM_VARIANT_3);
extern TVTS_GEMM_LAUNCHER(TVTS_GEMM_VARIANT_4);

// With `ln` (its X, lda, M and K those of `a`): the LayerNorm row pass writes
// LN(X) to ln->Y, which the product then reads as A at row stride K; else the
// product of X. The caller has checked K % GEMM_BK == 0, 16-byte aligned
// pointers and row strides, and a residual only on a bf16 product without a
// second output (ops/block_kernels.py::gemm_plan, ln_rows_plan); a grid
// outside 1..tiles or a tensor map that cannot be made returns
// cudaErrorInvalidValue before any launch.
inline cudaError_t launch_ln_gemm(const GemmArgs& a, const LnRowsArgs* ln, int epi, int blocks,
                                  cudaStream_t stream) {
  const long long tiles =
      (long long)((a.N + GEMM_BN - 1) / GEMM_BN) * ((a.M + GEMM_BM - 1) / GEMM_BM);
  if (blocks < 1 || blocks > tiles) return cudaErrorInvalidValue;
  GemmArgs args = a;
  if (ln) {
    args.X = ln->Y;
    args.lda = a.K;
  }
  GemmMaps m;
  const bool f32 = a.Yf != nullptr;
  bool ok = tile_map(&m.A, args.X, a.M, a.K, args.lda, GEMM_BM) &&
            tile_map(&m.W, a.W, a.N, a.K, a.K, GEMM_BN) &&
            rows_map(&m.Y, f32 ? (const void*)a.Yf : (const void*)a.Y, f32 ? 4 : 2, a.M, a.N,
                     a.ldy, GEMM_BM);
  m.Y2 = m.Side = m.Y;
  if (ok && epi != EPI_PLAIN) ok = rows_map(&m.Y2, a.Y2, 2, a.M, a.N, a.ldy, GEMM_BM);
  if (ok && a.res) ok = rows_map(&m.Side, a.res, 2, a.M, a.N, a.ldres, GEMM_BM);
  if (ok && epi >= EPI_ACT_GRAD_BF16)
    ok = rows_map(&m.Side, a.Hin, epi == EPI_ACT_GRAD_F32 ? 4 : 2, a.M, a.N, a.ldy, GEMM_BM);
  if (!ok) return cudaErrorInvalidValue;
  if (ln) {
    cudaError_t err = launch_ln_rows(*ln, stream);
    if (err != cudaSuccess) return err;
  }
  if (epi == EPI_PLAIN)
    return f32 ? launch_gemm<true, EPI_PLAIN>(m, args, blocks, stream)
               : launch_gemm<false, EPI_PLAIN>(m, args, blocks, stream);
  if (epi == EPI_SAVE_PRE) return launch_gemm<false, EPI_SAVE_PRE>(m, args, blocks, stream);
  if (epi == EPI_ACT_GRAD_BF16)
    return launch_gemm<false, EPI_ACT_GRAD_BF16>(m, args, blocks, stream);
  if (epi == EPI_ACT_GRAD_F32) return launch_gemm<false, EPI_ACT_GRAD_F32>(m, args, blocks, stream);
  return cudaErrorInvalidValue;
}
#endif

}  // namespace tvts
