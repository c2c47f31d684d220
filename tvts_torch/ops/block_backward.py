"""H5, H6 and H8: the differentiable space, time and MLP sub-paths of the
training tower, hand-written in CUDA C++ for Hopper (sources in
tvts_torch/csrc/), each beside its plain PyTorch version; and the backward
chain the attention sub-paths share with the H7 text sub-path
(ops/text_attention.py).

`time_subpath` (H6) replaces tvts_tpu/ops/pallas_block_backward.py::
make_time_subpath (:812): forward fused_time_attention_block_v2 with saves
(pallas_block_attention.py:643), backward fused_time_attention_block_v2_bwd
(:736). `space_subpath` (H5) replaces make_space_subpath_v10 (:3189): forward
fused_space_attention_block_v10 with saves (pallas_block_attention.py:3058),
backward fused_space_attention_block_v10_bwd (:3106). Every space mode of the
JAX package (pallas, pallas_ps, pallas_v2, pallas_v5, pallas_v10, pallas_v10r)
and every time mode (pallas, pallas_tps, pallas_v3) computes the same function
and maps onto these two (ops/kernel_config.py).

Forward (training mode of block_kernels._attention_sub_path): the same launch
chain as H1/H2, keeping qkv [B, S, 3D], the pre-projection attention output
[B, S, D], the per-row log-sum-exp [B, H, S] f32 and the LayerNorm row stats.

Backward chain, all hand-written kernels (csrc/weight_grad.cuh,
csrc/attention_bwd.cuh, csrc/ln_gemm.cuh), for g = dL/d(out):
  dattn = g @ Wproj                       ln_gemm on Wproj^T
  dWproj = g^T attn, dbproj = colsum(g)   wgrad, fixed-order split-M sums
  delta = rowsum(dattn * attn)            per head (the H7 core computes its own)
  dqkv                                    core backward (time / space / text)
  dWqkv = dqkv^T LN(x), dbqkv             wgrad with the LN prologue (recomputed)
  dxln = dqkv @ Wqkv                      ln_gemm on Wqkv^T, f32 out
  dx = [g] + LN_bwd(dxln), dln_w, dln_b   ln_backward: row pass + column sums
Weight and bias gradients are accumulated in f32 and returned in the weight's
dtype (the JAX wrappers' `.astype(wqkv.dtype)`, :3232-3234); the LayerNorm
gradients stay f32. H6 folds the residual (o = x + ..., so dx = g + LN path);
H5's residual is the block input `base`, so it returns dx (LN path only) and
dbase = g. `frozen` (H7 only) stops after dx: no weight-gradient launches.

Bound on the H100: the four products (dattn, dWproj, dWqkv, dxln: 2 * M * D *
(D + D + 3D + 3D) flops over M = B * S rows) on the tensor cores; the cores
and the row passes are a small share at B/16 (see PERF.md). Dispatch as in
block_kernels: the plain version on a CPU tensor, the kernels (bf16) on a CUDA
tensor, or raise. `.launches` counts calls that ran the kernels on the card:
`time_subpath` / `space_subpath` their forwards, `time_subpath_backward` /
`space_subpath_backward` their backwards, `wgrad` each weight-gradient product
(two a sub-path backward that is not frozen), `time_core_backward` each
backward time core (one an H6 backward), `space_core_backward` each one-pass
backward space core (one an H5 backward; `.pair_launches` the flash pair that
takes a group larger than one block) and `ln_backward` each LayerNorm backward
(one every sub-path backward, frozen ones included).

`wgrad` (csrc/weight_grad.cuh) carries every weight gradient of H5-H8 on the
card: ln_gemm's TMA ring and wgmma mainloop over the token rows (both operands
MN-major), the LayerNorm of B applied by a producer warpgroup, colsum(A), and
split-M f32 partials summed in split order; `wgrad_plan` sizes the splits
from the shapes and the SM count alone and checks what the kernel takes.
`time_core_backward` (csrc/attention_bwd.cuh) is H6's core: a block per (b, n,
head group) with the group's q, k, v and dO in shared memory, a thread per
(row, head), in the first version's order of operations (dqkv bit for bit the
same). `space_core_backward` is H5's: a block per (b, t, head) with the
group's q, k, v and dO in shared memory, warps on 16-row slabs in the flash
pair's arithmetic and order (bit for bit the pair, which it keeps for groups
larger than one block). `ln_backward` (csrc/weight_grad.cuh) is the LayerNorm
gradient of every backward: one wave of row blocks, each writing one row of
column partials, then a column-sum kernel; `ln_bwd_plan` sizes it.

`mlp_subpath` (H8) replaces tvts_tpu/ops/pallas_block_attention.py::
make_mlp_subpath (:1066; backward fused_mlp_block_bwd, :1021, which recomputes
the hidden) and pallas_block_backward.py::make_mlp_subpath_v7 (:2690; forward
fused_mlp_block_v7 with save_h, backward fused_mlp_block_v7_bwd, :2637, from
the saved bf16 hidden): one schedule, `save_hidden` choosing between them.
Forward: the H3 chain keeping the LN row stats and, with save_hidden, the
pre-activation hidden h in bf16 (a second output of the first product's
epilogue). Backward, for g = dL/d(out):
  h (f32) = LN(x) Wfc^T + bfc                 ln_gemm, only when not saved
  dh = (g @ Wproj) * act'(h), a = act(h)      ln_gemm on Wproj^T, act' epilogue
  dWproj = g^T a, dbproj = colsum(g)          wgrad
  dWfc = dh^T LN(x), dbfc = colsum(dh)        wgrad with the LN prologue
  dxln = dh @ Wfc                             ln_gemm on Wfc^T, f32 out
  dx = g + LN_bwd(dxln), dln_w, dln_b         ln_bwd + fixed-order sums
Rounding points as on the TPU: LN(x), act(h), dh and g are bf16 at every
product, accumulation f32; act' comes from the bf16 h when it was saved and
from the f32 h when it is recomputed. dbfc sums the bf16 dh (wgrad's column
sum), where the TPU kernel sums dh before rounding: within the gradient band.
Bound on the H100: the products (forward 4 * M * D * 4D flops, backward twice
that plus the recompute). wgrad's f32 split-M partials follow wgrad_plan (3
splits of 9.4 MB each for the B/16 MLP products at B=20).
`mlp_subpath.launches` counts the forwards, `mlp_subpath_backward.launches`
the backwards (`.saved_launches` of each those that wrote or read a saved
hidden).
"""

from __future__ import annotations

import functools

import torch

from tvts_torch.ops import block_kernels as bk
from tvts_torch.utils.profiling import describe, spanned

# ---------------------------------------------------------------------------
# the shared backward chain (CUDA)
# ---------------------------------------------------------------------------
def _sms(t: torch.Tensor) -> int:
    """Streaming multiprocessors of t's card (132 on the H100): sizes the row
    splits of the reductions."""
    return _device_sms(t.device.index if t.device.index is not None
                       else torch.cuda.current_device())


@functools.cache
def _device_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _reduce(lib, partial, P: int, n: int, out: torch.Tensor) -> torch.Tensor:
    """out[i] = sum_p partial[p, i] in a fixed order; out f32 or bf16."""
    f32 = out.dtype == torch.float32
    bk._check(lib, lib.tvts_reduce(bk._ptr(partial), P, n, bk._ptr(out) if f32 else None,
                                   None if f32 else bk._ptr(out), bk._stream(partial)))
    return out


# a block's tile: 128 features of the operand that is wgmma's A (A itself, or
# with the LayerNorm B), 256 of the other, 64 rows a stage (weight_grad.cuh)
WGRAD_TILE = (128, 256, 64)
WGRAD_STAGES = 4
# the split rule's costs, in k steps (one 64-row stage of every block on the
# card): a block's ring fill and epilogue, and the bytes the card moves in one
# k step's time (~0.8 us at ~700 TFLOP/s: 2.5 MB at 3.35 TB/s), which prices
# the f32 partials (written once, read once by the reduction)
WGRAD_BLOCK_STEPS = 12
WGRAD_STEP_BYTES = 2.5e6


@functools.lru_cache(maxsize=None)
def _wgrad_splits(M: int, outputs: int, tiles: int, sms: int) -> tuple[int, int]:
    """(splits, rows a split) of wgrad_plan's rule for M rows, an output of
    `outputs` elements in `tiles` tiles, on `sms` SMs."""
    BK = WGRAD_TILE[2]
    best = None
    for s in range(1, min(-(-M // BK), 64) + 1):
        rows = -(-(-(-M // s)) // BK) * BK
        if -(-M // rows) != s:  # no other split count gives these rows
            continue
        cost = (-(-tiles * s // sms) * (rows // BK + WGRAD_BLOCK_STEPS)
                + 8 * s * outputs / WGRAD_STEP_BYTES)
        if best is None or cost < best[0]:
            best = (cost, s, rows)
    return best[1], best[2]


def wgrad_plan(M: int, N1: int, N2: int, lda: int, ldb: int, sms: int, ln: bool = False,
               pointers: dict[str, int] | None = None) -> dict:
    """The launch of wgrad for C [N1, N2] = A [M, N1 at row stride lda]^T B [M,
    N2 at row stride ldb], B normalised when `ln`: the tile grid (256-wide
    tiles, 128-wide tiles, splits; without the LayerNorm 128 of N1 by 256 of
    N2, with it 256 of N1 by 128 of N2), the splits and the rows a split (a
    multiple of the 64-row stage; the last split takes the rest), the rows of
    the column-sum partials (splits times the tiles of B), the TMA boxes (64
    columns by 64 rows of A and of B), the k steps of a full split, the threads
    and the shared memory of a block. The split count depends on the shapes
    and `sms` (the card's SM count) only, so the sum order is fixed: it
    minimises waves * (k steps a block + WGRAD_BLOCK_STEPS) + the partials'
    bytes (8 * splits * N1 * N2) / WGRAD_STEP_BYTES. Raises
    ValueError, naming the argument, on what the kernel does not take: an empty
    product, N1 or N2 not a multiple of 8, a row stride shorter than its row or
    not a multiple of 16 bytes, a base address (`pointers`: name -> address)
    that is not 16-byte aligned."""
    BM, BN, BK = WGRAD_TILE
    if M < 1:
        raise ValueError(f"M = {M}: wgrad takes at least one row")
    for name, n in (("N1", N1), ("N2", N2)):
        if n < 8 or n % 8:
            raise ValueError(f"{name} = {n}: wgrad takes a multiple of 8")
    for name, ld, n in (("lda", lda, N1), ("ldb", ldb, N2)):
        if ld < n:
            raise ValueError(f"{name} = {ld} is shorter than the row it strides ({n})")
        if ld * 2 % 16:
            raise ValueError(f"{name} = {ld} elements ({ld * 2} bytes): wgrad takes row strides "
                             f"of a multiple of 16 bytes")
    for name, ptr in (pointers or {}).items():
        if ptr is not None and ptr % 16:
            raise ValueError(f"{name} at {ptr:#x} is not 16-byte aligned")
    grid = (-(-N1 // BN), -(-N2 // BM)) if ln else (-(-N2 // BN), -(-N1 // BM))
    splits, rows = _wgrad_splits(M, N1 * N2, grid[0] * grid[1], sms)
    return dict(grid=(*grid, splits), splits=splits, rows_per_split=rows,
                colsum_parts=splits * (grid[1] if ln else grid[0]), box_a=(64, BK),
                box_b=(64, BK), k_steps=rows // BK, threads=384 if ln else 288,
                smem=WGRAD_STAGES * 6 * 64 * BK * 2 + 1024 + 24 * WGRAD_STAGES + 4 * 1024)


def _wgrad(lib, a, b, stats=None, ln=None, dtype=torch.bfloat16):
    """(a^T b [N1, N2], colsum(a) [N1]) over the rows of a [M, N1], b [M, N2],
    with b -> LN(b) from `stats` and `ln` = (w, bias) when given; accumulated
    in f32, returned in `dtype`, on the card (weight_grad.cuh). The rows are
    split as wgrad_plan says; each split's f32 partial is summed in split
    order, so the result does not vary run to run."""
    M, N1 = a.shape
    N2 = b.shape[1]
    ln_w, ln_b = ln if ln else (None, None)
    plan = wgrad_plan(M, N1, N2, a.stride(0), b.stride(0), _sms(a), ln is not None,
                      {"a": bk._ptr(a), "b": bk._ptr(b), "stats": bk._ptr(stats),
                       "ln_w": bk._ptr(ln_w), "ln_b": bk._ptr(ln_b)})
    splits, parts = plan["splits"], plan["colsum_parts"]
    f32 = dict(dtype=torch.float32, device=a.device)
    partial = torch.empty(splits, N1, N2, **f32)
    colsum = torch.empty(parts, N1, **f32)
    bk._check(lib, lib.tvts_wgrad(bk._ptr(a), a.stride(0), bk._ptr(b), b.stride(0),
                                  bk._ptr(stats), bk._ptr(ln_w), bk._ptr(ln_b),
                                  bk._ptr(partial), bk._ptr(colsum), M, N1, N2, splits,
                                  plan["rows_per_split"], bk._stream(a)))
    wgrad.launches += 1
    dw = _reduce(lib, partial, splits, N1 * N2, torch.empty(N1, N2, dtype=dtype, device=a.device))
    db = _reduce(lib, colsum, parts, N1, torch.empty(N1, dtype=dtype, device=a.device))
    return dw, db


def wgrad_plain(a, b, stats=None, ln=None, dtype=None):
    """wgrad in f32 from the same operands: b -> LN(b) from the row `stats`
    [M, 2] (mean, rstd) and `ln` = (w, bias), rounded to b's dtype as the
    kernel (and the forward's product) rounds it: t = (b - mean) * rstd in
    f32, then t * w + bias in one rounding (the kernels' fused multiply-add,
    exact in f64 before the one rounding to f32); returns (a^T b, colsum(a))
    in `dtype` (a's by default)."""
    bf = b.float()
    if ln is not None:
        st = stats.float()
        t = (bf - st[:, :1]) * st[:, 1:]
        bf = (t.double() * ln[0].double() + ln[1].double()).float().to(b.dtype).float()
    dtype = dtype or a.dtype
    return (a.float().t() @ bf).to(dtype), a.float().sum(0).to(dtype)


def wgrad(a, b, stats=None, ln=None, dtype=None):
    """The weight gradient of a product (module notes): (a^T LN?(b), colsum(a))
    over the rows of a [M, N1] and b [M, N2], in `dtype` (a's by default). On
    a CPU tensor wgrad_plain; on a CUDA tensor the kernel (bf16 a and b)."""
    if not bk._dispatch(a):
        return wgrad_plain(a, b, stats, ln, dtype)
    M, N1 = a.shape
    bk._expect("a", a, a, torch.bfloat16, (M, N1))
    bk._expect("b", b, a, torch.bfloat16, (M, b.shape[1]))
    if ln is not None:
        bk._expect("stats", stats, a, torch.float32, (M, 2))
    with torch.cuda.device(a.device):
        return _wgrad(bk.library(), a, b, stats, ln, dtype or a.dtype)


LN_BWD_WARPS = 8  # warps of a LayerNorm-backward block (csrc/weight_grad.cuh)
LN_BWD_MAX_K = 1280  # the widest row it takes: 5 chunks of 256 columns a lane row


def ln_bwd_plan(M: int, K: int, sms: int, pointers: dict[str, int] | None = None) -> dict:
    """The launch of the LayerNorm backward over M rows of width K on `sms`
    SMs: one wave of one block of LN_BWD_WARPS warps an SM (one block per
    LN_BWD_WARPS rows when M is smaller); of the W warps, warp w takes the
    rows [w * M // W, (w + 1) * M // W), so every warp's count of rows is the
    same to one (`rows_per_warp`: the least and the most); each block writes
    one row of column partials (so at most sms partial rows), then the column
    sums (blocks of 32 columns, 2 sums). The shapes and `sms` alone decide
    it, so the sum order is fixed.
    Raises ValueError, naming the argument, on what the kernel does not take:
    no rows, K not a multiple of 8 or over LN_BWD_MAX_K, a base address
    (`pointers`: name -> address) that is not 16-byte aligned."""
    if M < 1:
        raise ValueError(f"M = {M}: the LayerNorm backward takes at least one row")
    if K < 8 or K % 8:
        raise ValueError(f"K = {K}: the LayerNorm backward takes a multiple of 8")
    if K > LN_BWD_MAX_K:
        raise ValueError(f"K = {K}: the LayerNorm backward takes at most {LN_BWD_MAX_K} columns")
    for name, ptr in (pointers or {}).items():
        if ptr is not None and ptr % 16:
            raise ValueError(f"{name} at {ptr:#x} is not 16-byte aligned")
    blocks = min(sms, -(-M // LN_BWD_WARPS))
    warps = blocks * LN_BWD_WARPS
    return dict(blocks=blocks, warps=warps, rows_per_warp=(M // warps, -(-M // warps)),
                partial_rows=blocks, chunks=-(-K // 256),
                threads=32 * LN_BWD_WARPS, smem=2 * LN_BWD_WARPS * K * 4,
                colsum_grid=(-(-K // 32), 2))


def _ln_backward(lib, x2d, stats, dxln, ln_w, res, weight_grads: bool):
    """(dx = res + LN_bwd(dxln) [M, K] bf16, dln_w, dln_b f32 or None) on the
    card: the row pass and, with weight_grads, the column sums
    (csrc/weight_grad.cuh), as ln_bwd_plan sizes them."""
    M, K = x2d.shape
    plan = ln_bwd_plan(M, K, _sms(x2d), {"x": bk._ptr(x2d), "dxln": bk._ptr(dxln),
                                         "ln_w": bk._ptr(ln_w), "res": bk._ptr(res)})
    dx = torch.empty_like(x2d)
    f32 = dict(dtype=torch.float32, device=x2d.device)
    part = dln_w = dln_b = None
    if weight_grads:
        part = torch.empty(2, plan["blocks"], K, **f32)
        dln_w, dln_b = torch.empty(K, **f32), torch.empty(K, **f32)
    bk._check(lib, lib.tvts_ln_bwd(
        bk._ptr(x2d), bk._ptr(stats), bk._ptr(dxln), bk._ptr(ln_w), bk._ptr(res), bk._ptr(dx),
        bk._ptr(part), bk._ptr(dln_w), bk._ptr(dln_b), M, K, plan["blocks"], bk._stream(x2d)))
    ln_backward.launches += 1
    return dx, dln_w, dln_b


def ln_backward_plain(x, stats, dxln, ln_w, res=None, weight_grads: bool = True):
    """The LayerNorm backward in f32 (tvts_tpu/ops/pallas_block_backward.py::
    _ln_bwd plus the column sums): xhat = (x - mean) * rstd from the row
    `stats` [M, 2], dxhat = dxln * w, dx = res + (dxhat - mean(dxhat) - xhat *
    mean(dxhat * xhat)) * rstd rounded to x's dtype, dln_w = sum_rows dxln *
    xhat, dln_b = sum_rows dxln (f32; None without weight_grads)."""
    st = stats.float()
    xhat = (x.float() - st[:, :1]) * st[:, 1:]
    g = dxln.float()
    dxhat = g * ln_w.float()
    m1 = dxhat.mean(-1, keepdim=True)
    m2 = (dxhat * xhat).mean(-1, keepdim=True)
    dx = (dxhat - m1 - xhat * m2) * st[:, 1:]
    if res is not None:
        dx = dx + res.float()
    if not weight_grads:
        return dx.to(x.dtype), None, None
    return dx.to(x.dtype), (g * xhat).sum(0), g.sum(0)


def ln_backward(x, stats, dxln, ln_w, res=None, weight_grads: bool = True):
    """The LayerNorm backward of H5-H8 alone, over the rows of x [M, K]: (dx
    [M, K] in x's dtype, dln_w [K], dln_b [K] f32, or None for both without
    weight_grads, the frozen backward). stats: the forward's row (mean, rstd)
    [M, 2] f32; dxln: dL/dLN(x) [M, K] f32; ln_w [K] f32; res: a residual
    gradient added to dx. On a CPU tensor ln_backward_plain; on a CUDA tensor
    the kernels (bf16 x and res)."""
    if not bk._dispatch(x):
        return ln_backward_plain(x, stats, dxln, ln_w, res, weight_grads)
    M, K = x.shape
    bk._expect("x", x, x, torch.bfloat16, (M, K))
    bk._expect("stats", stats, x, torch.float32, (M, 2))
    bk._expect("dxln", dxln, x, torch.float32, (M, K))
    bk._expect("ln_w", ln_w, x, torch.float32, (K,))
    if res is not None:
        bk._expect("res", res, x, torch.bfloat16, (M, K))
    with torch.cuda.device(x.device):
        return _ln_backward(bk.library(), x, stats, dxln, ln_w, res, weight_grads)


def attention_backward(core: str, g, x, saves, ln_w, ln_b, wqkv, wproj, num_heads: int, *,
                       residual: bool, num_frames: int = 1, causal: bool = False,
                       frozen: bool = False):
    """The backward chain of an attention sub-path on the card (module notes).
    core: "time" (H6), "space" (H5) or "text" (H7). saves: (qkv, attn, lse,
    stats) of the training forward. Returns (dx, dln_w, dln_b, dwqkv, dbqkv,
    dwproj, dbproj); with `frozen` every gradient but dx is None."""
    qkv, attn, lse, stats = saves
    B, S, D = x.shape
    M, d = B * S, D // num_heads
    bk._expect("g", g, x, x.dtype, (B, S, D))
    lib = bk.library()
    stream = bk._stream(x)
    with torch.cuda.device(x.device):
        g2 = g.view(M, D)
        dattn = torch.empty(M, D, dtype=x.dtype, device=x.device)
        bk._ln_gemm(lib, g2, M, D, None, wproj.t().contiguous(), None, dattn)
        if not frozen:
            dwproj, dbproj = _wgrad(lib, g2, attn.view(M, D), dtype=wproj.dtype)
        if core == "text":  # the H7 core computes its own delta
            from tvts_torch.ops.text_attention import _text_core_backward  # imports this module

            dqkv = _text_core_backward(lib, qkv, attn, lse, dattn, num_heads, causal)
        else:
            delta = torch.empty(B, num_heads, S, dtype=torch.float32, device=x.device)
            bk._check(lib, lib.tvts_attn_delta(bk._ptr(dattn), bk._ptr(attn), B, S, num_heads,
                                               d, bk._ptr(delta), stream))
            core_backward = _time_core_backward if core == "time" else _space_core_backward
            dqkv, _ = core_backward(lib, qkv, dattn, lse, delta, num_frames, num_heads)
        dqkv2 = dqkv.view(M, 3 * D)
        x2 = x.view(M, D)
        if not frozen:
            dwqkv, dbqkv = _wgrad(lib, dqkv2, x2, stats=stats, ln=(ln_w, ln_b),
                                  dtype=wqkv.dtype)
        dxln = torch.empty(M, D, dtype=torch.float32, device=x.device)
        bk._ln_gemm(lib, dqkv2, M, 3 * D, None, wqkv.t().contiguous(), None, dxln)
        dx, dln_w, dln_b = _ln_backward(lib, x2, stats, dxln, ln_w, g2 if residual else None,
                                        weight_grads=not frozen)
    dx = dx.view(B, S, D)
    if frozen:
        return dx, None, None, None, None, None, None
    return dx, dln_w, dln_b, dwqkv, dbqkv, dwproj, dbproj


def vjp(fn, g, inputs, wrt=None):
    """torch.autograd.grad of fn(*inputs) against `g`, for the inputs indexed
    by `wrt` (all by default). With a plain forward this is the plain backward
    of a sub-path; with a kernel's autograd Function, its backward kernels."""
    wrt = range(len(inputs)) if wrt is None else wrt
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(i in wrt) for i, t in enumerate(inputs)]
        out = fn(*leaves)
        return torch.autograd.grad(out, [leaves[i] for i in wrt], g)


# ---------------------------------------------------------------------------
# H6: time sub-path (training)
# ---------------------------------------------------------------------------
def time_core_plain(qkv, num_frames, num_heads):
    """Every row of the time attention on packed rows qkv [B, S, 3D] (q not
    pre-scaled), in f32: patch (t, n) over the CLS key and location n in every
    frame, the CLS query over every token. -> (out [B, S, D], lse [B, H, S])."""
    B, S, D3 = qkv.shape
    T, H = num_frames, num_heads
    N = bk._patches_per_frame(S, T)
    d = D3 // 3 // H
    q, k, v = (t.float().reshape(B, S, H, d).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
    q = q * d ** -0.5
    qp, kp, vp = (t[:, :, 1:].reshape(B, H, T, N, d).transpose(2, 3) for t in (q, k, v))
    keys = torch.cat([k[:, :, None, :1].expand(B, H, N, 1, d), kp], dim=3)  # [B, H, N, 1+T, d]
    vals = torch.cat([v[:, :, None, :1].expand(B, H, N, 1, d), vp], dim=3)
    logits = qp @ keys.transpose(-1, -2)  # [B, H, N, T, 1 + T]
    out_p = (torch.softmax(logits, -1) @ vals).transpose(2, 3).reshape(B, H, T * N, d)
    cls_logits = q[:, :, :1] @ k.transpose(-1, -2)  # [B, H, 1, S]
    out_c = torch.softmax(cls_logits, -1) @ v
    out = torch.cat([out_c, out_p], dim=2).transpose(1, 2).reshape(B, S, H * d)
    lse = torch.cat([torch.logsumexp(cls_logits, -1),
                     torch.logsumexp(logits, -1).transpose(2, 3).reshape(B, H, T * N)], dim=2)
    return out, lse


def divided_core_backward_plain(qkv, dO, lse, delta, num_frames, num_heads, mode: str):
    """dqkv [B, S, 3D] (f32) of a divided attention core on packed rows qkv
    [B, S, 3D] (q not pre-scaled) against dO [B, S, D], by the delta identity
    the kernels use, from the forward's lse [B, H, S] and delta = rowsum(dO *
    O) per head [B, H, S]: P = exp(scale q.k - lse), dS = P * (dO.v - delta),
    dq = scale dS k, dk = scale dS^T q, dv = P^T dO, the patch rows within
    their groups (mode "time": the CLS token and location n in every frame;
    "space": the CLS token and frame t's patches) and the CLS row over every
    token."""
    B, S, D3 = qkv.shape
    T, H = num_frames, num_heads
    N = bk._patches_per_frame(S, T)
    d = D3 // 3 // H
    scale = d ** -0.5
    q, k, v = (t.float().reshape(B, S, H, d).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
    o = dO.float().reshape(B, S, H, d).transpose(1, 2)
    lse, delta = lse.float(), delta.float()
    G = N if mode == "time" else T  # groups a (clip, head)

    def groups(t):  # [B, H, S, ...] patch rows -> [B, H, G, elements, ...]
        t = t[:, :, 1:].reshape(B, H, T, N, *t.shape[3:])
        return t.transpose(2, 3) if mode == "time" else t

    def ungroup(t):  # [B, H, G, elements, ...] -> [B, H, T * N, ...]
        t = t.transpose(2, 3) if mode == "time" else t
        return t.reshape(B, H, T * N, *t.shape[4:])

    qp, kp, vp, op = (groups(t) for t in (q, k, v, o))
    keys = torch.cat([k[:, :, None, :1].expand(B, H, G, 1, d), kp], dim=3)  # [B, H, G, 1+, d]
    vals = torch.cat([v[:, :, None, :1].expand(B, H, G, 1, d), vp], dim=3)
    p = torch.exp(scale * (qp @ keys.transpose(-1, -2)) - groups(lse)[..., None])
    ds = p * (op @ vals.transpose(-1, -2) - groups(delta)[..., None])
    dq_p = scale * (ds @ keys)
    dkeys = scale * (ds.transpose(-1, -2) @ qp)  # [B, H, G, 1+, d]
    dvals = p.transpose(-1, -2) @ op
    p0 = torch.exp(scale * (q[:, :, :1] @ k.transpose(-1, -2)) - lse[:, :, :1, None])
    ds0 = p0 * (o[:, :, :1] @ v.transpose(-1, -2) - delta[:, :, :1, None])  # [B, H, 1, S]
    dq = torch.cat([scale * (ds0 @ k), ungroup(dq_p)], dim=2)
    dk = scale * (ds0.transpose(-1, -2) @ q[:, :, :1])
    dv = p0.transpose(-1, -2) @ o[:, :, :1]
    dk = dk + torch.cat([dkeys[:, :, :, :1].sum(2), ungroup(dkeys[:, :, :, 1:])], dim=2)
    dv = dv + torch.cat([dvals[:, :, :, :1].sum(2), ungroup(dvals[:, :, :, 1:])], dim=2)
    return torch.cat([t.transpose(1, 2).reshape(B, S, H * d) for t in (dq, dk, dv)], dim=-1)


def time_core_backward_plain(qkv, dO, lse, delta, num_frames, num_heads):
    """dqkv [B, S, 3D] (f32) of time_core_plain's output against dO [B, S, D]
    (divided_core_backward_plain over the time groups)."""
    return divided_core_backward_plain(qkv, dO, lse, delta, num_frames, num_heads, "time")


TIME_BWD_THREADS = 128  # a block's threads at most (csrc/attention_bwd.cuh)


def time_bwd_heads(T: int, H: int) -> int:
    """Heads a backward time-core block takes (csrc/attention_bwd.cuh): at
    most TIME_BWD_THREADS / (T + 1), the H heads split as evenly as that
    allows."""
    cap = max(1, TIME_BWD_THREADS // (T + 1))
    groups = -(-H // cap)
    return -(-H // groups)


def time_bwd_smem(T: int, heads: int, d: int) -> int:
    """Shared memory of a backward time-core block: q, k, v and dO of the
    T + 1 elements in bf16 (rows padded by 16 bytes), P and dS in f32, and the
    lse and delta."""
    G = T + 1
    return 4 * G * (heads * d + 8) * 2 + 2 * heads * G * (G | 1) * 4 + 2 * heads * G * 4


def _check_time_bwd(T: int, H: int, d: int) -> None:
    """Raise ValueError on a time group the backward core does not take."""
    if not 1 <= T <= 32:
        raise ValueError(f"{T} frames: the backward time core takes 1..32")
    if d not in (64, 80):
        raise ValueError(f"head dim {d}: the backward time core takes 64 or 80")
    smem = time_bwd_smem(T, time_bwd_heads(T, H), d)
    if smem > bk.SMEM_OPTIN:
        raise ValueError(f"{T} frames of {H} heads of dim {d}: a backward time-core block "
                         f"needs {smem} bytes of shared memory, more than the "
                         f"{bk.SMEM_OPTIN} a block may take")


def _time_core_backward(lib, qkv, dO, lse, delta, num_frames, num_heads):
    """The backward time core on the card (csrc/attention_bwd.cuh), then the
    fixed-order combine of the CLS token's partials into row 0. -> (dqkv
    [B, S, 3D] bf16, the groups' CLS partials [B, N, H, 3, d] f32)."""
    B, S, D3 = qkv.shape
    T, H = num_frames, num_heads
    N = bk._patches_per_frame(S, T)
    d = D3 // 3 // H
    _check_time_bwd(T, H, d)
    dqkv = torch.empty_like(qkv)
    partial = torch.empty(B, N, H, 3, d, dtype=torch.float32, device=qkv.device)
    stream = bk._stream(qkv)
    bk._check(lib, lib.tvts_time_bwd(bk._ptr(qkv), bk._ptr(dO), bk._ptr(lse), bk._ptr(delta),
                                     bk._ptr(dqkv), bk._ptr(partial), B, T, N, H, d, d ** -0.5,
                                     stream))
    time_core_backward.launches += 1
    bk._check(lib, lib.tvts_cls_grad_combine(bk._ptr(partial), N, B, H, d, S, bk._ptr(dqkv),
                                             stream))
    return dqkv, partial


def time_core_backward(qkv, dO, lse, delta, num_frames: int, num_heads: int) -> torch.Tensor:
    """H6's time-core backward alone: dqkv [B, S, 3D] of the time attention
    from the saved qkv [B, S, 3D] (q not pre-scaled), dO [B, S, D], the
    forward's lse [B, H, S] and delta = rowsum(dO * O) per head [B, H, S]. On a
    CPU tensor time_core_backward_plain rounded to qkv's dtype; on a CUDA
    tensor the kernel and the CLS combine (bf16)."""
    if not bk._dispatch(qkv):
        return time_core_backward_plain(qkv, dO, lse, delta, num_frames,
                                        num_heads).to(qkv.dtype)
    B, S, D3 = qkv.shape
    H = num_heads
    bk._expect("qkv", qkv, qkv, torch.bfloat16, (B, S, D3))
    bk._expect("dO", dO, qkv, torch.bfloat16, (B, S, D3 // 3))
    bk._expect("lse", lse, qkv, torch.float32, (B, H, S))
    bk._expect("delta", delta, qkv, torch.float32, (B, H, S))
    with torch.cuda.device(qkv.device):
        return _time_core_backward(bk.library(), qkv, dO, lse, delta, num_frames, H)[0]


def time_subpath_backward_plain(g, x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, num_frames,
                                num_heads):
    """(dx, dln_w, dln_b, dwqkv, dbqkv, dwproj, dbproj) of time_block_plain."""
    return vjp(lambda *a: bk.time_block_plain(*a, num_frames, num_heads), g,
                     (x, ln_w, ln_b, wqkv, bqkv, wproj, bproj))


def time_subpath_backward(g, x, saves, ln_w, ln_b, wqkv, wproj, num_frames, num_heads):
    """H6 backward on the card (module notes)."""
    grads = attention_backward("time", g, x, saves, ln_w, ln_b, wqkv, wproj, num_heads,
                               residual=True, num_frames=num_frames)
    time_subpath_backward.launches += 1
    return grads


def _geometry(ctx, g) -> dict:
    """The span geometry of an attention sub-path's backward (utils/profiling)."""
    T, H = ctx.geometry
    return describe(g, num_frames=T, num_heads=H)


class _TimeSubpath(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, num_frames, num_heads):
        ctx.geometry = (num_frames, num_heads)
        weights = (ln_w, ln_b, wqkv, bqkv, wproj, bproj)
        if not bk._dispatch(x):
            ctx.save_for_backward(x, *weights)
            return bk.time_block_plain(x, *weights, num_frames, num_heads)
        out, *saves = bk._attention_sub_path("tvts_time_core", x, x, *weights, num_frames,
                                             num_heads, save=True)
        time_subpath.launches += 1
        ctx.save_for_backward(x, *weights, *saves)
        return out

    @staticmethod
    @spanned("_TimeSubpath.backward", _geometry)
    def backward(ctx, g):
        T, H = ctx.geometry
        x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, *saves = ctx.saved_tensors
        if saves:
            grads = time_subpath_backward(g.contiguous(), x, saves, ln_w, ln_b, wqkv, wproj, T, H)
        else:
            grads = time_subpath_backward_plain(g, x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, T, H)
        return (*grads, None, None)


@spanned("time_subpath")
def time_subpath(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, num_frames: int,
                 num_heads: int) -> torch.Tensor:
    """H6 (differentiable). x: [B, S, D] -> x + Proj(TimeAttn(LN_3(x)))."""
    return _TimeSubpath.apply(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, num_frames, num_heads)


# ---------------------------------------------------------------------------
# H5: space sub-path (training)
# ---------------------------------------------------------------------------
def space_core_backward_plain(qkv, dO, lse, delta, num_frames, num_heads):
    """dqkv [B, S, 3D] (f32) of block_kernels.space_core_plain's output against
    dO [B, S, D] (divided_core_backward_plain over the space groups)."""
    return divided_core_backward_plain(qkv, dO, lse, delta, num_frames, num_heads, "space")


def space_bwd_smem(N: int, d: int) -> int:
    """Shared memory of a one-pass backward space-core block
    (csrc/attention_bwd.cuh): q, k, v and dO of the group's N + 1 elements in
    bf16, rows padded to a multiple of 16 and to d + 8 columns, then the lse
    and delta."""
    rows = -(-(N + 1) // 16) * 16
    return 4 * rows * (d + 8) * 2 + 2 * rows * 4


def _check_space_bwd(T: int, N: int, H: int, d: int) -> bool:
    """Raise ValueError on a space group that neither backward core takes;
    True when the group fits one block of the one-pass kernel, False when it
    takes the flash pair. The library's tvts_space_bwd_one_block is the rule
    the card dispatches on (the rule its launch refuses by); this is its copy
    for planning on any device, held equal to it on the card."""
    if T < 1 or N < 1 or H < 1:
        raise ValueError(f"{T} frames of {N} patches, {H} heads: the backward space core "
                         f"takes at least one of each")
    if d not in (64, 80):
        raise ValueError(f"head dim {d}: the backward space core takes 64 or 80")
    return space_bwd_smem(N, d) <= bk.SMEM_OPTIN


def _space_core_backward(lib, qkv, dO, lse, delta, num_frames, num_heads):
    """The backward space core on the card (csrc/attention_bwd.cuh): the
    one-pass kernel when a group fits one block, else the flash pair; then
    the fixed-order combine of the CLS token's partials into row 0. -> (dqkv
    [B, S, 3D] bf16, the frames' CLS partials [B, T, H, 3, d] f32)."""
    B, S, D3 = qkv.shape
    T, H = num_frames, num_heads
    N = bk._patches_per_frame(S, T)
    d = D3 // 3 // H
    _check_space_bwd(T, N, H, d)
    one_block = bool(lib.tvts_space_bwd_one_block(N, d))  # decided before any launch
    dqkv = torch.empty_like(qkv)
    partial = torch.empty(B, T, H, 3, d, dtype=torch.float32, device=qkv.device)
    stream = bk._stream(qkv)
    args = (bk._ptr(qkv), bk._ptr(dO), bk._ptr(lse), bk._ptr(delta), bk._ptr(dqkv),
            bk._ptr(partial))
    if one_block:
        bk._check(lib, lib.tvts_space_bwd(*args, B, T, N, H, d, d ** -0.5, stream))
        space_core_backward.launches += 1
    else:
        bk._check(lib, lib.tvts_flash_bwd(*args, B, T, N, S, H, d, d ** -0.5, stream))
        space_core_backward.pair_launches += 1
    bk._check(lib, lib.tvts_cls_grad_combine(bk._ptr(partial), T, B, H, d, S, bk._ptr(dqkv),
                                             stream))
    return dqkv, partial


def space_core_backward(qkv, dO, lse, delta, num_frames: int, num_heads: int) -> torch.Tensor:
    """H5's space-core backward alone: dqkv [B, S, 3D] of the space attention
    from the saved qkv [B, S, 3D] (q not pre-scaled), dO [B, S, D], the
    forward's lse [B, H, S] and delta = rowsum(dO * O) per head [B, H, S]. On a
    CPU tensor space_core_backward_plain rounded to qkv's dtype; on a CUDA
    tensor the kernel (the flash pair for a group larger than one block) and
    the CLS combine (bf16)."""
    if not bk._dispatch(qkv):
        return space_core_backward_plain(qkv, dO, lse, delta, num_frames,
                                         num_heads).to(qkv.dtype)
    B, S, D3 = qkv.shape
    H = num_heads
    bk._expect("qkv", qkv, qkv, torch.bfloat16, (B, S, D3))
    bk._expect("dO", dO, qkv, torch.bfloat16, (B, S, D3 // 3))
    bk._expect("lse", lse, qkv, torch.float32, (B, H, S))
    bk._expect("delta", delta, qkv, torch.float32, (B, H, S))
    with torch.cuda.device(qkv.device):
        return _space_core_backward(bk.library(), qkv, dO, lse, delta, num_frames, H)[0]


def space_subpath_backward_plain(g, x, base, ln_w, ln_b, wqkv, bqkv, wproj, bproj,
                                 num_frames, num_heads):
    """(dx, dbase, dln_w, dln_b, dwqkv, dbqkv, dwproj, dbproj) of space_block_plain."""
    return vjp(lambda *a: bk.space_block_plain(*a, num_frames, num_heads), g,
                     (x, base, ln_w, ln_b, wqkv, bqkv, wproj, bproj))


def space_subpath_backward(g, x, saves, ln_w, ln_b, wqkv, wproj, num_frames, num_heads):
    """H5 backward on the card (module notes); dbase = g."""
    dx, *rest = attention_backward("space", g, x, saves, ln_w, ln_b, wqkv, wproj, num_heads,
                                   residual=False, num_frames=num_frames)
    space_subpath_backward.launches += 1
    return (dx, g, *rest)


class _SpaceSubpath(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, base, ln_w, ln_b, wqkv, bqkv, wproj, bproj, num_frames, num_heads):
        ctx.geometry = (num_frames, num_heads)
        weights = (ln_w, ln_b, wqkv, bqkv, wproj, bproj)
        if not bk._dispatch(x):
            ctx.save_for_backward(x, base, *weights)
            return bk.space_block_plain(x, base, *weights, num_frames, num_heads)
        out, *saves = bk._attention_sub_path("tvts_space_core", x, base, *weights, num_frames,
                                             num_heads, save=True)
        space_subpath.launches += 1
        ctx.save_for_backward(x, base, *weights, *saves)
        return out

    @staticmethod
    @spanned("_SpaceSubpath.backward", _geometry)
    def backward(ctx, g):
        T, H = ctx.geometry
        x, base, ln_w, ln_b, wqkv, bqkv, wproj, bproj, *saves = ctx.saved_tensors
        if saves:
            grads = space_subpath_backward(g.contiguous(), x, saves, ln_w, ln_b, wqkv, wproj,
                                           T, H)
        else:
            grads = space_subpath_backward_plain(g, x, base, ln_w, ln_b, wqkv, bqkv, wproj,
                                                 bproj, T, H)
        return (*grads, None, None)


@spanned("space_subpath")
def space_subpath(x, base, ln_w, ln_b, wqkv, bqkv, wproj, bproj, num_frames: int,
                  num_heads: int) -> torch.Tensor:
    """H5 (differentiable). x (time output), base (block input): [B, S, D] ->
    base + Proj(SpaceAttn(LN_1(x)))."""
    return _SpaceSubpath.apply(x, base, ln_w, ln_b, wqkv, bqkv, wproj, bproj, num_frames,
                               num_heads)


# ---------------------------------------------------------------------------
# H8: MLP sub-path (training)
# ---------------------------------------------------------------------------
def mlp_subpath_backward_plain(g, x, ln_w, ln_b, wfc, bfc, wproj, bproj, act="quick_gelu"):
    """(dx, dln_w, dln_b, dwfc, dbfc, dwproj, dbproj) of mlp_block_plain."""
    return vjp(lambda *a: bk.mlp_block_plain(*a, act), g,
               (x, ln_w, ln_b, wfc, bfc, wproj, bproj))


def mlp_subpath_backward(g, x, stats, h, ln_w, ln_b, wfc, bfc, wproj, act="quick_gelu"):
    """H8 backward on the card (module notes). stats: the forward's LN row
    stats; h: the saved pre-activation hidden [B, S, 4D] bf16, or None to
    recompute it (in f32). Returns (dx, dln_w, dln_b, dwfc, dbfc, dwproj,
    dbproj)."""
    B, S, D = x.shape
    M, hidden = B * S, wfc.shape[0]
    bk._expect("g", g, x, x.dtype, (B, S, D))
    lib = bk.library()
    with torch.cuda.device(x.device):
        g2, x2 = g.view(M, D), x.view(M, D)
        saved = h is not None
        if not saved:
            h = torch.empty(M, hidden, dtype=torch.float32, device=x.device)
            bk._ln_gemm(lib, x2, M, D, (ln_w, ln_b), wfc, bfc, h)
        dh = torch.empty(M, hidden, dtype=x.dtype, device=x.device)
        a = torch.empty_like(dh)
        bk._ln_gemm(lib, g2, M, D, None, wproj.t().contiguous(), None, dh, act=act,
                    hidden=h.view(M, hidden), act_out=a)
        del h
        dwproj, dbproj = _wgrad(lib, g2, a, dtype=wproj.dtype)
        del a
        dwfc, dbfc = _wgrad(lib, dh, x2, stats=stats, ln=(ln_w, ln_b), dtype=wfc.dtype)
        dxln = torch.empty(M, D, dtype=torch.float32, device=x.device)
        bk._ln_gemm(lib, dh, M, hidden, None, wfc.t().contiguous(), None, dxln)
        dx, dln_w, dln_b = _ln_backward(lib, x2, stats, dxln, ln_w, g2, weight_grads=True)
    mlp_subpath_backward.launches += 1
    mlp_subpath_backward.saved_launches += saved
    return dx.view(B, S, D), dln_w, dln_b, dwfc, dbfc, dwproj, dbproj


def _mlp_geometry(ctx, g) -> dict:
    """The span geometry of H8's backward: the hidden width, and whether the
    forward saved the hidden activation (else the backward recomputes it)."""
    saved = ctx.saved_tensors
    return describe(g, act=ctx.act, hidden=saved[3].shape[0], save_hidden=len(saved) > 8)


class _MlpSubpath(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_w, ln_b, wfc, bfc, wproj, bproj, act, save_hidden):
        ctx.act = act
        weights = (ln_w, ln_b, wfc, bfc, wproj, bproj)
        if not bk._dispatch(x):
            ctx.save_for_backward(x, *weights)
            return bk.mlp_block_plain(x, *weights, act)
        out, stats, h = bk._mlp_sub_path(x, *weights, act, save_hidden=save_hidden)
        mlp_subpath.launches += 1
        mlp_subpath.saved_launches += h is not None
        ctx.save_for_backward(x, *weights, stats, *(() if h is None else (h,)))
        return out

    @staticmethod
    @spanned("_MlpSubpath.backward", _mlp_geometry)
    def backward(ctx, g):
        x, ln_w, ln_b, wfc, bfc, wproj, bproj, *saves = ctx.saved_tensors
        if saves:
            stats, h = saves[0], (saves[1] if len(saves) > 1 else None)
            grads = mlp_subpath_backward(g.contiguous(), x, stats, h, ln_w, ln_b, wfc, bfc,
                                         wproj, ctx.act)
        else:
            grads = mlp_subpath_backward_plain(g, x, ln_w, ln_b, wfc, bfc, wproj, bproj, ctx.act)
        return (*grads, None, None)


@spanned("mlp_subpath", bk.mlp_geometry)
def mlp_subpath(x, ln_w, ln_b, wfc, bfc, wproj, bproj, act: str = "quick_gelu",
                save_hidden: bool = False) -> torch.Tensor:
    """H8 (differentiable). x: [B, S, D] -> x + c_proj(act(c_fc(LN_2(x)))).
    save_hidden keeps the pre-activation hidden for the backward (more
    activation memory, no recompute of the first product)."""
    if act not in ("quick_gelu", "gelu"):
        raise ValueError(f"unknown activation {act!r}")
    return _MlpSubpath.apply(x, ln_w, ln_b, wfc, bfc, wproj, bproj, act, save_hidden)


KERNELS = (time_subpath, time_subpath_backward, space_subpath, space_subpath_backward,
           mlp_subpath, mlp_subpath_backward, wgrad, time_core_backward, space_core_backward,
           ln_backward)
for _fn in KERNELS:
    _fn.launches = 0
mlp_subpath.saved_launches = mlp_subpath_backward.saved_launches = 0
space_core_backward.pair_launches = 0
