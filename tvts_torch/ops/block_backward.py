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
  delta = rowsum(dattn * attn)            per head
  dqkv                                    core backward (time / space / text)
  dWqkv = dqkv^T LN(x), dbqkv             wgrad with the LN prologue (recomputed)
  dxln = dqkv @ Wqkv                      ln_gemm on Wqkv^T, f32 out
  dx = [g] + LN_bwd(dxln), dln_w, dln_b   ln_bwd + fixed-order sums
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
`space_subpath_backward` their backwards.

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
that plus the recompute). wgrad's f32 split-M partials are bounded by its
split rule (at most 2 * SMs output tiles in flight: 2 splits of 9.4 MB at
D = 768, 1 of 26 MB at D = 1280). `mlp_subpath.launches` counts the forwards,
`mlp_subpath_backward.launches` the backwards (`.saved_launches` of each those
that wrote or read a saved hidden).
"""

from __future__ import annotations

import torch

from tvts_torch.ops import block_kernels as bk

# ---------------------------------------------------------------------------
# the shared backward chain (CUDA)
# ---------------------------------------------------------------------------
def _sms(t: torch.Tensor) -> int:
    """Streaming multiprocessors of t's card (132 on the H100): sizes the row
    splits of the reductions."""
    return torch.cuda.get_device_properties(t.device).multi_processor_count


def _reduce(lib, partial, P: int, n: int, out: torch.Tensor) -> torch.Tensor:
    """out[i] = sum_p partial[p, i] in a fixed order; out f32 or bf16."""
    f32 = out.dtype == torch.float32
    bk._check(lib, lib.tvts_reduce(bk._ptr(partial), P, n, bk._ptr(out) if f32 else None,
                                   None if f32 else bk._ptr(out), bk._stream(partial)))
    return out


def _wgrad(lib, a, b, stats=None, ln=None, dtype=torch.bfloat16):
    """(a^T b [N1, N2], colsum(a) [N1]) over the rows of a [M, N1], b [M, N2],
    with b -> LN(b) from `stats` and `ln` = (w, bias) when given; accumulated
    in f32, returned in `dtype`. The rows are split across blocks so the
    output tiles fill the card; the split depends on the shapes and the
    card only, so the sum order is fixed."""
    M, N1 = a.shape
    N2 = b.shape[1]
    tiles = -(-N1 // 128) * -(-N2 // 128)
    splits = max(1, min(-(-2 * _sms(a) // tiles), M // 512))
    rows = -(-M // splits)
    rows = -(-rows // 32) * 32
    splits = -(-M // rows)
    f32 = dict(dtype=torch.float32, device=a.device)
    partial = torch.empty(splits, N1, N2, **f32)
    colsum = torch.empty(splits, N1, **f32)
    ln_w, ln_b = ln if ln else (None, None)
    bk._check(lib, lib.tvts_wgrad(bk._ptr(a), a.stride(0), bk._ptr(b), b.stride(0),
                                  bk._ptr(stats), bk._ptr(ln_w), bk._ptr(ln_b),
                                  bk._ptr(partial), bk._ptr(colsum), M, N1, N2, splits, rows,
                                  bk._stream(a)))
    dw = _reduce(lib, partial, splits, N1 * N2, torch.empty(N1, N2, dtype=dtype, device=a.device))
    db = _reduce(lib, colsum, splits, N1, torch.empty(N1, dtype=dtype, device=a.device))
    return dw, db


def _ln_backward(lib, x2d, stats, dxln, ln_w, res, weight_grads: bool):
    """(dx = res + LN_bwd(dxln) [M, K] bf16, dln_w, dln_b f32 or None)."""
    M, K = x2d.shape
    rpw = max(1, -(-M // (_sms(x2d) * 4 * 8)))  # rows per warp: ~4 blocks of 8 warps per SM
    blocks = -(-M // (8 * rpw))
    dx = torch.empty_like(x2d)
    part = (torch.empty(2, blocks * 8, K, dtype=torch.float32, device=x2d.device)
            if weight_grads else None)
    bk._check(lib, lib.tvts_ln_bwd(
        bk._ptr(x2d), bk._ptr(stats), bk._ptr(dxln), bk._ptr(ln_w), bk._ptr(res), bk._ptr(dx),
        None if part is None else bk._ptr(part[0]), None if part is None else bk._ptr(part[1]),
        M, K, rpw, blocks, bk._stream(x2d)))
    if part is None:
        return dx, None, None
    f32 = dict(dtype=torch.float32, device=x2d.device)
    return (dx, _reduce(lib, part[0], blocks * 8, K, torch.empty(K, **f32)),
            _reduce(lib, part[1], blocks * 8, K, torch.empty(K, **f32)))


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
        delta = torch.empty(B, num_heads, S, dtype=torch.float32, device=x.device)
        bk._check(lib, lib.tvts_attn_delta(bk._ptr(dattn), bk._ptr(attn), B, S, num_heads, d,
                                           bk._ptr(delta), stream))
        dqkv = torch.empty(B, S, 3 * D, dtype=x.dtype, device=x.device)
        if core == "text":
            bk._check(lib, lib.tvts_flash_bwd(bk._ptr(qkv), bk._ptr(dattn), bk._ptr(lse),
                                              bk._ptr(delta), bk._ptr(dqkv), None, B, 1, 0, S,
                                              num_heads, d, d ** -0.5, int(causal), 0, stream))
        else:
            T = num_frames
            N = bk._patches_per_frame(S, T)
            G = N if core == "time" else T  # groups holding the CLS token
            partial = torch.empty(B, G, num_heads, 3, d, dtype=torch.float32, device=x.device)
            if core == "time":
                bk._check(lib, lib.tvts_time_bwd(bk._ptr(qkv), bk._ptr(dattn), bk._ptr(lse),
                                                 bk._ptr(delta), bk._ptr(dqkv), bk._ptr(partial),
                                                 B, T, N, num_heads, d, d ** -0.5, stream))
            else:
                bk._check(lib, lib.tvts_flash_bwd(bk._ptr(qkv), bk._ptr(dattn), bk._ptr(lse),
                                                  bk._ptr(delta), bk._ptr(dqkv),
                                                  bk._ptr(partial), B, T, N, S, num_heads, d,
                                                  d ** -0.5, 0, 1, stream))
            bk._check(lib, lib.tvts_cls_grad_combine(bk._ptr(partial), G, B, num_heads, d, S,
                                                     bk._ptr(dqkv), stream))
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
    def backward(ctx, g):
        T, H = ctx.geometry
        x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, *saves = ctx.saved_tensors
        if saves:
            grads = time_subpath_backward(g.contiguous(), x, saves, ln_w, ln_b, wqkv, wproj, T, H)
        else:
            grads = time_subpath_backward_plain(g, x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, T, H)
        return (*grads, None, None)


def time_subpath(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, num_frames: int,
                 num_heads: int) -> torch.Tensor:
    """H6 (differentiable). x: [B, S, D] -> x + Proj(TimeAttn(LN_3(x)))."""
    return _TimeSubpath.apply(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, num_frames, num_heads)


# ---------------------------------------------------------------------------
# H5: space sub-path (training)
# ---------------------------------------------------------------------------
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
    def backward(ctx, g):
        x, ln_w, ln_b, wfc, bfc, wproj, bproj, *saves = ctx.saved_tensors
        if saves:
            stats, h = saves[0], (saves[1] if len(saves) > 1 else None)
            grads = mlp_subpath_backward(g.contiguous(), x, stats, h, ln_w, ln_b, wfc, bfc,
                                         wproj, ctx.act)
        else:
            grads = mlp_subpath_backward_plain(g, x, ln_w, ln_b, wfc, bfc, wproj, bproj, ctx.act)
        return (*grads, None, None)


def mlp_subpath(x, ln_w, ln_b, wfc, bfc, wproj, bproj, act: str = "quick_gelu",
                save_hidden: bool = False) -> torch.Tensor:
    """H8 (differentiable). x: [B, S, D] -> x + c_proj(act(c_fc(LN_2(x)))).
    save_hidden keeps the pre-activation hidden for the backward (more
    activation memory, no recompute of the first product)."""
    if act not in ("quick_gelu", "gelu"):
        raise ValueError(f"unknown activation {act!r}")
    return _MlpSubpath.apply(x, ln_w, ln_b, wfc, bfc, wproj, bproj, act, save_hidden)


KERNELS = (time_subpath, time_subpath_backward, space_subpath, space_subpath_backward,
           mlp_subpath, mlp_subpath_backward)
for _fn in KERNELS:
    _fn.launches = 0
mlp_subpath.saved_launches = mlp_subpath_backward.saved_launches = 0
