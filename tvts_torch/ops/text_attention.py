"""The fused self-attention sub-path of the text tower and the sort head (H7),
hand-written in CUDA C++ for Hopper, beside its plain PyTorch version; its
training form with the backward; and the text tower's and the sort head's
forwards through it (counterpart of tvts_tpu/ops/pallas_text_attention.py).

`fused_text_attention_block` replaces fused_text_attention_block (:102, kernel
:43-99): x + Proj(Attn(LN(x))), causal with LN eps 1e-5 in the text tower
(S = 77), or non-causal with eps 1e-6 in the sort head (S ~ 1181). Weights in
the nn.Linear layout [out, in], biases in the activation dtype, LN parameters
float32. Design (three launches; the kernels are built into the one library
of ops/block_kernels.py): ln_gemm with the LN prologue writes the qkv rows,
the attention core (`text_core`, csrc/text_attention.cuh) attends, ln_gemm
proj adds the residual x in its epilogue. Dispatch as in block_kernels:
plain version on a CPU tensor, the kernel (bf16, head dim 64) on a CUDA
tensor, or raise; `.launches` counts calls that ran the kernel.

`text_subpath` is the differentiable form (replaces make_text_subpath, :313,
with the backward fused_text_attention_block_bwd, :264, kernel :134). Its
forward is the same chain keeping the qkv rows, the attention output, the
per-row log-sum-exp and the LN row stats (counted on
fused_text_attention_block.launches); its backward is the chain of
ops/block_backward.attention_backward with the core's backward
(`text_core_backward`, csrc/text_attention_bwd.cuh), counted on
`text_subpath_backward.launches` (`.frozen_launches` for the frozen form).
`frozen=True` is the backward of a block in the optimizer's frozen group: dx
only, no weight-gradient launches at all (:134-140).

The attention core alone: `text_core` (forward, the core of :43-99) and
`text_core_backward` (the core of :134-262), each beside its plain version
(`text_core_plain`, `text_core_backward_plain`: the kernels' rounding points,
for the tests and chip_smoke.py) and with its own `.launches` (one a sub-path
forward or backward on the card). `text_core_plan` sizes both and refuses
what they do not take. Two designs, chosen by S (the notes of
csrc/text_attention.cuh and text_attention_bwd.cuh): at S <= TEXT_SMALL_MAX
(the text tower's 77) a block per (head, sequence) stages the sequence's rows
once and computes on mma.sync, the backward in one launch; longer sequences
(the sort head's 917 .. 1181) take TMA + wgmma kernels: forward 192 query
rows a block over a ring of 64-key tiles; backward a dq pass (128 queries a
block, which also writes each row's delta and lse padded to a multiple of 64
rows) and then a dk/dv pass (128 keys a block). Bound: the tensor cores (and
as many exp2 as logits) at the sort head's S, the bytes at 77.
"""

from __future__ import annotations

import functools

import torch

from tvts_torch.models.layers import layer_norm_f32, linear, mlp, self_attention
from tvts_torch.ops import block_backward as bb
from tvts_torch.ops import block_kernels as bk
from tvts_torch.ops.attention import merge_heads, split_heads
from tvts_torch.parallel.partition import whole
from tvts_torch.utils.profiling import describe, spanned

# csrc/text_attention.cuh and text_attention_bwd.cuh: the longest sequence of
# the one-block kernels; the TMA + wgmma kernels' tiles (rows a block, rows a
# ring step), ring stages, threads and shared memory
TEXT_SMALL_MAX = 128
TEXT_FWD_TILES, TEXT_FWD_STAGES = (192, 64), 4
TEXT_BWD_TILES, TEXT_BWD_STAGES = (128, 64), 8
TEXT_FWD_THREADS, TEXT_BWD_THREADS = 3 * 128 + 32, 256  # forward: and a producer warp
TEXT_FWD_SMEM = (1024 + TEXT_FWD_TILES[0] * 128 + TEXT_FWD_STAGES * 2 * TEXT_FWD_TILES[1] * 128
                 + (1 + 2 * TEXT_FWD_STAGES) * 8)
TEXT_DKV_SMEM = (1024 + 2 * 128 * 128 + TEXT_BWD_STAGES * (2 * 64 * 128 + 2 * 64 * 4)
                 + (1 + 2 * TEXT_BWD_STAGES) * 8)
TEXT_DQ_SMEM = (1024 + 3 * 128 * 128 + TEXT_BWD_STAGES * 2 * 64 * 128 + 2 * 2 * 64 * 4
                + (1 + 2 * TEXT_BWD_STAGES) * 8)
_SMALL_LD = 64 + 8  # a staged row of the one-block kernels: 64 bf16 and 16 bytes


def _tiles(n_rows: int, rows: int, step: int, first, last) -> list:
    """[((r0, r1), [(c0, c1), ...]), ...]: row blocks of `rows` over n_rows,
    each walking column tiles of `step` from first(r0) up to last(r0),
    ranges clipped to n_rows."""
    return [((r0, min(r0 + rows, n_rows)),
             [(c0, min(c0 + step, n_rows)) for c0 in range(first(r0), last(r0), step)])
            for r0 in range(0, n_rows, rows)]


def text_core_plan(B: int, S: int, H: int, d: int, causal: bool, pointers=None) -> dict:
    """The launch plan of the H7 attention core, forward and backward, for B
    sequences of S rows, H heads of d. Raises ValueError, before any launch,
    on what the kernels do not take: d other than 64 (every text and sort
    config of the repo), no sequence, row or head, or a base address
    (`pointers`: name -> address) that is not 16-byte aligned (the TMA boxes
    and the 16-byte copies read from it).

    kernel "small" (S <= TEXT_SMALL_MAX): a block per (head, sequence), a warp
    per 16-row slab; "tma" otherwise. The tiles are what each block computes:
    `fwd` and `dq` list (query rows, [key columns walked]) and `dkv` (key rows,
    [query columns walked]), the tiles wholly above the diagonal skipped when
    causal; `scratch_rows` is the backward's padded lse and delta rows (0: the
    one-block backward needs none). The dict is shared between calls with the
    same shapes: do not change it."""
    if d != 64:
        raise ValueError(f"head dim {d}: the text attention core takes head dim 64")
    if B < 1 or S < 1 or H < 1:
        raise ValueError(f"B = {B}, S = {S}, H = {H}: the text attention core takes at least "
                         f"one of each")
    for name, ptr in (pointers or {}).items():
        if ptr is not None and ptr % 16:
            raise ValueError(f"{name} at {ptr:#x} is not 16-byte aligned")
    return _text_core_geometry(B, S, H, causal)


@functools.cache
def _text_core_geometry(B: int, S: int, H: int, causal: bool) -> dict:
    every = lambda r0: S  # noqa: E731
    if S <= TEXT_SMALL_MAX:
        slabs = -(-S // 16)
        rows = 16 * slabs
        upto = (lambda r0: r0 + 16) if causal else every
        return dict(kernel="small", fwd_grid=(H, B), bwd_grid=(H, B), threads=32 * slabs,
                    fwd_smem=3 * rows * _SMALL_LD * 2,
                    bwd_smem=(4 * rows * _SMALL_LD * 2 + 2 * rows * 4,), scratch_rows=0,
                    fwd=_tiles(S, 16, 16, lambda r0: 0, upto),
                    dq=_tiles(S, 16, 16, lambda r0: 0, upto),
                    dkv=_tiles(S, 16, 16, (lambda r0: r0) if causal else (lambda r0: 0), every))
    (fq, fk), (brows, bstep) = TEXT_FWD_TILES, TEXT_BWD_TILES
    grid = lambda rows: (-(-S // rows), H, B)  # noqa: E731
    return dict(kernel="tma", fwd_grid=grid(fq), bwd_grid=grid(brows),
                threads=(TEXT_FWD_THREADS, TEXT_BWD_THREADS),
                fwd_smem=TEXT_FWD_SMEM, bwd_smem=(TEXT_DQ_SMEM, TEXT_DKV_SMEM),
                scratch_rows=-(-S // bstep) * bstep,
                fwd=_tiles(S, fq, fk, lambda r0: 0,
                           (lambda r0: min(S, r0 + fq)) if causal else every),
                dq=_tiles(S, brows, bstep, lambda r0: 0,
                          (lambda r0: min(S, r0 + brows)) if causal else every),
                dkv=_tiles(S, brows, bstep, (lambda r0: r0) if causal else (lambda r0: 0),
                           every))


def _core_heads(qkv, num_heads):
    """q, k, v [B, H, S, d] in f32 from packed rows qkv [B, S, 3D]."""
    B, S, D3 = qkv.shape
    return (t.float().reshape(B, S, num_heads, -1).transpose(1, 2) for t in qkv.chunk(3, -1))


def _core_mask(S, causal, device):
    """[S, S] bool, True where query i may see key j."""
    keep = torch.ones(S, S, dtype=torch.bool, device=device)
    return keep.tril() if causal else keep


def text_core_plain(qkv, num_heads: int, causal: bool):
    """The H7 core in plain torch with the kernels' rounding points: logits
    scale * q.k in f32 (for d = 64 the TPU's bf16-rounded q / 8, exactly),
    P rounded to qkv's dtype for P V, the row sum of the f32 probabilities,
    the output divided by it. qkv [B, S, 3D] -> (out [B, S, D] in qkv's
    dtype, lse [B, H, S] f32, natural log of the scaled logits)."""
    B, S, D3 = qkv.shape
    q, k, v = _core_heads(qkv, num_heads)
    logits = (q @ k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    logits = logits.masked_fill(~_core_mask(S, causal, qkv.device), float("-inf"))
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(-1, keepdim=True)  # noqa: E741
    out = (p.to(qkv.dtype).float() @ v) / l
    return (out.transpose(1, 2).reshape(B, S, D3 // 3).to(qkv.dtype),
            (m + torch.log(l)).squeeze(-1))


def text_core_backward_plain(qkv, out, lse, dO, num_heads: int, causal: bool):
    """dqkv [B, S, 3D] (qkv's dtype) of the H7 core in plain torch with the
    kernels' rounding points: P = exp(scale q.k - lse) from the saved lse,
    delta = rowsum(dO * out), dS = P (dO v^T - delta), P and dS rounded to
    qkv's dtype for dv = P^T dO, dq = scale dS k, dk = scale dS^T q."""
    B, S, D3 = qkv.shape
    q, k, v = _core_heads(qkv, num_heads)
    scale = q.shape[-1] ** -0.5
    do, o = (t.float().reshape(B, S, num_heads, -1).transpose(1, 2) for t in (dO, out))
    p = torch.exp((q @ k.transpose(-1, -2)) * scale - lse.float()[..., None])
    p = p.masked_fill(~_core_mask(S, causal, qkv.device), 0.0)
    delta = (do * o).sum(-1, keepdim=True)
    ds = p * (do @ v.transpose(-1, -2) - delta)
    p, ds = (t.to(qkv.dtype).float() for t in (p, ds))
    dq, dk, dv = (ds @ k) * scale, (ds.transpose(-1, -2) @ q) * scale, p.transpose(-1, -2) @ do
    return torch.cat([t.transpose(1, 2).reshape(B, S, D3 // 3) for t in (dq, dk, dv)],
                     -1).to(qkv.dtype)


def _text_core(lib, qkv, out, lse, num_heads: int, causal: bool) -> None:
    """The H7 forward core on the card into out (and lse unless None)."""
    B, S, D3 = qkv.shape
    plan = text_core_plan(B, S, num_heads, D3 // 3 // num_heads, causal,
                          {"qkv": bk._ptr(qkv), "out": bk._ptr(out), "lse": bk._ptr(lse)})
    bk._check(lib, lib.tvts_text_core(bk._ptr(qkv), bk._ptr(out), bk._ptr(lse), B, S, num_heads,
                                      64, 64 ** -0.5, int(causal), int(plan["kernel"] == "small"),
                                      bk._stream(qkv)))
    text_core.launches += 1


def text_core(qkv, num_heads: int, causal: bool = True, with_lse: bool = False):
    """The H7 attention core alone: qkv [B, S, 3D] -> out [B, S, D] (and the
    lse [B, H, S] f32 with `with_lse`). On a CPU tensor text_core_plain; on a
    CUDA tensor the kernel (bf16, head dim 64)."""
    if not bk._dispatch(qkv):
        out, lse = text_core_plain(qkv, num_heads, causal)
        return (out, lse) if with_lse else out
    B, S, D3 = qkv.shape
    bk._expect("qkv", qkv, qkv, torch.bfloat16, (B, S, D3))
    out = torch.empty(B, S, D3 // 3, dtype=qkv.dtype, device=qkv.device)
    lse = (torch.empty(B, num_heads, S, dtype=torch.float32, device=qkv.device)
           if with_lse else None)
    with torch.cuda.device(qkv.device):
        _text_core(bk.library(), qkv, out, lse, num_heads, causal)
    return (out, lse) if with_lse else out


def _text_core_backward(lib, qkv, out, lse, dO, num_heads: int, causal: bool):
    """dqkv of the H7 core on the card (text_core_backward's kernels)."""
    B, S, D3 = qkv.shape
    plan = text_core_plan(B, S, num_heads, D3 // 3 // num_heads, causal,
                          {"qkv": bk._ptr(qkv), "out": bk._ptr(out), "lse": bk._ptr(lse),
                           "dO": bk._ptr(dO)})
    Sp = plan["scratch_rows"]
    scratch = (torch.empty(2, B, num_heads, Sp, dtype=torch.float32, device=qkv.device)
               if Sp else None)
    dqkv = torch.empty_like(qkv)
    bk._check(lib, lib.tvts_text_core_bwd(
        bk._ptr(qkv), bk._ptr(out), bk._ptr(dO), bk._ptr(lse),
        None if scratch is None else bk._ptr(scratch[0]),
        None if scratch is None else bk._ptr(scratch[1]), bk._ptr(dqkv), B, S, Sp, num_heads,
        64, 64 ** -0.5, int(causal), int(plan["kernel"] == "small"), bk._stream(qkv)))
    text_core_backward.launches += 1
    return dqkv


def text_core_backward(qkv, out, lse, dO, num_heads: int, causal: bool = True):
    """The H7 core's backward alone: dqkv [B, S, 3D] from the forward's saves
    (qkv [B, S, 3D], its output out [B, S, D] and lse [B, H, S] f32) and dO
    [B, S, D]. On a CPU tensor text_core_backward_plain; on a CUDA tensor the
    kernels (bf16, head dim 64)."""
    if not bk._dispatch(qkv):
        return text_core_backward_plain(qkv, out, lse, dO, num_heads, causal)
    B, S, D3 = qkv.shape
    bk._expect("qkv", qkv, qkv, torch.bfloat16, (B, S, D3))
    bk._expect("out", out, qkv, torch.bfloat16, (B, S, D3 // 3))
    bk._expect("dO", dO, qkv, torch.bfloat16, (B, S, D3 // 3))
    bk._expect("lse", lse, qkv, torch.float32, (B, num_heads, S))
    with torch.cuda.device(qkv.device):
        return _text_core_backward(bk.library(), qkv, out, lse, dO, num_heads, causal)


def text_attention_block_plain(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, num_heads: int,
                               causal: bool = True, eps: float = 1e-5) -> torch.Tensor:
    """x + Proj(Attn(LN(x)))."""
    return x + self_attention(layer_norm_f32(x, ln_w, ln_b, eps), wqkv, bqkv, wproj, bproj,
                              num_heads, causal)


def _text_sub_path(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, num_heads, causal, eps,
                   save: bool):
    """The H7 launch chain on the card; save=True also returns (qkv, attn,
    lse, LN stats) for the backward."""
    B, S, D = x.shape
    if D % num_heads or D // num_heads != 64:
        raise ValueError(f"width {D} / {num_heads} heads: the text kernel takes head dim 64")
    bf = torch.bfloat16
    bk._expect("x", x, x, bf, (B, S, D))
    bk._expect("ln_w", ln_w, x, torch.float32, (D,))
    bk._expect("ln_b", ln_b, x, torch.float32, (D,))
    bk._expect("wqkv", wqkv, x, bf, (3 * D, D))
    bk._expect("bqkv", bqkv, x, bf, (3 * D,))
    bk._expect("wproj", wproj, x, bf, (D, D))
    bk._expect("bproj", bproj, x, bf, (D,))
    lib = bk.library()
    with torch.cuda.device(x.device):
        qkv = torch.empty(B, S, 3 * D, dtype=bf, device=x.device)
        stats = bk._ln_gemm(lib, x, B * S, D, (ln_w, ln_b), wqkv, bqkv, qkv, eps=eps)
        attn = torch.empty_like(x)
        lse = (torch.empty(B, num_heads, S, dtype=torch.float32, device=x.device)
               if save else None)
        _text_core(lib, qkv, attn, lse, num_heads, causal)
        out = torch.empty_like(x)
        bk._ln_gemm(lib, attn, B * S, D, None, wproj, bproj, out, res=x, ldres=D)
    fused_text_attention_block.launches += 1
    return (out, qkv, attn, lse, stats) if save else out


@spanned("fused_text_attention_block")
def fused_text_attention_block(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, num_heads: int,
                               causal: bool = True, eps: float = 1e-5) -> torch.Tensor:
    """H7 forward. x: [B, S, D] -> x + Proj(Attn(LN(x))) [B, S, D]."""
    if not bk._dispatch(x):
        return text_attention_block_plain(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, num_heads,
                                          causal, eps)
    return _text_sub_path(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, num_heads, causal, eps,
                          save=False)


def text_subpath_backward_plain(g, x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, num_heads,
                                causal=True, eps=1e-5, frozen=False):
    """(dx, dln_w, dln_b, dwqkv, dbqkv, dwproj, dbproj) of
    text_attention_block_plain; with `frozen` (dx,) only."""
    return bb.vjp(
        lambda *a: text_attention_block_plain(*a, num_heads, causal, eps), g,
        (x, ln_w, ln_b, wqkv, bqkv, wproj, bproj), wrt=(0,) if frozen else None)


def text_subpath_backward(g, x, saves, ln_w, ln_b, wqkv, wproj, num_heads, causal=True,
                          frozen=False):
    """H7 backward on the card; with `frozen` the gradients but dx are None."""
    grads = bb.attention_backward("text", g, x, saves, ln_w, ln_b, wqkv, wproj, num_heads,
                                  residual=True, causal=causal, frozen=frozen)
    text_subpath_backward.launches += 1
    text_subpath_backward.frozen_launches += frozen
    return grads


class _TextSubpath(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, num_heads, causal, eps, frozen):
        ctx.config = (num_heads, causal, eps, frozen)
        weights = (ln_w, ln_b, wqkv, bqkv, wproj, bproj)
        if not bk._dispatch(x):
            ctx.save_for_backward(x, *weights)
            return text_attention_block_plain(x, *weights, num_heads, causal, eps)
        out, *saves = _text_sub_path(x, *weights, num_heads, causal, eps, save=True)
        ctx.save_for_backward(x, *weights, *saves)
        return out

    @staticmethod
    @spanned("_TextSubpath.backward",
             lambda ctx, g: describe(g, num_heads=ctx.config[0], causal=ctx.config[1],
                                     frozen=ctx.config[3]))
    def backward(ctx, g):
        num_heads, causal, eps, frozen = ctx.config
        x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, *saves = ctx.saved_tensors
        if saves:
            grads = text_subpath_backward(g.contiguous(), x, saves, ln_w, ln_b, wqkv, wproj,
                                          num_heads, causal, frozen)
        else:
            grads = text_subpath_backward_plain(g, x, ln_w, ln_b, wqkv, bqkv, wproj, bproj,
                                                num_heads, causal, eps, frozen)
            if frozen:
                grads = (*grads, None, None, None, None, None, None)
        return (*grads, None, None, None, None)


@spanned("text_subpath")
def text_subpath(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, num_heads: int,
                 causal: bool = True, eps: float = 1e-5, frozen: bool = False) -> torch.Tensor:
    """H7, differentiable where autograd records (else the inference kernel,
    without saves). frozen: the backward computes dx only."""
    if not torch.is_grad_enabled():
        return fused_text_attention_block(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, num_heads,
                                          causal, eps)
    return _TextSubpath.apply(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, num_heads, causal, eps,
                              frozen)


fused_text_attention_block.launches = 0
text_core.launches = 0
text_core_backward.launches = 0
text_subpath_backward.launches = 0
text_subpath_backward.frozen_launches = 0


def _attn_weights(ln, attn, dtype, frozen=False):
    """(ln_w, ln_b, wqkv, bqkv, wproj, bproj) of a text block, matrices and
    biases cast to the compute dtype (a differentiable cast: the f32 master
    gets the gradient); detached when the block is frozen."""
    w = (ln.weight, ln.bias, attn.in_proj_weight.to(dtype), attn.in_proj_bias.to(dtype),
         attn.out_proj.weight.to(dtype), attn.out_proj.bias.to(dtype))
    return tuple(t.detach() for t in w) if frozen else w


def _eot_only_block(x, blk, eot_pos, num_heads):
    """The last text block on each sequence's EOT row only, the one row that
    ln_final -> pool reads (exact: LN is per token, and the EOT query attends
    causally over k/v of the rows at or before it). Plain torch, as it is
    XLA in the JAX package. Returns [B, 1, D]."""
    B, S, D = x.shape
    d = D // num_heads
    wqkv, bqkv = blk.attn.in_proj_weight, blk.attn.in_proj_bias
    rows = torch.arange(B, device=x.device)
    x_ln = blk.ln_1(x)
    k, v = linear(x_ln, wqkv[D:], bqkv[D:]).chunk(2, dim=-1)
    q = linear(x_ln[rows, eot_pos][:, None], wqkv[:D], bqkv[:D]) * d ** -0.5
    logits = (split_heads(q, num_heads) @ split_heads(k, num_heads).transpose(-1, -2)).float()
    visible = torch.arange(S, device=x.device)[None] <= eot_pos[:, None]       # [B, S]
    logits = logits.masked_fill(~visible[:, None, None], torch.finfo(torch.float32).min)
    p = torch.softmax(logits, dim=-1).to(x.dtype)
    o = linear(merge_heads(p @ split_heads(v, num_heads)), blk.attn.out_proj.weight,
               blk.attn.out_proj.bias)
    x_eot = x[rows, eot_pos][:, None] + o
    return x_eot + blk.mlp(blk.ln_2(x_eot))


def text_transformer_fused_forward(model, token_ids: torch.Tensor,
                                   tune_from: int | None = None) -> torch.Tensor:
    """Equivalent to model.compute_text(token_ids) for a TextTransformer (or
    TVTSv2): every block's attention sub-path but the last runs H7; the MLPs,
    LNs, embedding and pool stay plain torch (XLA in the JAX package); the
    last block computes only the EOT rows. [N, ctx] ids -> [N, output_dim].

    tune_from: blocks below it are in the optimizer's frozen group: their
    attention backward is the dx-only H7 form and their MLP and LN parameters
    carry no gradient (activation gradients still flow through them)."""
    cfg = model.text_cfg
    x = model.embed_tokens(token_ids)
    eot_pos = token_ids.long().argmax(dim=-1)
    *blocks, last = model.text_model.resblocks
    for i, blk in enumerate(blocks):
        x = whole(blk, _text_block, blk, x, cfg.heads, tune_from is not None and i < tune_from)
    x = whole(last, _eot_only_block, x, last, eot_pos, cfg.heads)
    return model.project_text(x[:, 0])


def _text_block(blk, x, num_heads: int, frozen: bool):
    """One text block but the last: H7, then the plain MLP (under sharding
    inside the block's window, parallel/partition.whole)."""
    x = text_subpath(x, *_attn_weights(blk.ln_1, blk.attn, x.dtype, frozen),
                     num_heads=num_heads, causal=True, frozen=frozen)
    if frozen:
        w = [t.detach() for t in (blk.ln_2.weight, blk.ln_2.bias, blk.mlp.c_fc.weight,
                                  blk.mlp.c_fc.bias, blk.mlp.c_proj.weight, blk.mlp.c_proj.bias)]
        return x + mlp(layer_norm_f32(x, w[0], w[1]), *w[2:], blk.mlp.act)
    return x + blk.mlp(blk.ln_2(x))


@spanned("sort_transformer_fused_forward")
def sort_transformer_fused_forward(sort_model, text_tokens: torch.Tensor,
                                   video_tokens: torch.Tensor) -> torch.Tensor:
    """Equivalent to sort_model(text_tokens, video_tokens) for a
    SortTransformer (models/sort.py): every block but the last runs its
    attention sub-path on H7 (non-causal, LN eps 1e-6); the last block
    computes only the text rows in plain torch, as it is XLA in the JAX
    package (_sort_tail_block, :427). Returns [B, n_text, num_classes]."""
    cfg = sort_model.cfg
    x = sort_model.embed(text_tokens, video_tokens)
    n_text = text_tokens.shape[1]
    *blocks, last = sort_model.blocks
    for blk in blocks:
        x = whole(blk, _sort_block, blk, x, cfg.num_heads)
    return sort_model.classify(whole(last, _sort_tail, last, x, n_text))


def _sort_tail(blk, x, n_text: int):
    """The last sort block's text rows in plain torch, its parameters whole
    (parallel/partition.whole)."""
    return type(blk).forward(blk, x, tail=n_text)


def _sort_block(blk, x, num_heads: int):
    """One sort block but the last: H7, then the plain MLP (under sharding
    inside the block's window, parallel/partition.whole)."""
    w = (blk.norm1.weight, blk.norm1.bias, blk.attn.qkv.weight.to(x.dtype),
         blk.attn.qkv.bias.to(x.dtype), blk.attn.proj.weight.to(x.dtype),
         blk.attn.proj.bias.to(x.dtype))
    x = text_subpath(x, *w, num_heads=num_heads, causal=False, eps=blk.norm1.eps)
    return x + blk.mlp(blk.norm2(x))
