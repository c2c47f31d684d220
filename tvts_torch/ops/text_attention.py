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
the flash-style core of csrc/text_attention.cuh attends per (64-query tile,
head, sequence), ln_gemm proj adds the residual x in its epilogue. Bound by
the two products at S = 77; see the core's notes. Dispatch as in
block_kernels: plain version on a CPU tensor, the kernel (bf16, head dim 64)
on a CUDA tensor, or raise; `.launches` counts calls that ran the kernel.

`text_subpath` is the differentiable form (replaces make_text_subpath, :313,
with the backward fused_text_attention_block_bwd, :264, kernel :134). Its
forward is the same chain keeping the qkv rows, the attention output, the
per-row log-sum-exp and the LN row stats (counted on
fused_text_attention_block.launches); its backward is the chain of
ops/block_backward.attention_backward with the flash-2 text core of
csrc/attention_bwd.cuh (64-key tiles per block for dk/dv, 64-query tiles
for dq, tiles above the diagonal skipped when causal), counted on
`text_subpath_backward.launches` (`.frozen_launches` for the frozen form).
`frozen=True` is the backward of a block in the optimizer's frozen group: dx
only, no weight-gradient launches at all (:134-140).
"""

from __future__ import annotations

import torch

from tvts_torch.models.layers import layer_norm_f32, linear, mlp, self_attention
from tvts_torch.ops import block_backward as bb
from tvts_torch.ops import block_kernels as bk
from tvts_torch.ops.attention import merge_heads, split_heads


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
        bk._check(lib, lib.tvts_text_core(bk._ptr(qkv), bk._ptr(attn), bk._ptr(lse), B, S,
                                          num_heads, 64, 64 ** -0.5, int(causal),
                                          bk._stream(x)))
        out = torch.empty_like(x)
        bk._ln_gemm(lib, attn, B * S, D, None, wproj, bproj, out, res=x, ldres=D)
    fused_text_attention_block.launches += 1
    return (out, qkv, attn, lse, stats) if save else out


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
        frozen = tune_from is not None and i < tune_from
        x = text_subpath(x, *_attn_weights(blk.ln_1, blk.attn, x.dtype, frozen),
                         num_heads=cfg.heads, causal=True, frozen=frozen)
        if frozen:
            w = [t.detach() for t in (blk.ln_2.weight, blk.ln_2.bias, blk.mlp.c_fc.weight,
                                      blk.mlp.c_fc.bias, blk.mlp.c_proj.weight,
                                      blk.mlp.c_proj.bias)]
            x = x + mlp(layer_norm_f32(x, w[0], w[1]), *w[2:], blk.mlp.act)
        else:
            x = x + blk.mlp(blk.ln_2(x))
    x = _eot_only_block(x, last, eot_pos, cfg.heads)
    return model.project_text(x[:, 0])


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
        w = (blk.norm1.weight, blk.norm1.bias, blk.attn.qkv.weight.to(x.dtype),
             blk.attn.qkv.bias.to(x.dtype), blk.attn.proj.weight.to(x.dtype),
             blk.attn.proj.bias.to(x.dtype))
        x = text_subpath(x, *w, num_heads=cfg.num_heads, causal=False, eps=blk.norm1.eps)
        x = x + blk.mlp(blk.norm2(x))
    return sort_model.classify(last(x, tail=n_text))
