"""The fused self-attention sub-path of the text tower (and, in slice 3, the
sort head), hand-written in CUDA C++ for Hopper, beside its plain PyTorch
version; and the text tower's forward through it (counterpart of
tvts_tpu/ops/pallas_text_attention.py).

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
"""

from __future__ import annotations

import torch

from tvts_torch.models.layers import layer_norm_f32, linear, self_attention
from tvts_torch.ops import block_kernels as bk
from tvts_torch.ops.attention import merge_heads, split_heads


def text_attention_block_plain(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, num_heads: int,
                               causal: bool = True, eps: float = 1e-5) -> torch.Tensor:
    """x + Proj(Attn(LN(x)))."""
    return x + self_attention(layer_norm_f32(x, ln_w, ln_b, eps), wqkv, bqkv, wproj, bproj,
                              num_heads, causal)


def fused_text_attention_block(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, num_heads: int,
                               causal: bool = True, eps: float = 1e-5) -> torch.Tensor:
    """H7 forward. x: [B, S, D] -> x + Proj(Attn(LN(x))) [B, S, D]."""
    if not bk._dispatch(x):
        return text_attention_block_plain(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, num_heads,
                                          causal, eps)
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
        bk._ln_gemm(lib, x, B * S, D, (ln_w, ln_b), wqkv, bqkv, qkv, eps=eps)
        attn = torch.empty_like(x)
        bk._check(lib, lib.tvts_text_core(bk._ptr(qkv), bk._ptr(attn), B, S, num_heads, 64,
                                          64 ** -0.5, int(causal),
                                          torch.cuda.current_stream(x.device).cuda_stream))
        out = torch.empty_like(x)
        bk._ln_gemm(lib, attn, B * S, D, None, wproj, bproj, out, res=x, ldres=D)
    fused_text_attention_block.launches += 1
    return out


fused_text_attention_block.launches = 0


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


def text_transformer_fused_forward(model, token_ids: torch.Tensor) -> torch.Tensor:
    """Equivalent to model.compute_text(token_ids) for a TextTransformer (or
    TVTSv2): every block's attention sub-path but the last runs H7; the MLPs,
    LNs, embedding and pool stay plain torch (XLA in the JAX package); the
    last block computes only the EOT rows. [N, ctx] ids -> [N, output_dim]."""
    cfg = model.text_cfg
    x = model.embed_tokens(token_ids)
    eot_pos = token_ids.long().argmax(dim=-1)
    *blocks, last = model.text_model.resblocks
    for blk in blocks:
        x = fused_text_attention_block(
            x, blk.ln_1.weight, blk.ln_1.bias, blk.attn.in_proj_weight,
            blk.attn.in_proj_bias, blk.attn.out_proj.weight, blk.attn.out_proj.bias,
            num_heads=cfg.heads, causal=True)
        x = x + blk.mlp(blk.ln_2(x))
    x = _eot_only_block(x, last, eot_pos, cfg.heads)
    return model.project_text(x[:, 0])
