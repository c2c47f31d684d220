"""DistilBERT text encoder, the TVTS v1 text tower (counterpart of
tvts_tpu/models/distilbert.py).

HuggingFace `distilbert-base-uncased` as the reference uses it
(v1/model/model_dist_TVTS.py:33,126-130): word + learned position
embeddings -> LayerNorm (eps 1e-12) -> 6 post-norm blocks of
{q/k/v/out linears, `sa_layer_norm` on the residual sum, lin1 -> exact gelu
-> lin2, `output_layer_norm` on the residual sum}; callers pool the CLS row.

Parameter names are HF `DistilBertModel`'s (`embeddings.*`,
`transformer.layer.{i}.attention.{q,k,v,out}_lin`, `.sa_layer_norm`,
`.ffn.lin{1,2}`, `.output_layer_norm`), so a v1 checkpoint's `text_model.*`
loads as it is; `distilbert_state_dict` strips the `distilbert.` prefix of
an HF masked-LM dict and drops what the encoder does not hold.

Numerics as in the JAX package: the activations are in `compute_dtype` (the
weights' dtype when None); LayerNorms and the softmax in float32. The mask
bias is built in float32 (0 or finfo(float32).min) and then cast to the
compute dtype, where bf16 rounds it to -inf; a row is never all masked,
since the tokenizer always keeps CLS.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn

from tvts_torch.models.layers import LayerNormF32, lecun_normal_, linear
from tvts_torch.ops.attention import merge_heads, split_heads

LN_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class DistilBertConfig:
    vocab_size: int = 30522
    max_position_embeddings: int = 512
    dim: int = 768
    hidden_dim: int = 3072
    n_layers: int = 6
    n_heads: int = 12


def _reset_linears(layers, generator: torch.Generator) -> None:
    for layer in layers:
        lecun_normal_(layer.weight, layer.in_features, generator)
        nn.init.zeros_(layer.bias)


class Embeddings(nn.Module):
    def __init__(self, cfg: DistilBertConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.dim)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, cfg.dim)
        self.LayerNorm = LayerNormF32(cfg.dim, eps=LN_EPS)

    def forward(self, input_ids: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        word = F.embedding(input_ids.long(), self.word_embeddings.weight).to(dtype)
        return self.LayerNorm(word + F.embedding(pos, self.position_embeddings.weight)
                              .to(dtype)[None])


class MultiHeadSelfAttention(nn.Module):
    def __init__(self, cfg: DistilBertConfig):
        super().__init__()
        self.n_heads = cfg.n_heads
        self.q_lin, self.k_lin, self.v_lin, self.out_lin = (
            nn.Linear(cfg.dim, cfg.dim) for _ in range(4))

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        """x [B, L, D]; bias [B, 1, 1, L] additive, in x's dtype."""
        d = x.shape[-1] // self.n_heads
        q = split_heads(linear(x, self.q_lin.weight, self.q_lin.bias), self.n_heads)
        k = split_heads(linear(x, self.k_lin.weight, self.k_lin.bias), self.n_heads)
        v = split_heads(linear(x, self.v_lin.weight, self.v_lin.bias), self.n_heads)
        q = q / torch.tensor(d ** 0.5, dtype=x.dtype, device=x.device)
        p = torch.softmax((q @ k.transpose(-1, -2) + bias).float(), dim=-1).to(x.dtype)
        return linear(merge_heads(p @ v), self.out_lin.weight, self.out_lin.bias)


class FFN(nn.Module):
    def __init__(self, cfg: DistilBertConfig):
        super().__init__()
        self.lin1 = nn.Linear(cfg.dim, cfg.hidden_dim)
        self.lin2 = nn.Linear(cfg.hidden_dim, cfg.dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.gelu(linear(x, self.lin1.weight, self.lin1.bias), approximate="none")
        return linear(h, self.lin2.weight, self.lin2.bias)


class TransformerBlock(nn.Module):
    def __init__(self, cfg: DistilBertConfig):
        super().__init__()
        self.attention = MultiHeadSelfAttention(cfg)
        self.sa_layer_norm = LayerNormF32(cfg.dim, eps=LN_EPS)
        self.ffn = FFN(cfg)
        self.output_layer_norm = LayerNormF32(cfg.dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        x = self.sa_layer_norm(x + self.attention(x, bias))
        return self.output_layer_norm(x + self.ffn(x))


class Transformer(nn.Module):
    def __init__(self, cfg: DistilBertConfig):
        super().__init__()
        self.layer = nn.ModuleList(TransformerBlock(cfg) for _ in range(cfg.n_layers))


class DistilBertEncoder(nn.Module):
    def __init__(self, cfg: DistilBertConfig = DistilBertConfig()):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype: torch.dtype | None = None  # None: the weights' dtype
        self.embeddings = Embeddings(cfg)
        self.transformer = Transformer(cfg)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX package's initializers (flax Embed: normal, std 1/sqrt(dim);
        Dense: lecun normal, zero bias), drawn from `generator`."""
        for emb in (self.embeddings.word_embeddings, self.embeddings.position_embeddings):
            emb.weight.normal_(0.0, self.cfg.dim ** -0.5, generator=generator)
        self.embeddings.LayerNorm.reset_parameters()
        for blk in self.transformer.layer:
            a = blk.attention
            _reset_linears((a.q_lin, a.k_lin, a.v_lin, a.out_lin, blk.ffn.lin1, blk.ffn.lin2),
                           generator)
            blk.sa_layer_norm.reset_parameters()
            blk.output_layer_norm.reset_parameters()

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        """input_ids, attention_mask [B, L] -> last_hidden_state [B, L, D]."""
        dtype = self.compute_dtype or self.embeddings.word_embeddings.weight.dtype
        x = self.embeddings(input_ids, dtype)
        bias = torch.where(attention_mask[:, None, None, :] > 0, 0.0,
                           torch.finfo(torch.float32).min).to(dtype)
        for blk in self.transformer.layer:
            x = blk(x, bias)
        return x


_HF_KEY = re.compile(r"^(embeddings\.(word_embeddings|position_embeddings|LayerNorm)\."
                     r"|transformer\.layer\.\d+\.(attention|sa_layer_norm|ffn"
                     r"|output_layer_norm)\.)")


def distilbert_state_dict(sd: Mapping) -> dict:
    """An HF DistilBERT state dict (with or without the `distilbert.` prefix
    of the masked-LM model) -> the encoder's entries: the prefix stripped,
    the keys the encoder does not hold (position_ids, the LM head) dropped,
    as tvts_tpu's convert_distilbert_state_dict drops them."""
    out = {}
    for k, v in sd.items():
        k = re.sub(r"^distilbert\.", "", k)
        if _HF_KEY.match(k):
            out[k] = v
    return out
