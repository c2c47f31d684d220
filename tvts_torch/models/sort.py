"""Transcript-sorting head (counterpart of tvts_tpu/models/sort.py).

A 2-block pre-norm transformer (LayerNorm eps 1e-6, exact erf gelu) over
[video_tokens + type_embed[0] ; text_tokens + type_embed[1]], then LayerNorm
and a linear head on the text-position rows: [B, n_text, num_classes] logits
scoring which clip each transcript belongs to.

`trim_last=True` computes only the text rows of the last block (exact: its
attention still keys and values over every row, and only the text rows feed
the head); it is a constructor argument, where the JAX module reads the
TVTS_SORT_TAIL environment variable. Parameter names are the reference
`.pth` names under `pred_model.`: `type_embed` [1, 2, D], `blocks.{i}.norm1`,
`.attn.qkv`, `.attn.proj`, `.norm2`, `.mlp.fc1`, `.mlp.fc2`, `norm`, `head`.
"""

from __future__ import annotations

import torch
from torch import nn

from tvts_torch.models.configs import SortConfig
from tvts_torch.models.layers import LayerNormF32, lecun_normal_, linear, mlp, self_attention

SORT_LN_EPS = 1e-6


def _reset_linear(layer: nn.Linear, generator: torch.Generator) -> None:
    lecun_normal_(layer.weight, layer.in_features, generator)
    nn.init.zeros_(layer.bias)


class SortAttention(nn.Module):
    """Full multi-head self-attention with the fused qkv / proj pair."""

    TP_LAYOUT = {"qkv.weight": "qkv", "qkv.bias": "qkv", "proj.weight": "row"}
    tp_group = None  # set by parallel/tensor_parallel.tp_shard

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, q_tail: int | None = None) -> torch.Tensor:
        return self_attention(x, self.qkv.weight, self.qkv.bias, self.proj.weight,
                              self.proj.bias, self.num_heads, q_tail=q_tail, tp=self.tp_group)


class SortMlp(nn.Module):
    """fc1 -> exact gelu -> fc2."""

    TP_LAYOUT = {"fc1.weight": "col", "fc1.bias": "col", "fc2.weight": "row"}
    tp_group = None

    def __init__(self, dim: int, hidden_dim: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp(x, self.fc1.weight, self.fc1.bias, self.fc2.weight, self.fc2.bias, "gelu",
                   self.tp_group)


class SortBlock(nn.Module):
    def __init__(self, cfg: SortConfig):
        super().__init__()
        D = cfg.embed_dim
        self.norm1 = LayerNormF32(D, eps=SORT_LN_EPS)
        self.attn = SortAttention(D, cfg.num_heads)
        self.norm2 = LayerNormF32(D, eps=SORT_LN_EPS)
        self.mlp = SortMlp(D, int(D * cfg.mlp_ratio))

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.norm1.reset_parameters()
        self.norm2.reset_parameters()
        for layer in (self.attn.qkv, self.attn.proj, self.mlp.fc1, self.mlp.fc2):
            _reset_linear(layer, generator)

    def forward(self, x: torch.Tensor, tail: int | None = None) -> torch.Tensor:
        """tail=k returns only the last k rows of the block output (exact)."""
        a = self.attn(self.norm1(x), q_tail=tail)
        x = (x if tail is None else x[:, -tail:]) + a
        return x + self.mlp(self.norm2(x))


class SortTransformer(nn.Module):
    def __init__(self, cfg: SortConfig, trim_last: bool = True):
        super().__init__()
        self.cfg = cfg
        self.trim_last = trim_last
        D = cfg.embed_dim
        self.type_embed = nn.Parameter(torch.zeros(1, 2, D))
        self.blocks = nn.ModuleList(SortBlock(cfg) for _ in range(cfg.depth))
        self.norm = LayerNormF32(D, eps=SORT_LN_EPS)
        self.head = nn.Linear(D, cfg.num_classes)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX package's initializers, drawn from `generator`."""
        nn.init.zeros_(self.type_embed)
        for blk in self.blocks:
            blk.reset_parameters(generator)
        self.norm.reset_parameters()
        _reset_linear(self.head, generator)

    def embed(self, text_tokens: torch.Tensor, video_tokens: torch.Tensor) -> torch.Tensor:
        """[video + type 0 ; text + type 1] in the video tokens' dtype."""
        te = self.type_embed.to(video_tokens.dtype)
        return torch.cat([video_tokens + te[:, 0:1], text_tokens.to(te.dtype) + te[:, 1:2]], 1)

    def classify(self, x_text: torch.Tensor) -> torch.Tensor:
        """norm + head on the text rows [B, n_text, D] -> logits."""
        return linear(self.norm(x_text), self.head.weight, self.head.bias)

    def forward(self, text_tokens: torch.Tensor, video_tokens: torch.Tensor) -> torch.Tensor:
        """text_tokens [B, n_text, D] (detached upstream), video_tokens
        [B, S, D] -> [B, n_text, num_classes]."""
        x = self.embed(text_tokens, video_tokens)
        n_text = text_tokens.shape[1]
        for i, blk in enumerate(self.blocks):
            last = i == len(self.blocks) - 1
            x = blk(x, tail=n_text if self.trim_last and last else None)
        return self.classify(x if self.trim_last else x[:, -n_text:])
