"""CLIP-compatible text tower (counterpart of tvts_tpu/models/text.py).

token embedding + positional embedding (in the tower dtype) -> causal
pre-norm blocks -> ln_final -> the feature at the EOT position (argmax of the
token ids: EOT is the largest id) -> @ text_projection ([width, out], not
transposed). The OpenCLIP H/14 tower differs only in its activation.

Parameter names are the reference `.pth` names, where the text tower sits at
the top level of the model beside `video_model`: `text_token_embedding`,
`text_positional_embedding`, `text_model.resblocks.{i}`, `text_ln_final`,
`text_projection`. So `TVTSv2` (models/tvts_v2.py) extends this module.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from tvts_torch.models.configs import TextConfig
from tvts_torch.models.layers import LayerNormF32, Mlp, SelfAttention


class TextBlock(nn.Module):
    def __init__(self, cfg: TextConfig):
        super().__init__()
        self.ln_1 = LayerNormF32(cfg.width)
        self.attn = SelfAttention(cfg.width, cfg.heads)
        self.ln_2 = LayerNormF32(cfg.width)
        self.mlp = Mlp(cfg.width, 4 * cfg.width, act=cfg.act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), causal=True)
        return x + self.mlp(self.ln_2(x))


class TextBlocks(nn.Module):
    """The reference's `text_model` (CLIP `Transformer`): the blocks only."""

    def __init__(self, cfg: TextConfig):
        super().__init__()
        self.resblocks = nn.ModuleList(TextBlock(cfg) for _ in range(cfg.layers))


class TextTransformer(nn.Module):
    def __init__(self, cfg: TextConfig, remat: bool = False):
        super().__init__()
        self.text_cfg = cfg
        self.remat = remat  # checkpoint each block where autograd records
        self.compute_dtype: torch.dtype | None = None  # None: the weights' dtype
        self.text_token_embedding = nn.Embedding(cfg.vocab_size, cfg.width)
        self.text_positional_embedding = nn.Parameter(
            torch.empty(cfg.context_length, cfg.width))
        self.text_model = TextBlocks(cfg)
        self.text_ln_final = LayerNormF32(cfg.width)
        self.text_projection = nn.Parameter(torch.empty(cfg.width, cfg.output_dim))

    @torch.no_grad()
    def reset_text_parameters(self, generator: torch.Generator) -> None:
        """The JAX package's initializers, drawn from `generator`."""
        cfg = self.text_cfg
        self.text_token_embedding.weight.normal_(0.0, cfg.width ** -0.5, generator=generator)
        self.text_positional_embedding.normal_(0.0, 0.01, generator=generator)
        for blk in self.text_model.resblocks:
            blk.ln_1.reset_parameters()
            blk.ln_2.reset_parameters()
            blk.attn.reset_parameters(generator)
            blk.mlp.reset_parameters(generator)
        self.text_ln_final.reset_parameters()
        self.text_projection.normal_(0.0, cfg.width ** -0.5, generator=generator)

    def embed_tokens(self, token_ids: torch.Tensor) -> torch.Tensor:
        """[B, ctx] ids -> token + positional embedding [B, ctx, width]."""
        weight = self.text_token_embedding.weight
        dtype = self.compute_dtype or weight.dtype
        return (F.embedding(token_ids.long(), weight).to(dtype)
                + self.text_positional_embedding.to(dtype))

    def project_text(self, x_eot: torch.Tensor) -> torch.Tensor:
        """ln_final, then @ text_projection, on the EOT rows [B, width]."""
        return self.text_ln_final(x_eot) @ self.text_projection.to(x_eot.dtype)

    def compute_text(self, token_ids: torch.Tensor) -> torch.Tensor:
        """[N, ctx] ids -> [N, output_dim] text embeddings (not normalised)."""
        x = self.embed_tokens(token_ids)
        remat = self.remat and torch.is_grad_enabled()
        for blk in self.text_model.resblocks:
            x = checkpoint(blk, x, use_reentrant=False) if remat else blk(x)
        eot = token_ids.long().argmax(dim=-1)
        return self.project_text(x[torch.arange(x.shape[0], device=x.device), eot])

    def forward(self, token_ids: torch.Tensor) -> torch.Tensor:
        return self.compute_text(token_ids)
