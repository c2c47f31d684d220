"""Divided space-time attention video ViT (counterpart of
tvts_tpu/models/space_time_vit.py).

- "openai" pool (B/32, B/16): ln_post over all tokens, then proj; the pooled
  embedding is projected token 0.
- "openclip" pool (H/14): pooled = ln_post(CLS) @ proj; tokens = raw patch
  tokens @ proj.
- Both block residuals branch from the block input x, not chained.
- Spatial positional embedding tiled over frames, temporal embedding repeated
  over patches, one tube keep set for every frame.

Parameter names are the reference `.pth` names (`video_model.` stripped), so a
released checkpoint loads with `load_state_dict(strict=True)`. The compute
dtype is `compute_dtype` when set (bf16 activations over f32 master weights,
the training setup), else the dtype of the weights; LayerNorm parameters and LayerScale gammas
stay float32.

H/14 options that no shipped config enables (surface parity with the JAX
package): `LayerScale` (`ls_3`, `ls_1`, `ls_2` on the three sub-path outputs
when `ls_init` is set), `PatchDropout` (training only: the CLS token plus a
random `1 - prob` share of the rest, drawn from an explicit torch.Generator)
and `AttentionalPooler` (learned queries cross-attending the tokens; then
ln_post over the pooled tokens and an [out, out] proj).
`remat=True` checkpoints each block (torch.utils.checkpoint) where autograd
records; `use_pallas=True` runs the space attention core on the H9 kernel
(ops/attention_cores.py; forward only, as in the JAX package: on the card
it raises under autograd rather than drop gradients).
`token_partition=(("dp", "fsdp"), "sp", None)`, the JAX spec, splits the
tokens between the stem and `pool` over the active mesh's sp group
(parallel/sequence_parallel.py); `sp_parameters()` are the tensors used in
that window, whose gradients the train step sums over sp.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from tvts_torch.models.configs import VisionConfig
from tvts_torch.models.layers import LayerNormF32, Mlp, VarAttention, lecun_normal_, linear
from tvts_torch.ops.attention import full_attention, merge_heads, split_heads
from tvts_torch.ops.masking import gather_tube_tokens
from tvts_torch.parallel.sequence_parallel import check_partition, token_shard


class LayerScale(nn.Module):
    """x * gamma, gamma float32 whatever the tower's dtype."""

    def __init__(self, dim: int, init_value: float):
        super().__init__()
        self.init_value = init_value
        self.gamma = nn.Parameter(torch.full((dim,), float(init_value)))

    def reset_parameters(self) -> None:
        nn.init.constant_(self.gamma, self.init_value)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma.to(x.dtype)


class PatchDropout(nn.Module):
    """Training-time random token dropout (https://arxiv.org/abs/2212.00794):
    keeps the first (CLS) token and, per sample, `max(1, int(L * (1 - prob)))`
    of the L others: the top-k indices of a normal draw from `generator`.
    Identity in eval mode or at prob 0."""

    def __init__(self, prob: float):
        super().__init__()
        self.prob = prob

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None):
        if not self.training or self.prob == 0.0:
            return x
        cls_tokens, patches = x[:, :1], x[:, 1:]
        B, L, D = patches.shape
        num_keep = max(1, int(L * (1.0 - self.prob)))
        device = generator.device if generator is not None else x.device
        rand = torch.randn(B, L, generator=generator, device=device)
        keep = rand.topk(num_keep, dim=-1).indices.to(x.device)
        kept = patches.gather(1, keep[..., None].expand(-1, -1, D))
        return torch.cat([cls_tokens, kept], dim=1)


class _PoolerAttention(nn.Module):
    """The parameters of nn.MultiheadAttention(E, heads, kdim=vdim=W) under
    its names: separate q/k/v projection weights, one fused in_proj_bias."""

    def __init__(self, d_model: int, context_dim: int):
        super().__init__()
        self.q_proj_weight = nn.Parameter(torch.empty(d_model, d_model))
        self.k_proj_weight = nn.Parameter(torch.empty(d_model, context_dim))
        self.v_proj_weight = nn.Parameter(torch.empty(d_model, context_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)


class AttentionalPooler(nn.Module):
    """Query-token cross-attention pooler (OpenCLIP AttentionalPooler):
    x [B, L, W] -> [B, n_queries, d_model]."""

    def __init__(self, d_model: int, context_dim: int, n_head: int = 8, n_queries: int = 256):
        super().__init__()
        self.n_head = n_head
        self.query = nn.Parameter(torch.empty(n_queries, d_model))
        self.ln_q = LayerNormF32(d_model)
        self.ln_k = LayerNormF32(context_dim)
        self.attn = _PoolerAttention(d_model, context_dim)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.query.normal_(0.0, 1.0, generator=generator)
        self.ln_q.reset_parameters()
        self.ln_k.reset_parameters()
        a = self.attn
        for w in (a.q_proj_weight, a.k_proj_weight, a.v_proj_weight, a.out_proj.weight):
            lecun_normal_(w, w.shape[1], generator)
        nn.init.zeros_(a.in_proj_bias)
        nn.init.zeros_(a.out_proj.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, E = self.attn, self.query.shape[1]
        d = E // self.n_head
        bq, bk, bv = a.in_proj_bias.chunk(3)
        q = self.ln_q(self.query[None].to(x.dtype))
        kx = self.ln_k(x)
        qh = split_heads(linear(q, a.q_proj_weight, bq) * d ** -0.5, self.n_head)
        kh = split_heads(linear(kx, a.k_proj_weight, bk), self.n_head)
        vh = split_heads(linear(kx, a.v_proj_weight, bv), self.n_head)
        out = full_attention(qh.expand(x.shape[0], -1, -1, -1), kh, vh)
        return linear(merge_heads(out), a.out_proj.weight, a.out_proj.bias)


class SpaceTimeBlock(nn.Module):
    def __init__(self, cfg: VisionConfig):
        super().__init__()
        D = cfg.width
        self.ln_3 = LayerNormF32(D)
        self.timeattn = VarAttention(D, cfg.heads, zero_init=True)
        self.ln_1 = LayerNormF32(D)
        self.attn = VarAttention(D, cfg.heads)
        self.ln_2 = LayerNormF32(D)
        self.mlp = Mlp(D, int(D * cfg.mlp_ratio), act=cfg.act)
        for name in ("ls_3", "ls_1", "ls_2"):
            setattr(self, name, nn.Identity() if cfg.ls_init is None
                    else LayerScale(D, cfg.ls_init))

    def forward(self, x: torch.Tensor, num_frames: int, patches_per_frame: int,
                use_pallas: bool = False, sp=None) -> torch.Tensor:
        t_out = self.timeattn(self.ln_3(x), num_frames, patches_per_frame, "time", use_pallas,
                              sp)
        time_residual = x + self.ls_3(t_out)
        s_out = self.attn(self.ln_1(time_residual), num_frames, patches_per_frame,
                          "space", use_pallas, sp)
        space_residual = x + self.ls_1(s_out)  # both residuals branch from the block input
        return space_residual + self.ls_2(self.mlp(self.ln_2(space_residual)))


class Transformer(nn.Module):
    def __init__(self, cfg: VisionConfig):
        super().__init__()
        self.resblocks = nn.ModuleList(SpaceTimeBlock(cfg) for _ in range(cfg.layers))


class SpaceTimeViT(nn.Module):
    def __init__(self, cfg: VisionConfig, remat: bool = False, use_pallas: bool = False,
                 token_partition: tuple | None = None):
        super().__init__()
        if cfg.pool_style not in ("openai", "openclip"):
            raise ValueError(f"unknown pool_style {cfg.pool_style!r}")
        self.cfg = cfg
        self.remat = remat
        self.use_pallas = use_pallas  # the H9 space core (forward only)
        self.token_partition = check_partition(token_partition)
        self.compute_dtype: torch.dtype | None = None
        D, p = cfg.width, cfg.patch_size
        self.conv1 = nn.Conv2d(3, D, kernel_size=p, stride=p, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(D))
        self.positional_embedding = nn.Parameter(
            torch.empty(cfg.patches_per_frame + 1, D))
        self.temporal_embedding = nn.Parameter(torch.empty(cfg.num_frames, D))
        if cfg.patch_dropout > 0:
            self.patch_dropout = PatchDropout(cfg.patch_dropout)
        self.ln_pre = LayerNormF32(D)
        self.transformer = Transformer(cfg)
        if cfg.attentional_pool:
            # the pooler's queries live in the output width: ln_post and proj follow it
            self.attn_pool = AttentionalPooler(cfg.output_dim, D, n_head=cfg.attn_pooler_heads,
                                               n_queries=cfg.n_queries)
            D = cfg.output_dim
        self.ln_post = LayerNormF32(D)
        self.proj = nn.Parameter(torch.empty(D, cfg.output_dim))

    @property
    def dtype(self) -> torch.dtype:
        return self.compute_dtype or self.conv1.weight.dtype

    def sp_parameters(self) -> list:
        """The parameters used between the token split and the gather: the
        stem and every block (none without a token partition)."""
        if self.token_partition is None:
            return []
        stem = [self.conv1.weight, self.class_embedding, self.positional_embedding,
                self.temporal_embedding, *self.ln_pre.parameters()]
        return stem + list(self.transformer.parameters())

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX package's initializers, drawn from `generator`."""
        cfg = self.cfg
        lecun_normal_(self.conv1.weight, 3 * cfg.patch_size ** 2, generator)
        scale = cfg.width ** -0.5
        for p in (self.class_embedding, self.positional_embedding,
                  self.temporal_embedding):
            p.normal_(0.0, scale, generator=generator)
        for blk in self.transformer.resblocks:
            for ln in (blk.ln_3, blk.ln_1, blk.ln_2):
                ln.reset_parameters()
            blk.timeattn.reset_parameters(generator)
            blk.attn.reset_parameters(generator)
            blk.mlp.reset_parameters(generator)
            if cfg.ls_init is not None:
                for ls in (blk.ls_3, blk.ls_1, blk.ls_2):
                    ls.reset_parameters()
        if cfg.attentional_pool:
            self.attn_pool.reset_parameters(generator)
        self.ln_pre.reset_parameters()
        self.ln_post.reset_parameters()
        self.proj.normal_(0.0, scale, generator=generator)

    def embed(self, video: torch.Tensor, keep_ind: torch.Tensor | None = None,
              generator: torch.Generator | None = None) -> torch.Tensor:
        """The stem: patchify + pos/temporal embed + tube mask + CLS
        (+ PatchDropout, drawing from `generator`) + ln_pre.
        video: [B, T, C, H, W] (or [B, C, H, W]). Returns [B, 1+T*n, D]."""
        cfg = self.cfg
        if video.ndim == 4:
            video = video[:, None]
        B, T, C, H, W = video.shape
        dtype = self.dtype
        x = F.conv2d(video.reshape(B * T, C, H, W).to(dtype), self.conv1.weight.to(dtype),
                     stride=cfg.patch_size)                  # [BT, D, h, w]
        x = x.flatten(2).transpose(1, 2).reshape(B, T, -1, cfg.width)
        pos = self.positional_embedding.float()
        x = x + (pos[None, None, 1:]
                 + self.temporal_embedding.float()[None, :T, None]).to(dtype)
        if keep_ind is not None:
            x = gather_tube_tokens(x, keep_ind)
        cls = (self.class_embedding.float() + pos[0]).to(dtype)
        x = torch.cat([cls.expand(B, 1, cfg.width), x.reshape(B, -1, cfg.width)], 1)
        if cfg.patch_dropout > 0:
            x = self.patch_dropout(x, generator)
        return self.ln_pre(x)

    def pool(self, x: torch.Tensor, need_tokens: bool = True):
        """(pooled [B, out], tokens or None) from the tower output x [B, S, D].
        With need_tokens=False only row 0 is normalised and projected (exact:
        LayerNorm is per token)."""
        proj = self.proj.to(x.dtype)
        if self.cfg.attentional_pool:
            x = self.ln_post(self.attn_pool(x))
            return x[:, 0] @ proj, (x[:, 1:] @ proj if need_tokens else None)
        if self.cfg.pool_style == "openai":
            if not need_tokens:
                return self.ln_post(x[:, :1])[:, 0] @ proj, None
            full = self.ln_post(x) @ proj
            return full[:, 0], full
        pooled = self.ln_post(x[:, :1])[:, 0] @ proj
        return pooled, (x[:, 1:] @ proj if need_tokens else None)

    def forward(self, video: torch.Tensor, keep_ind: torch.Tensor | None = None,
                generator: torch.Generator | None = None):
        """Returns (pooled [B, out], order_tokens [B, S', out])."""
        x = self.embed(video, keep_ind, generator)
        T = video.shape[1] if video.ndim == 5 else 1
        n_keep = (x.shape[1] - 1) // T
        sp = token_shard(self.token_partition, x.shape[1])
        if sp is not None:
            x = sp.split(x)
        remat = self.remat and torch.is_grad_enabled()
        for blk in self.transformer.resblocks:
            if remat:
                x = checkpoint(blk, x, T, n_keep, self.use_pallas, sp, use_reentrant=False)
            else:
                x = blk(x, T, n_keep, self.use_pallas, sp)
        if sp is not None:
            x = sp.gather(x)
        return self.pool(x)
