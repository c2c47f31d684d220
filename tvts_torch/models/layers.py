"""Shared building blocks (counterpart of tvts_tpu/models/layers.py).

Numerics contracts, as in the JAX package:
- `LayerNormF32` computes LayerNorm in float32 and casts back to the input
  dtype; its parameters stay float32 whatever the tower's dtype.
- `quick_gelu` is x * sigmoid(1.702 x); "gelu" is the exact erf form.
- `VarAttention` is the qkv/proj pair around divided space-time attention;
  `zero_init=True` is the time-attention init (qkv zeros, proj weight ones);
  `use_pallas=True` runs the space core on the H9 kernel
  (ops/attention_cores.py; forward only), the time core stays plain, as in
  the JAX package.
- `SelfAttention` is plain multi-head attention (text tower), optionally
  causal: masked logits are filled with finfo(float32).min and the softmax
  runs in float32.
- Under tensor parallelism (parallel/tensor_parallel.py) `var_attention`,
  `self_attention` and `mlp` take the module's `tp_group` and this rank's
  slices: the heads and hidden units of its weights' rows (the local head
  count is read off the qkv weight), the row product summed over the group.
  `TP_LAYOUT` names the sharded parameters of each module.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from tvts_torch.ops.attention import (
    divided_space_time_attention,
    full_attention,
    merge_heads,
    split_heads,
)
from tvts_torch.parallel.tensor_parallel import copy_to_tp, row_linear


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def get_activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name == "quick_gelu":
        return quick_gelu
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="none")
    raise ValueError(f"unknown activation {name!r}")


def lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """Flax's default kernel init: truncated normal with variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978  # truncation correction
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)


class LayerNormF32(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def reset_parameters(self) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm_f32(x, self.weight, self.bias, self.eps)


def layer_norm_f32(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps) * weight.float() + bias.float()
    return y.to(x.dtype)


def linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """x @ weight.T + bias in x's dtype (weight in the nn.Linear [out, in] layout)."""
    return F.linear(x, weight.to(x.dtype), bias.to(x.dtype))


def mlp(x: torch.Tensor, wfc: torch.Tensor, bfc: torch.Tensor, wproj: torch.Tensor,
        bproj: torch.Tensor, act: str, tp=None) -> torch.Tensor:
    x = copy_to_tp(x, tp)
    return row_linear(get_activation(act)(linear(x, wfc, bfc)), wproj, bproj, tp)


def var_attention(x: torch.Tensor, wqkv: torch.Tensor, bqkv: torch.Tensor,
                  wproj: torch.Tensor, bproj: torch.Tensor, num_frames: int,
                  patches_per_frame: int, mode: str, num_heads: int,
                  use_pallas: bool = False, tp=None) -> torch.Tensor:
    """proj(divided attention(qkv(x))) on x [B, S, D]; under tp (module
    notes) on the heads of wqkv's rows."""
    d = x.shape[-1] // num_heads
    heads = wqkv.shape[0] // (3 * d)
    q, k, v = linear(copy_to_tp(x, tp), wqkv, bqkv).chunk(3, dim=-1)
    q = split_heads(q * d ** -0.5, heads)
    k = split_heads(k, heads)
    v = split_heads(v, heads)
    if use_pallas and mode == "space":
        # imported here: ops/block_kernels.py imports this module
        from tvts_torch.ops.attention_cores import divided_space_time_attention_fused

        out = divided_space_time_attention_fused(q, k, v, num_frames, patches_per_frame, mode)
    else:
        out = divided_space_time_attention(q, k, v, num_frames, patches_per_frame, mode)
    return row_linear(merge_heads(out), wproj, bproj, tp)


class Mlp(nn.Module):
    """c_fc -> act -> c_proj (CLIP block MLP, hidden = width * mlp_ratio)."""

    TP_LAYOUT = {"c_fc.weight": "col", "c_fc.bias": "col", "c_proj.weight": "row"}
    tp_group = None  # set by parallel/tensor_parallel.tp_shard

    def __init__(self, dim: int, hidden_dim: int, act: str = "quick_gelu"):
        super().__init__()
        self.act = act
        self.c_fc = nn.Linear(dim, hidden_dim)
        self.c_proj = nn.Linear(hidden_dim, dim)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for layer in (self.c_fc, self.c_proj):
            lecun_normal_(layer.weight, layer.in_features, generator)
            nn.init.zeros_(layer.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp(x, self.c_fc.weight, self.c_fc.bias, self.c_proj.weight,
                   self.c_proj.bias, self.act, self.tp_group)


class VarAttention(nn.Module):
    """Divided space/time attention with the CLS row global (ops/attention.py)."""

    TP_LAYOUT = {"qkv.weight": "qkv", "qkv.bias": "qkv", "proj.weight": "row"}
    tp_group = None

    def __init__(self, dim: int, num_heads: int, zero_init: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.zero_init = zero_init
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def reset_parameters(self, generator: torch.Generator) -> None:
        if self.zero_init:
            nn.init.zeros_(self.qkv.weight)
            nn.init.ones_(self.proj.weight)
        else:
            lecun_normal_(self.qkv.weight, self.qkv.in_features, generator)
            lecun_normal_(self.proj.weight, self.proj.in_features, generator)
        nn.init.zeros_(self.qkv.bias)
        nn.init.zeros_(self.proj.bias)

    def forward(self, x: torch.Tensor, num_frames: int, patches_per_frame: int,
                mode: str, use_pallas: bool = False) -> torch.Tensor:
        return var_attention(x, self.qkv.weight, self.qkv.bias, self.proj.weight,
                             self.proj.bias, num_frames, patches_per_frame, mode,
                             self.num_heads, use_pallas, self.tp_group)


def self_attention(x: torch.Tensor, wqkv: torch.Tensor, bqkv: torch.Tensor,
                   wproj: torch.Tensor, bproj: torch.Tensor, num_heads: int,
                   causal: bool = False, q_tail: int | None = None, tp=None) -> torch.Tensor:
    """proj(softmax(q k^T / sqrt(d)) v) on x [B, S, D]. q_tail=k computes the
    outputs of the last k query rows only (k/v still span every row). Under
    tp (module notes) on the heads of wqkv's rows."""
    d = x.shape[-1] // num_heads
    num_heads = wqkv.shape[0] // (3 * d)
    q, k, v = linear(copy_to_tp(x, tp), wqkv, bqkv).chunk(3, dim=-1)
    if q_tail is not None:
        if causal:
            raise ValueError("q_tail is for full (non-causal) attention")
        q = q[:, -q_tail:]
    q = split_heads(q * d ** -0.5, num_heads)
    k = split_heads(k, num_heads)
    v = split_heads(v, num_heads)
    if causal:
        S = x.shape[1]
        keep = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
        logits = (q @ k.transpose(-1, -2)).float().masked_fill(
            ~keep, torch.finfo(torch.float32).min)
        out = torch.softmax(logits, dim=-1).to(x.dtype) @ v
    else:
        out = full_attention(q, k, v)
    return row_linear(merge_heads(out), wproj, bproj, tp)


class SelfAttention(nn.Module):
    """Multi-head self-attention under the reference (nn.MultiheadAttention)
    names: fused in_proj_weight [3D, D] / in_proj_bias, then out_proj."""

    TP_LAYOUT = {"in_proj_weight": "qkv", "in_proj_bias": "qkv", "out_proj.weight": "row"}
    tp_group = None

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * dim))
        self.out_proj = nn.Linear(dim, dim)

    def reset_parameters(self, generator: torch.Generator) -> None:
        lecun_normal_(self.in_proj_weight, self.in_proj_weight.shape[1], generator)
        lecun_normal_(self.out_proj.weight, self.out_proj.in_features, generator)
        nn.init.zeros_(self.in_proj_bias)
        nn.init.zeros_(self.out_proj.bias)

    def forward(self, x: torch.Tensor, causal: bool = False,
                q_tail: int | None = None) -> torch.Tensor:
        return self_attention(x, self.in_proj_weight, self.in_proj_bias,
                              self.out_proj.weight, self.out_proj.bias, self.num_heads,
                              causal, q_tail, self.tp_group)
