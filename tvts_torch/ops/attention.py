"""Divided space-time attention in plain PyTorch (counterpart of
tvts_tpu/ops/attention.py).

Over a token stream ``[CLS, f0p0..f0pN, f1p0.., ...]`` (frame-major):
- the CLS query attends to every token (global attention);
- patch queries attend within their group -- all patches of the same frame
  ("space") or the same spatial location across frames ("time") -- plus the
  CLS key/value, spliced into every group's softmax.
Softmax runs in float32 whatever the compute dtype.
"""

from __future__ import annotations

import torch


def _softmax_f32(logits: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return torch.softmax(logits.float(), dim=-1).to(dtype)


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain softmax attention. q,k,v: [..., S, d] (q pre-scaled)."""
    p = _softmax_f32(q @ k.transpose(-1, -2), q.dtype)
    return p @ v


def divided_space_time_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 num_frames: int, patches_per_frame: int,
                                 mode: str) -> torch.Tensor:
    """One divided-attention pass ('time' or 'space').

    q, k, v: [B, H, S, d] with S = 1 + num_frames * patches_per_frame,
    frame-major patches, q pre-scaled by 1/sqrt(d). Returns [B, H, S, d].
    """
    B, H, S, d = q.shape
    T, N = num_frames, patches_per_frame
    if S != 1 + T * N:
        raise ValueError(f"token count {S} != 1 + {T}*{N}")

    cls_out = full_attention(q[:, :, :1], k, v)  # [B, H, 1, d]
    cls_k, cls_v = k[:, :, 0], v[:, :, 0]        # [B, H, d]

    q5 = q[:, :, 1:].reshape(B, H, T, N, d)
    k5 = k[:, :, 1:].reshape(B, H, T, N, d)
    v5 = v[:, :, 1:].reshape(B, H, T, N, d)

    if mode == "space":
        logits = torch.einsum("bhtnd,bhtmd->bhtnm", q5, k5)
        cls_l = torch.einsum("bhtnd,bhd->bhtn", q5, cls_k)
        p = _softmax_f32(torch.cat([cls_l[..., None], logits], -1), q.dtype)
        out = torch.einsum("bhtnm,bhtmd->bhtnd", p[..., 1:], v5)
        out = out + p[..., 0][..., None] * cls_v[:, :, None, None, :]
    elif mode == "time":
        def fold(x):  # [B,H,T,N,d] -> [B*H*N, T, d]
            return x.permute(0, 1, 3, 2, 4).reshape(B * H * N, T, d)

        qg, kg, vg = fold(q5), fold(k5), fold(v5)
        ck = cls_k.reshape(B * H, 1, d).repeat_interleave(N, dim=0)
        cv = cls_v.reshape(B * H, 1, d).repeat_interleave(N, dim=0)
        p = _softmax_f32(qg @ torch.cat([ck, kg], 1).transpose(-1, -2), q.dtype)
        out = p @ torch.cat([cv, vg], 1)
        out = out.reshape(B, H, N, T, d).permute(0, 1, 3, 2, 4)
    else:
        raise ValueError(f"unknown mode {mode!r}")

    return torch.cat([cls_out, out.reshape(B, H, T * N, d)], dim=2)


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, S, D] -> [B, H, S, d]."""
    B, S, D = x.shape
    return x.reshape(B, S, num_heads, D // num_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, H, S, d] -> [B, S, D]."""
    B, H, S, d = x.shape
    return x.transpose(1, 2).reshape(B, S, H * d)
