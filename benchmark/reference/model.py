"""Plain PyTorch TVTSv2, written from the architecture's description and read
from the reference `.pth` names of a configuration file (benchmark/configs).

It imports nothing of the program: every product goes through a `Numerics`
object, float32 (with TF32 off on the card) for the reference and float8
e4m3 operands with per-tensor scales for the lower-precision control.

- Video tower: patches by a reshape and one product (the patch kernel as a
  matrix), spatial positions tiled over frames plus the temporal embedding,
  the tube keep set applied to every frame, CLS (class embedding plus
  position 0), ln_pre; each block: time attention (a patch's query over the
  CLS key and its own location's T frames), then space attention (over the
  CLS key and its own frame's patches), the CLS query over every token in
  both, both residuals from the block input, then the MLP; pooling "openai"
  (ln_post over every token, then proj; the pooled row is token 0) or
  "openclip" (pooled = ln_post(CLS) proj, tokens = the raw patch rows proj).
- Text tower: token plus position embedding, causal pre-norm blocks,
  ln_final on the EOT row (the largest id), text_projection.
- Sort head: [video tokens + type 0 ; per-clip text + type 1], pre-norm
  blocks with LayerNorm eps 1e-6 and exact GELU, norm, head on the text rows.
Softmax and LayerNorm run in float32 throughout.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

FP8_MAX = 448.0  # largest finite float8 e4m3fn


class no_tf32:
    """Float32 products in float32 on the card (TF32 off) inside the block."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved


class Numerics:
    """The precision of every product: "f32", or "fp8" (both operands
    rounded to float8 e4m3 with a per-tensor scale, then multiplied in
    float32; gradients pass the rounding unchanged)."""

    def __init__(self, mode: str = "f32"):
        if mode not in ("f32", "fp8"):
            raise ValueError(f"unknown numerics {mode!r}")
        self.mode = mode

    def _q(self, t: torch.Tensor) -> torch.Tensor:
        if self.mode == "f32":
            return t
        scale = FP8_MAX / t.detach().abs().amax().clamp_min(1e-12)
        q = (t.detach() * scale).to(torch.float8_e4m3fn).float() / scale
        return t + (q - t).detach()

    def linear(self, x, w, b=None):
        """x @ w.T + b (w in the [out, in] layout)."""
        y = self._q(x) @ self._q(w).t()
        return y if b is None else y + b

    def matmul(self, x, w):
        """x @ w (w in the [in, out] layout)."""
        return self._q(x) @ self._q(w)


def layer_norm(x, w, b, eps: float = 1e-5):
    return F.layer_norm(x.float(), (x.shape[-1],), w.float(), b.float(), eps)


def activation(x, name: str):
    if name == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    if name == "gelu":
        return F.gelu(x)
    raise ValueError(f"unknown activation {name!r}")


def _heads(x, H):
    B, S, D = x.shape
    return x.view(B, S, H, D // H).transpose(1, 2)


def _merge(x):
    B, H, S, d = x.shape
    return x.transpose(1, 2).reshape(B, S, H * d)


def _attend(q, k, v, mask=None):
    logits = q @ k.transpose(-1, -2)
    if mask is not None:
        logits = logits.masked_fill(~mask, float("-inf"))
    return torch.softmax(logits, dim=-1) @ v


def divided_attention(q, k, v, T: int, N: int, mode: str):
    """[B, H, S, d] (q scaled) over S = 1 + T*N frame-major tokens."""
    B, H, S, d = q.shape
    cls = _attend(q[:, :, :1], k, v)
    qp, kp, vp = (t[:, :, 1:].reshape(B, H, T, N, d) for t in (q, k, v))
    if mode == "time":
        qp, kp, vp = (t.transpose(2, 3) for t in (qp, kp, vp))  # [B, H, N, T, d]
    groups, members = qp.shape[2], qp.shape[3]
    ck = k[:, :, :1, None].expand(B, H, groups, 1, d)
    cv = v[:, :, :1, None].expand(B, H, groups, 1, d)
    out = _attend(qp, torch.cat([ck, kp], 3), torch.cat([cv, vp], 3))
    if mode == "time":
        out = out.transpose(2, 3)
    return torch.cat([cls, out.reshape(B, H, T * N, d)], 2)


def _video_attention(num, P, pre, x, T, N, H, mode):
    B, S, D = x.shape
    qkv = num.linear(x, P[f"{pre}.qkv.weight"], P[f"{pre}.qkv.bias"])
    q, k, v = (_heads(t, H) for t in qkv.split(D, dim=-1))
    out = divided_attention(q * (D // H) ** -0.5, k, v, T, N, mode)
    return num.linear(_merge(out), P[f"{pre}.proj.weight"], P[f"{pre}.proj.bias"])


def video_block(num, P, pre, x, v: dict, T: int, N: int):
    H = v["heads"]
    ln = lambda name, t: layer_norm(t, P[f"{pre}.{name}.weight"], P[f"{pre}.{name}.bias"])
    time_out = x + _video_attention(num, P, f"{pre}.timeattn", ln("ln_3", x), T, N, H, "time")
    space = x + _video_attention(num, P, f"{pre}.attn", ln("ln_1", time_out), T, N, H, "space")
    h = activation(num.linear(ln("ln_2", space), P[f"{pre}.mlp.c_fc.weight"],
                              P[f"{pre}.mlp.c_fc.bias"]), v["act"])
    return space + num.linear(h, P[f"{pre}.mlp.c_proj.weight"], P[f"{pre}.mlp.c_proj.bias"])


def video_tower(num, P, v: dict, video, keep, remat: bool = False):
    """(pooled [B, out], tokens [B, S', out]) of clips [B, T, 3, R, R] with
    the keep set [B, n_keep] (indices into a frame's patches)."""
    B, T = video.shape[:2]
    p, D, R = v["patch_size"], v["width"], v["input_resolution"]
    g = R // p
    patches = (video.float().reshape(B, T, 3, g, p, g, p).permute(0, 1, 3, 5, 2, 4, 6)
               .reshape(B, T, g * g, 3 * p * p))
    x = num.linear(patches, P["video_model.conv1.weight"].reshape(D, -1))
    pos = P["video_model.positional_embedding"]
    x = x + pos[None, None, 1:] + P["video_model.temporal_embedding"][None, :T, None]
    idx = keep.long()[:, None, :, None].expand(B, T, keep.shape[1], D)
    x = torch.gather(x, 2, idx)
    N = keep.shape[1]
    cls = (P["video_model.class_embedding"] + pos[0]).expand(B, 1, D)
    x = torch.cat([cls, x.reshape(B, T * N, D)], 1)
    x = layer_norm(x, P["video_model.ln_pre.weight"], P["video_model.ln_pre.bias"])
    for i in range(v["layers"]):
        pre = f"video_model.transformer.resblocks.{i}"
        if remat:
            x = checkpoint(video_block, num, P, pre, x, v, T, N, use_reentrant=False)
        else:
            x = video_block(num, P, pre, x, v, T, N)
    ln = lambda t: layer_norm(t, P["video_model.ln_post.weight"], P["video_model.ln_post.bias"])
    proj = P["video_model.proj"]
    if v["pool_style"] == "openai":
        full = num.matmul(ln(x), proj)
        return full[:, 0], full
    return num.matmul(ln(x[:, 0]), proj), num.matmul(x[:, 1:], proj)


def _self_attention(num, P, pre, x, H, mask, qkv_name, proj_name):
    B, S, D = x.shape
    qkv = num.linear(x, P[f"{pre}.{qkv_name}weight"], P[f"{pre}.{qkv_name}bias"])
    q, k, v = (_heads(t, H) for t in qkv.split(D, dim=-1))
    out = _attend(q * (D // H) ** -0.5, k, v, mask)
    return num.linear(_merge(out), P[f"{pre}.{proj_name}.weight"], P[f"{pre}.{proj_name}.bias"])


def text_block(num, P, pre, x, t: dict):
    S = x.shape[1]
    mask = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    ln = lambda name, y: layer_norm(y, P[f"{pre}.{name}.weight"], P[f"{pre}.{name}.bias"])
    x = x + _self_attention(num, P, f"{pre}.attn", ln("ln_1", x), t["heads"], mask,
                            "in_proj_", "out_proj")
    h = activation(num.linear(ln("ln_2", x), P[f"{pre}.mlp.c_fc.weight"],
                              P[f"{pre}.mlp.c_fc.bias"]), t["act"])
    return x + num.linear(h, P[f"{pre}.mlp.c_proj.weight"], P[f"{pre}.mlp.c_proj.bias"])


def text_tower(num, P, t: dict, ids, remat: bool = False):
    """[n, ctx] token ids -> [n, out] caption embeddings."""
    x = P["text_token_embedding.weight"][ids.long()] + P["text_positional_embedding"]
    for i in range(t["layers"]):
        pre = f"text_model.resblocks.{i}"
        if remat:
            x = checkpoint(text_block, num, P, pre, x, t, use_reentrant=False)
        else:
            x = text_block(num, P, pre, x, t)
    eot = x[torch.arange(x.shape[0], device=x.device), ids.long().argmax(-1)]
    eot = layer_norm(eot, P["text_ln_final.weight"], P["text_ln_final.bias"])
    return num.matmul(eot, P["text_projection"])


def sort_head(num, P, s: dict, text, video_tokens):
    """text [B, n, E], video tokens [B, S', E] -> [B, n, classes] logits."""
    te = P["pred_model.type_embed"]
    x = torch.cat([video_tokens + te[:, 0:1], text + te[:, 1:2]], 1)
    for i in range(s["depth"]):
        pre = f"pred_model.blocks.{i}"
        ln = lambda name, y: layer_norm(y, P[f"{pre}.{name}.weight"], P[f"{pre}.{name}.bias"],
                                        1e-6)
        x = x + _self_attention(num, P, f"{pre}.attn", ln("norm1", x), s["num_heads"], None,
                                "qkv.", "proj")
        h = F.gelu(num.linear(ln("norm2", x), P[f"{pre}.mlp.fc1.weight"],
                              P[f"{pre}.mlp.fc1.bias"]))
        x = x + num.linear(h, P[f"{pre}.mlp.fc2.weight"], P[f"{pre}.mlp.fc2.bias"])
    x = layer_norm(x[:, -text.shape[1]:], P["pred_model.norm.weight"],
                   P["pred_model.norm.bias"], 1e-6)
    return num.linear(x, P["pred_model.head.weight"], P["pred_model.head.bias"])


def forward(num, P, cfg: dict, batch: dict, remat: bool = False):
    """The training forward: (text_emb [B, out], video_emb [B, out],
    sort logits [B, n, n] or None). Caption ids are clip-major [n * B, ctx];
    the contrastive text embedding is the mean over a clip's n captions, and
    the sort head reads them detached."""
    video = batch["video"]
    B = video.shape[0]
    text = text_tower(num, P, cfg["text"], batch["text_ids"], remat)
    n = text.shape[0] // B
    per_clip = text.view(n, B, -1)
    pooled, tokens = video_tower(num, P, cfg["vision"], video, batch["keep_ind"], remat)
    order = None
    if n > 1:
        order = sort_head(num, P, cfg["sort"], per_clip.detach().transpose(0, 1), tokens)
    return per_clip.mean(0), pooled, order
