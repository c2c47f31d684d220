"""Plain PyTorch VideoMAE V2 fine-tuning forward, written from the published
module (VideoMAEv2 models/modeling_finetune.py: `PatchEmbed`, `Attention`,
`Block`, `VisionTransformer.forward_features` and `forward`, at
`vit_giant_patch14_224`'s sizes or any configuration file of the same
form), read from the published parameter names: `patch_embed.proj.*`,
`blocks.{i}.norm1`, `.attn.qkv.weight` (no bias), `.attn.q_bias`,
`.attn.v_bias`, `.attn.proj`, `.norm2`, `.mlp.fc1`, `.mlp.fc2`, `fc_norm`,
`head`.

It imports nothing of the program. Every weight product goes through a
`Numerics` object (reference/model.py): float32 with TF32 off for the
reference, float8 e4m3 operands for the lower-precision control.

- Stem: the tubelet patches by a reshape and one product (the Conv3d kernel
  [D, 3, t, p, p] as a matrix; the same sum as the published Conv3d, whose
  kernel equals its stride), tokens in (tube, h, w) order, plus the fixed
  sinusoid table (`get_sinusoid_encoding_table`).
- Each block: x + proj(softmax(q k^T / sqrt(d)) v) of norm1(x), with the qkv
  bias [q_bias, 0, v_bias], then x + fc2(gelu(fc1(norm2(x)))); LayerNorm eps
  1e-6 and exact GELU; no LayerScale (`init_values` 0).
- Pooling: the token mean, `fc_norm`, `head`.
Departures from the published module: dropout, drop-path and the head's
dropout are left out (they are identities at eval); the input is [B, T, 3,
R, R] (the port's layout) where the module takes [B, 3, T, R, R]; softmax,
LayerNorm and the attention products run in float32 throughout.

`make_weights` draws seeded weights under the published names on the device
(as benchmark/weights.py draws TVTSv2's): matrices and the patch kernel
N(0, 1 / fan_in), the head too (not the published 0.001 init scale, so the
logits are not near zero), LayerNorm weights 1 + N(0, 0.1^2), every bias
N(0, 0.02^2); `served` rounds all but the LayerNorm parameters to bfloat16.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.model import Numerics, layer_norm

LN_EPS = 1e-6


def hidden_dim(cfg: dict) -> int:
    """The MLP's width, int(embed_dim * mlp_ratio) as the module computes it."""
    return int(cfg["embed_dim"] * cfg["mlp_ratio"])


def tokens(cfg: dict) -> int:
    """Tokens a clip: tubes times patches a frame."""
    return (cfg["num_frames"] // cfg["tubelet_size"]) * (cfg["img_size"] // cfg["patch_size"]) ** 2


def layout(cfg: dict) -> list[tuple[str, tuple, object]]:
    """(name, shape, scale) of every leaf; scale a float (std of the leaf),
    "ln" (1 + N(0, 0.1^2)) or None (a bias: N(0, 0.02^2))."""
    D, p, t = cfg["embed_dim"], cfg["patch_size"], cfg["tubelet_size"]
    hidden, fan = hidden_dim(cfg), 3 * t * p * p
    ln = lambda name: [(f"{name}.weight", (D,), "ln"), (f"{name}.bias", (D,), None)]  # noqa: E731
    leaves = [("patch_embed.proj.weight", (D, 3, t, p, p), fan ** -0.5),
              ("patch_embed.proj.bias", (D,), None)]
    for i in range(cfg["depth"]):
        b = f"blocks.{i}"
        leaves += [*ln(f"{b}.norm1"), (f"{b}.attn.qkv.weight", (3 * D, D), D ** -0.5),
                   (f"{b}.attn.q_bias", (D,), None), (f"{b}.attn.v_bias", (D,), None),
                   (f"{b}.attn.proj.weight", (D, D), D ** -0.5),
                   (f"{b}.attn.proj.bias", (D,), None),
                   *ln(f"{b}.norm2"), (f"{b}.mlp.fc1.weight", (hidden, D), D ** -0.5),
                   (f"{b}.mlp.fc1.bias", (hidden,), None),
                   (f"{b}.mlp.fc2.weight", (D, hidden), hidden ** -0.5),
                   (f"{b}.mlp.fc2.bias", (D,), None)]
    return leaves + [*ln("fc_norm"), ("head.weight", (cfg["num_classes"], D), D ** -0.5),
                     ("head.bias", (cfg["num_classes"],), None)]


def make_weights(cfg: dict, seed: int, device, served: bool = False) -> dict[str, torch.Tensor]:
    """name -> tensor on `device`, drawn leaf by leaf in `layout` order from
    one normal generator seeded with `seed` (module notes), so no more than
    one leaf is held in float32 beside the served ones."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for name, shape, scale in layout(cfg):
        z = torch.randn(shape, generator=gen, device=device)
        leaf = z.mul_(0.1).add_(1.0) if scale == "ln" else z.mul_(0.02 if scale is None else scale)
        if served and "norm" not in name:
            leaf = leaf.to(torch.bfloat16)
        out[name] = leaf
    return out


def sinusoid_table(n_position: int, d_hid: int, device=None) -> torch.Tensor:
    """get_sinusoid_encoding_table: [n_position, d_hid] float32, angles in float64."""
    pos = torch.arange(n_position, dtype=torch.float64, device=device)[:, None]
    i = torch.arange(d_hid, device=device)
    angle = pos / torch.pow(10000.0, (2 * (i // 2)).double() / d_hid)
    table = torch.where(i % 2 == 0, torch.sin(angle), torch.cos(angle))
    return table.float()


def _block(num: Numerics, P: dict, pre: str, x: torch.Tensor, heads: int) -> torch.Tensor:
    B, S, D = x.shape
    y = layer_norm(x, P[f"{pre}.norm1.weight"], P[f"{pre}.norm1.bias"], LN_EPS)
    q_bias, v_bias = P[f"{pre}.attn.q_bias"].float(), P[f"{pre}.attn.v_bias"].float()
    qkv_bias = torch.cat([q_bias, torch.zeros_like(v_bias), v_bias])
    qkv = num.linear(y, P[f"{pre}.attn.qkv.weight"].float(), qkv_bias)
    q, k, v = qkv.view(B, S, 3, heads, D // heads).permute(2, 0, 3, 1, 4)
    attn = torch.softmax((q * (D // heads) ** -0.5) @ k.transpose(-1, -2), dim=-1) @ v
    attn = attn.transpose(1, 2).reshape(B, S, D)
    x = x + num.linear(attn, P[f"{pre}.attn.proj.weight"].float(),
                       P[f"{pre}.attn.proj.bias"].float())
    y = layer_norm(x, P[f"{pre}.norm2.weight"], P[f"{pre}.norm2.bias"], LN_EPS)
    h = F.gelu(num.linear(y, P[f"{pre}.mlp.fc1.weight"].float(), P[f"{pre}.mlp.fc1.bias"].float()))
    return x + num.linear(h, P[f"{pre}.mlp.fc2.weight"].float(), P[f"{pre}.mlp.fc2.bias"].float())


def forward(num: Numerics, P: dict, cfg: dict, video: torch.Tensor):
    """(logits [B, classes], features [B, D]) of clips [B, T, 3, R, R], in
    float32; `features` is fc_norm's output, the head's input."""
    B, T = video.shape[:2]
    D, p, t = cfg["embed_dim"], cfg["patch_size"], cfg["tubelet_size"]
    g = cfg["img_size"] // p
    patches = (video.float().reshape(B, T // t, t, 3, g, p, g, p)
               .permute(0, 1, 4, 6, 3, 2, 5, 7).reshape(B, (T // t) * g * g, 3 * t * p * p))
    x = num.linear(patches, P["patch_embed.proj.weight"].float().reshape(D, -1),
                   P["patch_embed.proj.bias"].float())
    x = x + sinusoid_table(x.shape[1], D, x.device)
    for i in range(cfg["depth"]):
        x = _block(num, P, f"blocks.{i}", x, cfg["num_heads"])
    features = layer_norm(x.mean(1), P["fc_norm.weight"], P["fc_norm.bias"], LN_EPS)
    logits = num.linear(features, P["head.weight"].float(), P["head.bias"].float())
    return logits, features
