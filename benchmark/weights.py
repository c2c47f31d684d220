"""Seeded weights under the reference `.pth` names of a TVTSv2 configuration.

The names and shapes follow from the configuration file alone (the layout of
the released checkpoints: `video_model.*`, the text tower at the top level,
`pred_model.*`), so the program loads them with its strict `load_state_dict`
and the plain reference reads them by name. All values come from one normal
draw on the device, from a generator seeded with the run's seed, split into
the leaves and scaled per leaf:

- matrices and the patch kernel: N(0, 1 / fan_in);
- embeddings and projections: N(0, 1 / width) (token embedding N(0, 0.02^2),
  text positions N(0, 0.01^2), the sort head's type embedding N(0, 0.02^2));
- LayerNorm weights 1 + N(0, 0.1^2), every bias N(0, 0.02^2).

Served weights (`served`) are the matrices, biases and embeddings rounded to
bfloat16 (the extraction path's type) with the LayerNorm parameters kept
float32; training keeps every leaf float32 (the masters).
"""

from __future__ import annotations

import torch

LN_KEYS = ("ln_", "norm")


def _linear(prefix: str, n_out: int, n_in: int) -> list:
    return [(f"{prefix}.weight", (n_out, n_in), n_in ** -0.5), (f"{prefix}.bias", (n_out,), None)]


def _ln(prefix: str, width: int) -> list:
    return [(f"{prefix}.weight", (width,), "ln"), (f"{prefix}.bias", (width,), None)]


def layout(cfg: dict) -> list[tuple[str, tuple, object]]:
    """(name, shape, scale) of every leaf; scale a float (std of the leaf),
    "ln" (1 + N(0, 0.1^2)) or None (a bias: N(0, 0.02^2))."""
    v, t, s = cfg["vision"], cfg["text"], cfg["sort"]
    D, p, out = v["width"], v["patch_size"], v["output_dim"]
    hidden = int(D * v["mlp_ratio"])
    n = (v["input_resolution"] // p) ** 2
    leaves = [("video_model.conv1.weight", (D, 3, p, p), (3 * p * p) ** -0.5),
              ("video_model.class_embedding", (D,), D ** -0.5),
              ("video_model.positional_embedding", (n + 1, D), D ** -0.5),
              ("video_model.temporal_embedding", (v["num_frames"], D), D ** -0.5),
              *_ln("video_model.ln_pre", D)]
    for i in range(v["layers"]):
        b = f"video_model.transformer.resblocks.{i}"
        leaves += [*_ln(f"{b}.ln_3", D), *_linear(f"{b}.timeattn.qkv", 3 * D, D),
                   *_linear(f"{b}.timeattn.proj", D, D), *_ln(f"{b}.ln_1", D),
                   *_linear(f"{b}.attn.qkv", 3 * D, D), *_linear(f"{b}.attn.proj", D, D),
                   *_ln(f"{b}.ln_2", D), *_linear(f"{b}.mlp.c_fc", hidden, D),
                   *_linear(f"{b}.mlp.c_proj", D, hidden)]
    leaves += [*_ln("video_model.ln_post", D), ("video_model.proj", (D, out), D ** -0.5)]
    W = t["width"]
    leaves += [("text_token_embedding.weight", (t["vocab_size"], W), 0.02),
               ("text_positional_embedding", (t["context_length"], W), 0.01)]
    for i in range(t["layers"]):
        b = f"text_model.resblocks.{i}"
        leaves += [*_ln(f"{b}.ln_1", W), (f"{b}.attn.in_proj_weight", (3 * W, W), W ** -0.5),
                   (f"{b}.attn.in_proj_bias", (3 * W,), None),
                   *_linear(f"{b}.attn.out_proj", W, W), *_ln(f"{b}.ln_2", W),
                   *_linear(f"{b}.mlp.c_fc", 4 * W, W), *_linear(f"{b}.mlp.c_proj", W, 4 * W)]
    leaves += [*_ln("text_ln_final", W), ("text_projection", (W, t["output_dim"]), W ** -0.5)]
    E = s["embed_dim"]
    sh = int(E * s["mlp_ratio"])
    leaves += [("pred_model.type_embed", (1, 2, E), 0.02)]
    for i in range(s["depth"]):
        b = f"pred_model.blocks.{i}"
        leaves += [*_ln(f"{b}.norm1", E), *_linear(f"{b}.attn.qkv", 3 * E, E),
                   *_linear(f"{b}.attn.proj", E, E), *_ln(f"{b}.norm2", E),
                   *_linear(f"{b}.mlp.fc1", sh, E), *_linear(f"{b}.mlp.fc2", E, sh)]
    leaves += [*_ln("pred_model.norm", E), *_linear("pred_model.head", s["num_classes"], E)]
    return leaves


def is_layer_norm(name: str) -> bool:
    """A LayerNorm's weight or bias (kept float32 in every dtype)."""
    module = name.rsplit(".", 1)[0].split(".")[-1] if "." in name else ""
    return any(k in module for k in LN_KEYS)


def make(cfg: dict, seed: int, device, served: bool = False) -> dict[str, torch.Tensor]:
    """name -> tensor on `device`: float32 leaves, or with `served` the
    non-LayerNorm leaves rounded to bfloat16 (module notes)."""
    leaves = layout(cfg)
    total = sum(_numel(shape) for _, shape, _ in leaves)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape, scale in leaves:
        z = flat[at:at + _numel(shape)].view(shape)
        at += z.numel()
        # in place: the float32 leaves are views of the one draw
        leaf = z.mul_(0.1).add_(1.0) if scale == "ln" else z.mul_(0.02 if scale is None else scale)
        if served and not is_layer_norm(name):
            leaf = leaf.to(torch.bfloat16)
        out[name] = leaf
    return out


def _numel(shape: tuple) -> int:
    n = 1
    for dim in shape:
        n *= dim
    return n
