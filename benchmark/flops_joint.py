"""Work arithmetic of the joint space-time towers (VideoMAE's, benchmark/
reference/videomae.py): the operations and bytes of the attention core alone,
of each sub-path call, and the model FLOPs of a clip, from the shapes alone.

As in flops.py, each input byte is counted read once and each output byte
written once (bf16), whatever a kernel reads again, so a bound is never above
what the card could reach. The core does 4 * d flops a (query, key) pair
(q . k and p v, d multiply-adds each) at the published head dim: the zero
columns a kernel pads d = 88 with to a k16 multiple are not work. The
sub-paths reuse flops.py's H7 arithmetic (the attention sub-path, non-causal)
and its MLP's.
"""

from __future__ import annotations

from benchmark import flops
from benchmark.reference.videomae import hidden_dim, tokens


def core_work(B: int, S: int, H: int, d: int, causal: bool = False):
    """(flops, bytes) of the attention core over B sequences of S rows, H
    heads of d: q, k and v read once, the output written once."""
    pairs = B * H * (S * (S + 1) // 2 if causal else S * S)
    return 4 * d * pairs, 2 * B * S * H * d * 4


def attention_work(B: int, S: int, D: int, H: int):
    """(flops, bytes) of a joint block's attention sub-path: LayerNorm, the
    qkv product, the core, the proj product with the residual."""
    return flops.text_work(B, S, D, H, causal=False, backward=False)


def mlp_work(B: int, S: int, D: int, hidden: int):
    """(flops, bytes) of a joint block's MLP sub-path (H3)."""
    return flops.mlp_work(B * S, D, False, False, hidden)


def classify_flops_per_clip(cfg: dict) -> float:
    """Model FLOPs of one clip's logits: the tubelet stem, every block's
    products and core, the head (the pooling and LayerNorms not counted)."""
    D, S, hidden = cfg["embed_dim"], tokens(cfg), hidden_dim(cfg)
    stem = 2 * S * D * 3 * cfg["tubelet_size"] * cfg["patch_size"] ** 2
    block = 8 * S * D * D + 4 * S * D * hidden + 4 * D * S * S
    return stem + cfg["depth"] * block + 2 * D * cfg["num_classes"]



def joint_attention_calls(spans: dict) -> list:
    """[(device ms, geometry)] of the joint blocks' attention sub-path calls
    in take_spans() records: the non-causal calls of the span
    `fused_text_attention_block` (the text and sort towers' calls are
    causal). Empty where the span, its geometry or its device times are
    missing."""
    rec = spans.get("fused_text_attention_block")
    if not rec:
        return []
    return [(ms, g) for ms, g in zip(rec["device_ms"], rec["geometry"])
            if g and g.get("causal") is False]
