"""joint_attn_ms: the device ms of the joint blocks' attention sub-paths (the
program's span `tvts::fused_text_attention_block`, its non-causal calls: the
LayerNorm row pass, the qkv product, the core, the proj product) per call of
the entry (`tvts::cls_eval`), over the traced window. Nothing to read where
either span is missing."""

from benchmark.flops_joint import joint_attention_calls


def read(r):
    spans = (r.spans or {}).get("spans") or {}
    calls, entry = joint_attention_calls(spans), spans.get("cls_eval")
    if not calls or not entry:
        return None
    return sum(ms for ms, _ in calls) / entry["calls"]
