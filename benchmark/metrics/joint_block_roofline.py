"""joint_block_roofline: over the traced window's joint-block sub-path calls
(the program's spans `tvts::fused_text_attention_block`, its non-causal
calls, and `tvts::fused_mlp_block`), the sum of their bounds
(benchmark/flops_joint from each call's recorded B, S, D, heads and hidden
width) over the sum of their device ms, in %. Nothing to read where either
span is missing."""

from benchmark.flops import bound_ms
from benchmark.flops_joint import attention_work, joint_attention_calls, mlp_work


def read(r):
    spans = (r.spans or {}).get("spans") or {}
    attn, mlp = joint_attention_calls(spans), spans.get("fused_mlp_block")
    if not attn or not mlp or not mlp["device_ms"]:
        return None
    bound = sum(bound_ms(*attention_work(g["B"], g["S"], g["D"], g["num_heads"]))
                for _, g in attn)
    bound += sum(bound_ms(*mlp_work(g["B"], g["S"], g["D"], g["hidden"]))
                 for g in mlp["geometry"])
    return 100.0 * bound / (sum(ms for ms, _ in attn) + sum(mlp["device_ms"]))
