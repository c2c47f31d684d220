"""joint_mlp_ms: the device ms of the joint blocks' MLP sub-paths (the
program's span `tvts::fused_mlp_block` under the classification entry: the
LayerNorm row pass and both products) per call of the entry
(`tvts::cls_eval`), over the traced window. Nothing to read where either
span is missing."""


def read(r):
    spans = (r.spans or {}).get("spans") or {}
    part, entry = spans.get("fused_mlp_block"), spans.get("cls_eval")
    if not part or not entry or not part["device_ms"]:
        return None
    return sum(part["device_ms"]) / entry["calls"]
