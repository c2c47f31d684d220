"""joint_core_roofline: over the traced window's calls of the attention core
(the program's span `tvts::text_core`), the sum of their bounds
(benchmark/flops_joint.core_work from each call's recorded B, S, H, d and
causal) over the sum of their device ms (CUDA events at the span's edges),
in %. Nothing to read where the program recorded no such span."""

from benchmark.flops import bound_ms
from benchmark.flops_joint import core_work


def read(r):
    calls = ((r.spans or {}).get("spans") or {}).get("text_core")
    if not calls or not calls["device_ms"]:
        return None
    bound = sum(bound_ms(*core_work(g["B"], g["S"], g["H"], g["d"], g["causal"]))
                for g in calls["geometry"])
    return 100.0 * bound / sum(calls["device_ms"])
