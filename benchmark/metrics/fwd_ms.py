"""fwd_ms: the mean over the traced window's steps of the CUDA-event time
from the start of the forward (ops.fused_forward.train_apply) to its return,
recorded by the benchmark's wrappers."""

import statistics


def read(r):
    spans = r.spans.get("fwd")
    return statistics.fmean(spans) if spans else None
