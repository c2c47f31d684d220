"""bwd_ms: the mean over the traced window's steps of the CUDA-event time
from the forward's return to the start of the optimizer's step (the loss,
and autograd through ops.block_backward and ops.text_attention), recorded
by the benchmark's wrappers."""

import statistics


def read(r):
    spans = r.spans.get("bwd")
    return statistics.fmean(spans) if spans else None
