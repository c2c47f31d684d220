"""opt_ms: the mean over the traced window's steps of the CUDA-event time
around the optimizer's step (train.optim's AdamW over the f32 masters),
recorded by the benchmark's wrappers."""

import statistics


def read(r):
    spans = r.spans.get("opt")
    return statistics.fmean(spans) if spans else None
