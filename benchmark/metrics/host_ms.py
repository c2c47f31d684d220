"""host_ms: the median host-clock ms of one call of the cell's entry (one
extraction batch, or one optimizer step) after a synchronise: what it costs
the host to enqueue a step while the queue is empty."""

import statistics


def read(r):
    return statistics.median(r.host_ms) if r.host_ms else None
