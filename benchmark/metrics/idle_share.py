"""idle_share: the share of the traced steps in which no kernel, copy or
memset ran on the device, in %: one minus the union of the device's activity
intervals over the wall seconds of the same steps, both from the one
torch.profiler session that records the device alone (harness.device_busy),
so the host runs at its own pace. The same two numbers are the result's
`device` busy_s and window_s."""


def read(r):
    if not r.busy or not r.busy["window_s"]:
        return None
    return 100.0 * (1.0 - r.busy["busy_s"] / r.busy["window_s"])
