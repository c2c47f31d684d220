"""kernel_roofline: over the profiled steps' sub-path calls (benchmark/spans.py),
the sum of their bounds (benchmark/flops.py, from each call's shapes) over
the sum of the device time torch.profiler attributes to them, in %. Nothing
to read where an entry that the cell's mix lists under "subpaths" made no
call: the program routed that work elsewhere, and a roofline over the rest
would read another yardstick."""


def read(r):
    calls = (r.profile or {}).get("calls") or []
    called = {entry for entry, _, _ in calls}
    if any(entry not in called for entry in r.cell.traffic.get("subpaths", ())):
        return None
    device_ms = sum(ms for _, ms, _ in calls)
    if not device_ms:
        return None
    return 100.0 * sum(bound for _, _, bound in calls) / device_ms
