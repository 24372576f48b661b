"""Device: the share of the requests' service time (the harness's spans
`bench.request`) in which no operation ran on the card, in %."""
from etbench.layers import device_trace


def read(ctx):
    t = device_trace(ctx)
    if t is None:
        return None
    busy, total = t.busy_within(t.host_spans.get("bench.request", []))
    return 100.0 * (1.0 - busy / total) if total > 0 else None
