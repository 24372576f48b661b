"""Eval loop (`data/batching.py`): host ms a call of the span `data.pad`,
the padding of the split's scenes into blocks."""
from etbench.layers import device_trace


def read(ctx):
    t, n = device_trace(ctx), ctx.window["attempted"]
    spans = t.host_spans.get("data.pad") if t is not None else None
    if not spans or not n:
        return None
    return sum(e - s for s, e in spans) * 1e-6 / n
