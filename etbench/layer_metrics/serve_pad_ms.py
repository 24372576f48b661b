"""Serving front (`inference.py::predict`): host ms a request of the span
`serve.pad`, the request's padding into a block of scenes."""
from etbench.layers import device_trace


def read(ctx):
    t, n = device_trace(ctx), ctx.window["attempted"]
    spans = t.host_spans.get("serve.pad") if t is not None else None
    if not spans or not n:
        return None
    return sum(e - s for s, e in spans) * 1e-6 / n
