"""ET facade and predictor (`etspace/facade.py`, `models/stgcnn.py`): device
idle ms a call inside the host intervals of the span `eval.et_forward`, the
spans nested in it included: the time the card waits on the host's
dispatch of the forward."""
from etbench.layers import device_trace


def read(ctx):
    t, n = device_trace(ctx), ctx.window["attempted"]
    spans = t.host_spans.get("eval.et_forward") if t is not None else None
    if not spans or not n:
        return None
    busy, total = t.busy_within(spans)
    return (total - busy) * 1e3 / n
