"""ET facade + predictor (`etspace/facade.py`, `models/agentformer.py`):
device ms a request of the operations under the span `serve.et_forward`."""
from etbench.layers import per_unit_ms


def read(ctx):
    return per_unit_ms(ctx, lambda t: t.span_device_s("serve.et_forward"))
