"""ET facade + predictor (`etspace/facade.py`, `models/stgcnn.py`): device ms
a call of the operations under the span `eval.et_forward`."""
from etbench.layers import per_unit_ms


def read(ctx):
    return per_unit_ms(ctx, lambda t: t.span_device_s("eval.et_forward"))
