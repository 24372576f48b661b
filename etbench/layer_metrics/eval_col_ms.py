"""COL (`metrics.py::col`): device ms a call of the operations under the
spans `eval.col` and `eval.col_gather`."""
from etbench.layers import per_unit_ms


def read(ctx):
    return per_unit_ms(ctx, lambda t: t.span_device_s("eval.col", "eval.col_gather"))
