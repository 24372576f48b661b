"""Serving front (`inference.py`): device ms a request of the copies between
host and card (the padded block in, the futures out)."""
from etbench.layers import is_copy, per_unit_ms


def read(ctx):
    return per_unit_ms(ctx, lambda t: t.op_seconds(is_copy))
