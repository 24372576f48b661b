"""Eval loop (`train/trainer.py::test`, `data/batching.py`): device ms a call
of the copies between host and card (the padded block in, the metrics
out)."""
from etbench.layers import is_copy, per_unit_ms


def read(ctx):
    return per_unit_ms(ctx, lambda t: t.op_seconds(is_copy))
