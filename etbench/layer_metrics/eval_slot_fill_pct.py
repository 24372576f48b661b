"""Eval loop (`train/trainer.py::test`): the share of the padded blocks'
slots that hold a pedestrian over the window, 100 x `eval.slots_valid` /
`eval.slots_padded`, from the program's trace counters, in %."""


def read(ctx):
    if not ctx.on_card:
        return None
    try:
        from eigentrajectory_tpu_torch.utils.profiling import counters
    except ImportError:            # a program with no trace counters
        return None
    c = counters()
    valid, padded = c.get("eval.slots_valid"), c.get("eval.slots_padded")
    return 100.0 * valid / padded if valid is not None and padded else None
