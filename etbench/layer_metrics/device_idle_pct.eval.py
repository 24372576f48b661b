"""Device: the share of the window in which no operation ran on the card,
in %."""
from etbench.layers import device_trace


def read(ctx):
    t, w = device_trace(ctx), ctx.window["t_end"]
    return 100.0 * (1.0 - t.busy_s() / w) if t is not None and w > 0 else None
