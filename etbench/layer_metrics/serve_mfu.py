"""The whole request: the model's and the ET space's operations, counted by
the reference at each scene's own pedestrians, over the requests' service
time (from the call to the futures in hand, the wait before it left out),
against the card's f32 peak, in %."""
from etbench.roofline import PEAK_F32_PER_S


def read(ctx):
    if not ctx.on_card:
        return None
    w = ctx.window
    busy = float((w["end"] - w["start"]).sum())
    flops = sum(x["flops"] for x in w["work"])
    return 100.0 * flops / busy / PEAK_F32_PER_S if busy > 0 and flops else None
