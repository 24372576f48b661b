"""The whole `test()` call: the model's and the ET space's operations,
counted by the reference at each scene's own pedestrians, over the window
from its start to the end of its last call, against the card's f32 peak,
in %."""
from etbench.roofline import PEAK_F32_PER_S


def read(ctx):
    if not ctx.on_card:
        return None
    w = ctx.window
    flops = sum(x["flops"] for x, ok in zip(w["work"], w["ok"]) if ok)
    return 100.0 * flops / w["t_end"] / PEAK_F32_PER_S if w["t_end"] > 0 and flops else None
