"""Pedestrians scored by whole `test()` calls over the time from the
window's start to the end of its last call."""


def read(ctx):
    w = ctx.window
    peds = sum(x["peds"] for x, ok in zip(w["work"], w["ok"]) if ok)
    return peds / w["t_end"] if w["t_end"] > 0 else None
