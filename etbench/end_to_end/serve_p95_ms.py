"""The 95th percentile over every request of the window of the time from
when it was due to when its futures were in hand; a failed request counts
as never answered."""
import numpy as np


def read(ctx):
    w = ctx.window
    lat = np.where(w["ok"], (w["end"] - w["due"]) * 1e3, np.inf)
    return float(np.percentile(lat, 95))
