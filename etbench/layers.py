"""What the metric readers share: the context a reader gets, and the
arithmetic of a time per unit of work and of a share of a bound."""
from __future__ import annotations

import importlib.util
import os
from typing import Dict, NamedTuple, Optional

HERE = os.path.dirname(os.path.abspath(__file__))


class Context(NamedTuple):
    config: Dict            # the configuration's file
    traffic: Dict           # the traffic mix's file
    window: Dict            # the loop's records of the window
    setup_s: float
    trace: Optional[object] = None   # trace.Trace of the window, in a traced run
    on_card: bool = True             # False in the CPU tests: no device metric is read


def device_trace(ctx: Context):
    """The trace where it holds operations of the card, else None."""
    t = ctx.trace
    return t if ctx.on_card and t is not None and len(t.op_start) else None


def reader(kind: str, name: str):
    """`read` of `<kind>/<name>.py`."""
    path = os.path.join(HERE, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"etbench.{kind}.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def per_unit_ms(ctx: Context, seconds_of) -> Optional[float]:
    """`seconds_of(trace)` of the window per request or call, in ms."""
    t, n = device_trace(ctx), ctx.window["attempted"]
    seconds = seconds_of(t) if t is not None else 0.0
    return seconds * 1e3 / n if n and seconds > 0 else None


def is_copy(name: str) -> bool:
    """A copy between the host and the card in the device trace."""
    return name.startswith(("Memcpy HtoD", "Memcpy DtoH"))


def kernel_share_pct(ctx: Context, kernel: str, bound_ms) -> Optional[float]:
    """The launches' summed least time (`bound_ms(work)` of each request or
    call) over the summed device time of the operations named `kernel`, in
    %; nothing where the launches are not one a request or call."""
    t = device_trace(ctx)
    if t is None:
        return None
    match = lambda name: kernel in name
    if t.op_count(match) != ctx.window["attempted"]:
        return None
    seconds = t.op_seconds(match)
    if seconds <= 0:
        return None
    return 100.0 * sum(bound_ms(w) for w in ctx.window["work"]) * 1e-3 / seconds
