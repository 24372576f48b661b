"""Small host-side utilities: a copy of `eigentrajectory_tpu/utils/misc.py`."""
from __future__ import annotations


def print_arguments(args, length: int = 100, sep: str = ": ", delim: str = " | "):
    """Print a flat dict (or namespace) of arguments as `key: value` items
    joined by `delim`, starting a new line before an item that would pass
    `length` characters."""
    if hasattr(args, "__dict__") and not isinstance(args, dict):
        args = vars(args)
    text = [f"{k}{sep}{args[k]}" for k in args.keys()]
    cl = 0
    out = []
    for n, line in enumerate(text):
        if cl + len(line) > length:
            out.append("\n")
            cl = 0
        out.append(line)
        cl += len(line)
        if n != len(text) - 1:
            out.append(delim)
            cl += len(delim)
    print("".join(out))
