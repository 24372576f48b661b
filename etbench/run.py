"""Run one cell of BENCHMARK.json and print its result as the last line.

    python3 etbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the program for the cell's configuration and traffic mix, warms up
the shapes the window will use (set-up), drives the window for `--seconds`,
then judges what the window produced against the plain reference. With
`--trace 0` the metrics are the cell's end-to-end metrics; with `--trace 1`
the window runs under torch.profiler and the metrics are its per-layer
metrics, read from the trace by `layer_metrics/<name>.py`.

Needs a CUDA device (as many as the cell's chips); exits non-zero without a
result where there is none, where a JAX module was loaded, or where the
program is not beside this folder.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
CACHE_DIR = os.path.join(ROOT, ".etbench_cache")

# Top-level modules no run may hold once its window has closed.
FORBIDDEN = ("jax", "jaxlib", "flax", "eigentrajectory_tpu")


def load_json(*parts):
    with open(os.path.join(ROOT, *parts)) as f:
        return json.load(f)


def forbidden_modules():
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def applies(metric, cell):
    """Whether `metric` of BENCHMARK.json is read in `cell`: the cells it
    lists (every per-layer metric lists them), else every cell."""
    return cell in metric.get("workloads", [cell])


def window_line(window, seconds):
    """What the window served: the service times of its requests or calls,
    and their mean in each fifth of the window (a drift shows there)."""
    import numpy as np

    start, end = window["start"], window["end"]
    ms = (end - start) * 1e3
    p10, p50, p90 = np.percentile(ms, [10, 50, 90])
    fifth = np.minimum((start / seconds * 5).astype(int), 4)
    means = [f"{ms[fifth == i].mean():.3f}" for i in range(5) if (fifth == i).any()]
    return (f"window: {len(ms)} {window['unit']}s, service ms p10 {p10:.3f} p50 {p50:.3f} "
            f"p90 {p90:.3f} max {ms.max():.3f}; mean by fifths {' '.join(means)}")


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=False)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "nvidia-smi: no reading"


def run_cell(bench, cell, seed, seconds, trace, device="cuda", traffic_overrides=None,
             hook=None, t_start=T_START):
    """The result dict of one run, or None where a forbidden module was
    loaded. `traffic_overrides` and `hook(cell)` (called after the warm-up)
    serve the tests alone."""
    import importlib

    import torch

    from etbench.layers import Context, reader
    from etbench.trace import Trace

    t_torch = time.perf_counter()
    config = load_json("etbench", "configs", f"{cell['config']}.json")
    traffic = dict(load_json("etbench", "traffic", f"{cell['traffic']}.json"))
    traffic.update(traffic_overrides or {})
    limits = load_json("etbench", "workloads", f"{cell['name']}.json")["checks"]
    loop = importlib.import_module(f"etbench.loops.{traffic['loop']}")
    c = loop.Cell(config, traffic, ROOT, device, seed, seconds)
    t_cell = time.perf_counter()
    c.warm()
    t_warm = time.perf_counter()
    setup_s = t_warm - t_start
    print(f"setup_s {setup_s:.3f}: imports and the card check {t_torch - t_start:.3f}, program "
          f"loaded and inputs made {t_cell - t_torch:.3f}, warm-up {t_warm - t_cell:.3f}",
          file=sys.stderr, flush=True)
    if hook is not None:
        hook(c)
    on_card = device != "cpu"
    if trace:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        prof = profile(activities=activities)
        prof.start()
    window = c.window(seconds)
    if on_card:
        torch.cuda.synchronize()
    traced = None
    if trace:
        prof.stop()
        traced = Trace(prof.profiler.kineto_results.events(), window["t_end"])
        del prof
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    print(window_line(window, seconds), file=sys.stderr, flush=True)
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr, flush=True)
        return None
    c.release()
    numbers = c.check()
    checks = {name: {"value": numbers[name], "limit": lim["limit"]} for name, lim in limits.items()}
    correct = window["failed"] == 0 and all(
        chk["value"] <= chk["limit"] for chk in checks.values())

    ctx = Context(config, traffic, window, setup_s, traced, on_card)
    name = cell["name"]
    e2e = [m for m in bench["end_to_end"] if applies(m, name)]
    chosen = [m for m in bench["per_layer"] if applies(m, name)] if trace else e2e
    metrics = {}
    for m in chosen:
        value = reader("layer_metrics" if trace else "end_to_end", m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    if on_card:
        device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                       "count": cell["chips"], "memory_peak_bytes": int(memory_peak)}
    else:
        device_info = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    result = {"correct": bool(correct), "attempted": window["attempted"],
              "failed": window["failed"], "metrics": metrics, "device": device_info}
    if traced is not None:
        device_info["busy_s"] = traced.busy_s()
        device_info["window_s"] = window["t_end"]
        result["breakdown"] = {"device_ops": traced.top_ops(), "idle_gaps": traced.idle_by_host()}
    result["checks"] = checks
    return result


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # Python's bytecode of every module the run imports, torch's included,
    # cached at a fixed place inside the checkout: where the environment
    # writes none (PYTHONDONTWRITEBYTECODE), each run would compile torch's
    # sources again in its set-up (some 5 s of it on an NVIDIA H100 host).
    sys.pycache_prefix = os.path.join(CACHE_DIR, "pycache")
    sys.dont_write_bytecode = False
    import torch

    bench = load_json("BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload}; known: {sorted(cells)}", file=sys.stderr)
        return 2
    cell = cells[args.workload]
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    print(f"card: {card_line()}", file=sys.stderr, flush=True)
    result = run_cell(bench, cell, args.seed, args.seconds, args.trace)
    if result is None:
        return 1
    print(f"correct: {result['correct']}", file=sys.stderr)
    for name, chk in result["checks"].items():
        print(f"check {name}: {chk['value']!r} (limit {chk['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
