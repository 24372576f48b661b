"""The readings the correctness limits are set from, on the card, in one
process: for each seed the program's numbers after a short window at the
cell's own load, and for the control seeds also the control's, the
reference computed in float32 with TF32 on put in the program's place.

    python3 etbench/readings.py --workload <cell> --seeds 1,2,... \
        --control-seeds 1,2,3 [--seconds 2] [--out readings.jsonl]

Prints one JSON line a seed and role; the benchmark's runs never run it.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def readings(workload, seeds, control_seeds, seconds, device="cuda", traffic_overrides=None):
    """Yield {seed, role, numbers} for each seed ("program") and control
    seed ("control")."""
    import importlib

    from etbench.run import load_json

    bench = load_json("BENCHMARK.json")
    cell = {w["name"]: w for w in bench["workloads"]}[workload]
    config = load_json("etbench", "configs", f"{cell['config']}.json")
    traffic = dict(load_json("etbench", "traffic", f"{cell['traffic']}.json"))
    traffic.update(traffic_overrides or {})
    loop = importlib.import_module(f"etbench.loops.{traffic['loop']}")
    for seed in sorted(set(seeds) | set(control_seeds)):
        c = loop.Cell(config, traffic, ROOT, device, seed, seconds)
        window = c.window(seconds)
        c.release()
        if seed in seeds:
            yield {"seed": seed, "role": "program", "failed": window["failed"],
                   "attempted": window["attempted"], "numbers": c.check()}
        if seed in control_seeds:
            yield {"seed": seed, "role": "control", "numbers": c.check(control=True)}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", default=None)
    args = p.parse_args()
    ints = lambda s: [int(x) for x in s.split(",") if x]
    out = open(args.out, "a") if args.out else None
    t = time.time()
    for rec in readings(args.workload, ints(args.seeds), ints(args.control_seeds), args.seconds):
        rec["workload"], rec["elapsed_s"] = args.workload, round(time.time() - t, 1)
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()


if __name__ == "__main__":
    main()
