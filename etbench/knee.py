"""The knee of an open-loop serving cell, found once by a sweep on the card:
one predictor offered the cell's requests at each of a few fixed rates,
printing the service time, the 95th percentile of latency and how late the
first and the last requests ran (a backlog that grows: past the knee).

    python3 etbench/knee.py --workload <cell> --rates 25,30,35 [--seconds 10]

The benchmark's runs never run it; the cell's `rate_per_s` is set from it.
"""
import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main():
    import importlib

    from etbench.run import load_json

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--seed", type=int, default=1)
    args = p.parse_args()
    rates = [float(r) for r in args.rates.split(",")]
    bench = load_json("BENCHMARK.json")
    cell = {w["name"]: w for w in bench["workloads"]}[args.workload]
    config = load_json("etbench", "configs", f"{cell['config']}.json")
    traffic = load_json("etbench", "traffic", f"{cell['traffic']}.json")
    loop = importlib.import_module(f"etbench.loops.{traffic['loop']}")
    top = max(rates)
    c = loop.Cell(config, dict(traffic, rate_per_s=top), ROOT, "cuda", args.seed, args.seconds)
    c.warm()
    every = c.requests
    for rate in rates:
        c.rate = rate
        c.requests = every[:max(1, int(np.ceil(args.seconds * rate)))]
        w = c.window(args.seconds)
        lat = (w["end"] - w["due"]) * 1e3
        service = (w["end"] - w["start"]) * 1e3
        late = (w["start"] - w["due"]) * 1e3
        tail = max(1, len(late) // 10)
        print(json.dumps({"rate_per_s": rate, "requests": len(lat), "seconds": w["t_end"],
                          "served_per_s": len(lat) / w["t_end"],
                          "service_mean_ms": float(service.mean()),
                          "p50_ms": float(np.percentile(lat, 50)),
                          "p95_ms": float(np.percentile(lat, 95)),
                          "late_first_tenth_ms": float(late[:tail].mean()),
                          "late_last_tenth_ms": float(late[-tail:].mean())}), flush=True)


if __name__ == "__main__":
    main()
