"""Sweep the offered rate of a serving cell, to find its knee: the highest
rate at which at least 99 % of requests are answered and the backlog does
not grow over the window (the last fifth of requests, by due time, wait no
longer than twice the first fifth plus half a second).

    python3 -m benchmark.tools.knee --workload universepp_16k.serve \
        --seed 11 --seconds 20 --rates 4 6 8 10 12 14

One process: the first rate pays the set-up (build, precompile), the rest
reuse its warm process.  One JSON line per rate.
"""
from __future__ import annotations

import argparse
import copy
import json
import math

import numpy as np

from benchmark import run as bench_run
from benchmark.common import harness, traffic


def verdict(due, latency):
    order = np.argsort(due)
    lat = np.asarray(latency, np.float64)[order]
    fifth = max(1, len(lat) // 5)
    answered = float(np.mean(np.isfinite(lat)))
    first, last = lat[:fifth], lat[-fifth:]
    grows = (not np.all(np.isfinite(last))) or (
        np.mean(last) > 2.0 * np.mean(first[np.isfinite(first)]) + 0.5)
    return answered, bool(grows)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    args = p.parse_args(argv)
    spec = harness.Spec.load()
    base = spec.traffic(spec.cell(args.workload)["traffic"])
    fs = spec.config(spec.cell(args.workload)["config"])["model"]["fs"]
    for k, rate in enumerate(args.rates):
        mix = copy.deepcopy(base)
        mix["arrivals"]["rate_per_s"] = rate
        run = bench_run.run_cell(spec, args.workload, args.seed, args.seconds,
                                 traffic=mix, precompile=k == 0)
        due, _ = traffic.schedule(mix["arrivals"], mix["lengths"], args.seconds, fs, args.seed)
        answered, grows = verdict(due, run.latencies_s)
        lat = sorted(run.latencies_s)
        print(json.dumps(bench_run._plain({
            "rate_per_s": rate, "requests": len(lat), "answered": answered,
            "backlog_grows": grows, "sustained": answered >= 0.99 and not grows,
            "latency_p50_ms": 1e3 * lat[len(lat) // 2],
            "latency_p95_ms": 1e3 * lat[math.ceil(0.95 * len(lat)) - 1],
            "mean_batch": run.stats["clips"] / max(run.stats["batches"], 1),
            "call_ms": 1e3 * run.stats["device_seconds"] / max(run.stats["batches"], 1),
            "correct": run.correct, "compared": run.compared, "notes": run.notes})), flush=True)


if __name__ == "__main__":
    main()
