"""Read the numbers that decide ``correct`` over many seeds in one process:
the program as configured, and its lower-precision control (bf16 networks),
at the cell's own size and load.  The limits in the traffic files are set
from these readings.

    python3 -m benchmark.tools.readings --workload universe_16k.offline \
        --seconds 6 --seeds 101 102 ... --control-seeds 201 202 203

One JSON line per run: the arm, the seed and each compared number.
"""
from __future__ import annotations

import argparse
import json

from benchmark import run as bench_run
from benchmark.common import harness


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = p.parse_args(argv)
    spec = harness.Spec.load()
    first = True
    for arm, seeds in (("program", args.seeds), ("control", args.control_seeds)):
        for seed in seeds:
            run = bench_run.run_cell(spec, args.workload, seed, args.seconds,
                                     control=arm == "control", precompile=first)
            first = False
            print(json.dumps(bench_run._plain({
                "arm": arm, "seed": seed, "correct": run.correct,
                "compared": {n: v for n, v, _, _ in run.compared},
                "attempted": run.attempted, "failed": run.failed, "setup_s": run.setup_s})),
                flush=True)


if __name__ == "__main__":
    main()
