"""One run of one benchmark cell of the PyTorch port on NVIDIA GPUs.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It finds the cell in ``BENCHMARK.json``, its configuration, traffic mix and
driver by name (``common/harness.py``), builds or reuses the program's
kernels, makes the weights and inputs from the seed, warms up the cell's
shapes, measures for ``--seconds``, checks what the timed path produced
against the plain reference (``reference/``), and prints one JSON line last:
the end-to-end metrics, or with ``--trace 1`` the per-layer ones, read by
``metrics/<name>.py``.  The numbers compared for ``correct`` end standard
error and the result line.  It exits non-zero, with no result, without
enough CUDA devices, and when JAX or the JAX package was loaded.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
from pathlib import Path

# the checkout's root, not this directory, is where packages are found
ROOT = str(Path(__file__).resolve().parents[1])
if sys.path and Path(sys.path[0]).resolve() == Path(__file__).resolve().parent:
    sys.path[0] = ROOT
else:
    sys.path.insert(0, ROOT)
from benchmark.common import harness, jaxguard  # noqa: E402

PROC_START = harness.proc_start_monotonic()


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def result_line(spec: harness.Spec, workload: str, run: harness.Run, trace: bool,
                device: dict) -> dict:
    metrics = {}
    for m in spec.metrics(workload, trace):
        value = spec.reader(m["name"])(run)
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line = {"correct": run.correct, "attempted": run.attempted, "failed": run.failed,
            "metrics": metrics, "device": device}
    if trace and run.trace is not None:
        line["device"] = dict(device, busy_s=run.trace.busy_s, window_s=run.trace.window_s)
        line["breakdown"] = run.trace.breakdown()
        run.notes["other_kernels"] = run.trace.other
    line["notes"] = run.notes
    line["compared"] = {name: {"value": v, "limit": lim, "must_be": "at most" if k == "max"
                               else "at least"} for name, v, lim, k in run.compared}
    return line


def run_cell(spec: harness.Spec, workload: str, seed: int, seconds: float,
             trace: bool = False, device: str = "cuda", **ctx_extra) -> harness.Run:
    """Drive one run of ``workload`` and return its record."""
    cell = spec.cell(workload)
    traffic = ctx_extra.pop("traffic", None) or spec.traffic(cell["traffic"])
    ctx = harness.Context(workload=workload, config=spec.config(cell["config"]),
                          traffic=traffic, limits=spec.limits(workload), seed=seed,
                          seconds=seconds, trace=trace,
                          device=device, proc_start=PROC_START, **ctx_extra)
    return spec.driver(traffic["driver"]).run(ctx)


def main(argv=None, *, device="cuda", spec=None, **ctx_extra) -> int:
    """``device``, ``spec`` and the Context's extra fields are for the tests,
    which drive a run on the CPU at a tiny size."""
    args = parse(argv)
    os.environ.setdefault("USE_FLAX", "0")
    spec = spec or harness.Spec.load()
    cell = spec.cell(args.workload)
    import torch

    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 1
    run = run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace), device,
                   **ctx_extra)
    if device == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell["chips"],
                "memory_peak_bytes": run.memory_peak_bytes}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    line = result_line(spec, args.workload, run, bool(args.trace), info)
    found = jaxguard.loaded()
    if found:
        print(f"refusing to report: the process loaded {found}", file=sys.stderr)
        return 1
    for name, v, lim, kind in run.compared:
        print(f"compared {name} = {v!r} ({'<=' if kind == 'max' else '>='} {lim!r})",
              file=sys.stderr)
    print(json.dumps(_plain(line), allow_nan=False), flush=True)
    return 0


def _plain(x):
    """JSON-ready: numpy scalars as numbers, a number that is not finite as
    its name (a metric never is one: its reader leaves it out)."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if hasattr(x, "item") and not isinstance(x, (str, bytes)):
        x = x.item()
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    return x


if __name__ == "__main__":
    sys.exit(main())
