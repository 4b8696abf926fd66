"""What every run shares: the cell's files found by name, the context a
driver runs in, the record it returns, the metrics read from that record,
and the result line.

Files are found by the names in ``BENCHMARK.json``:

    benchmark/configs/<config>.json     the model configuration as run
    benchmark/traffic/<traffic>.json    the traffic mix's parameters; its
                                        ``driver`` names the driver
    benchmark/cells/<workload>.json     the cell's limits for ``correct``
    benchmark/drivers/<driver>.py       runs a mix: ``run(ctx) -> Run``
    benchmark/metrics/<metric>.py       ``read(run) -> float or None``

so a later configuration, mix or per-layer metric is a file and an entry,
with no edit of a file that is there.
"""
from __future__ import annotations

import importlib.util
import json
import os
import re
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def proc_start_monotonic() -> float:
    """This process's start on the ``time.monotonic`` clock (Linux: the
    start time in /proc/self/stat against /proc/uptime)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return time.monotonic() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _named(directory: Path, name: str, suffix: str) -> Path:
    if not NAME.match(name):
        raise ValueError(f"not a name: {name!r}")
    path = directory / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    return path


@dataclass
class Spec:
    """The benchmark's data: BENCHMARK.json and the directories it names."""
    bench: dict
    bench_dir: Path = BENCH_DIR   # drivers/ and metrics/
    data_dir: Path = BENCH_DIR    # configs/ and traffic/

    @classmethod
    def load(cls, root: Path = ROOT) -> "Spec":
        return cls(_json(root / "BENCHMARK.json"))

    def cell(self, workload: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == workload:
                return w
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        return _json(_named(self.data_dir / "configs", name, ".json"))

    def traffic(self, name: str) -> dict:
        return _json(_named(self.data_dir / "traffic", name, ".json"))

    def limits(self, workload: str) -> dict:
        return _json(_named(self.data_dir / "cells", workload, ".json"))

    def driver(self, name: str):
        return _module(_named(self.bench_dir / "drivers", name, ".py"))

    def metrics(self, workload: str, trace: bool) -> List[dict]:
        """The metrics a run of ``workload`` reports: its end-to-end ones, or
        with ``trace`` its per-layer ones (those that list it, or list no
        cell and move an end-to-end metric it reports)."""
        e2e = [m for m in self.bench["end_to_end"]
               if "workloads" not in m or workload in m["workloads"]]
        if not trace:
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in self.bench["per_layer"]
                if workload in m.get("workloads", [workload] if m["moves"] in names else [])]

    def reader(self, metric: str) -> Callable:
        return _module(_named(self.bench_dir / "metrics", metric, ".py")).read


def _module(path: Path):
    spec = importlib.util.spec_from_file_location(
        "benchmark._loaded." + path.parent.name + "." + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Context:
    """What a driver is given."""
    workload: str
    config: dict            # the configuration file
    traffic: dict           # the traffic file
    limits: dict            # the cell file: the limits of ``correct``
    seed: int
    seconds: float
    trace: bool
    device: str             # "cuda", or "cpu" in the CPU tests
    proc_start: float       # on the time.monotonic clock
    control: bool = False   # the lower-precision control: bf16 networks
    fault: Optional[str] = None  # a planted fault (tests only)
    precompile: bool = True


@dataclass
class Call:
    """One ``enhance`` call of the timed path."""
    rows: int
    t: int
    start: float
    end: float = 0.0
    launches: Dict[tuple, int] = field(default_factory=dict)
    traced: bool = False


@dataclass
class Run:
    """What a driver returns; the metrics read it."""
    cfg: dict                       # the model node
    dtype: str                      # the configuration's: "float32"
    n_steps: int
    setup_s: float
    window_s: float
    attempted: int
    failed: int
    compared: List[list]            # [name, value, limit, "max" | "min"]
    memory_peak_bytes: int
    calls: List[Call]
    latencies_s: Optional[List[float]] = None   # every request due, inf if missing
    audio_s: Optional[float] = None             # audio completed in the window
    stats: Optional[dict] = None                # the server's counters over the window
    trace: object = None                        # common.trace.Trace
    notes: Dict[str, object] = field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return all((v <= lim) if kind == "max" else (v >= lim)
                   for _, v, lim, kind in self.compared)

    @property
    def traced_calls(self) -> List[Call]:
        return [c for c in self.calls if c.traced]
