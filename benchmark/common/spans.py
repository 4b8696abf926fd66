"""Device time of the program's spans in a run's traced calls.

The port records spans while a profiler records on the calling thread
(``open_universe_tpu_torch/utils/spans.py``): in the offline driver's
traced run, exactly its traced calls.  ``split`` sums each span name's
device ms and self ms (a span's device interval less the part its child
spans cover: children run one after another on the span's stream, so that
part is their sum).  It is None where there are no records (a program
without spans), no device time (the CPU), records were dropped, or the
``enhance`` spans do not number the traced calls.
"""
from __future__ import annotations

from collections import Counter, defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional


@dataclass
class Split:
    calls: int                  # traced calls
    total_ms: Dict[str, float]  # device ms by span name, summed
    self_ms: Dict[str, float]   # device self ms by span name, summed
    count: Dict[str, int]       # spans by name


def records() -> Optional[List[dict]]:
    """The program's span records, or None where it has none to give."""
    try:
        from open_universe_tpu_torch.utils import spans
    except ImportError:
        return None
    if spans.dropped():
        return None
    return spans.records()


def split(run, recs: Optional[List[dict]] = None) -> Optional[Split]:
    recs = records() if recs is None else recs
    if not recs or any(r["device_ms"] is None for r in recs):
        return None
    count = Counter(r["name"] for r in recs)
    calls = len(run.traced_calls)
    if calls == 0 or count["enhance"] != calls:
        return None
    total, covered = defaultdict(float), defaultdict(float)
    for r in recs:
        total[r["name"]] += r["device_ms"]
        if r["parent"] is not None:
            covered[r["parent"]] += r["device_ms"]
    own = defaultdict(float)
    for r in recs:
        own[r["name"]] += r["device_ms"] - covered[r["id"]]
    return Split(calls, dict(total), dict(own), dict(count))
