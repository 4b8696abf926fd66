"""Device ms per score-network pass: the ``enhance.score`` spans' device
time over their number (traced calls x passes)."""
from benchmark.common.spans import split


def read(run):
    s = split(run)
    if s is None or not s.count.get("enhance.score"):
        return None
    return s.total_ms["enhance.score"] / s.count["enhance.score"]
