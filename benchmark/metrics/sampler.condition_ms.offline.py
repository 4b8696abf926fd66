"""Device ms per traced call of the ``enhance.condition`` span: the
conditioner's one pass."""
from benchmark.common.spans import split


def read(run):
    s = split(run)
    if s is None or "enhance.condition" not in s.total_ms:
        return None
    return s.total_ms["enhance.condition"] / s.calls
