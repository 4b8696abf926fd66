"""Device ms per traced call of the ``enhance`` span not covered by its
``enhance.condition`` and ``enhance.score`` spans: the sampler's own work
(normalising, padding, the draws, the step updates, unpadding)."""
from benchmark.common.spans import split


def read(run):
    s = split(run)
    return None if s is None else s.self_ms["enhance"] / s.calls
