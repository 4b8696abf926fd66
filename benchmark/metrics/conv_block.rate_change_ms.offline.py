"""Device ms per traced call of the ``conv_block.rate_change`` spans: the up
and down blocks' pads, rate-change convs (with UNIVERSE++'s depthwise
low-pass) and slices."""
from benchmark.common.spans import split


def read(run):
    s = split(run)
    if s is None or "conv_block.rate_change" not in s.total_ms:
        return None
    return s.total_ms["conv_block.rate_change"] / s.calls
