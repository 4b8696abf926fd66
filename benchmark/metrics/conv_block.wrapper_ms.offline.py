"""Device ms per traced call of the ``conv_block.chain`` spans less the fused
ConvBlock kernel's device time in the same traced calls: the copies in
front of each launch."""
from benchmark.common.spans import split
from benchmark.common.trace import FUSED


def read(run):
    s = split(run)
    if s is None or run.trace is None or "conv_block.chain" not in s.total_ms:
        return None
    kernel_ms = 1e3 * run.trace.groups_s.get(FUSED, 0.0)
    return (s.total_ms["conv_block.chain"] - kernel_ms) / s.calls
