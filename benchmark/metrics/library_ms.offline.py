"""Device ms per traced call outside the fused ConvBlock kernel: cuDNN,
cuBLAS, the GRU, FFTs, copies and elementwise kernels, summed by kernel
group."""
from benchmark.common.trace import FUSED


def read(run):
    if run.trace is None or not run.traced_calls:
        return None
    other = sum(s for g, s in run.trace.groups_s.items() if g != FUSED)
    return 1e3 * other / len(run.traced_calls)
