"""Arithmetic the metric readers share; each reader (``metrics/<name>.py``)
returns None where its run has nothing to read."""
from __future__ import annotations

from . import roofline
from .trace import FUSED


def conv_block_roofline(run):
    """The fused ConvBlock kernel's share of its roofline in the traced
    calls, %: the summed least time of every launch (its shape's FLOPs at
    the dtype's peak or its bytes at the HBM bandwidth, the larger) over the
    kernel's device time in the trace."""
    if run.trace is None:
        return None
    kernel_s = run.trace.groups_s.get(FUSED, 0.0)
    bound_s = sum(roofline.launches_bound_s(c.launches, c.rows) for c in run.traced_calls)
    if kernel_s <= 0 or bound_s <= 0:
        return None
    return 100.0 * bound_s / kernel_s


def idle_share(run):
    """Share of the traced wall time in which no kernel ran, %."""
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def mfu(run):
    """Model FLOPs of the traced calls (each at its rows x padded length, the
    benchmark's own count) over the traced wall time at the peak of the
    configuration's dtype, %."""
    if run.trace is None or not run.traced_calls:
        return None
    flops = sum(roofline.model_flops(run.cfg, c.rows, c.t, run.n_steps) for c in run.traced_calls)
    return 100.0 * flops / (run.trace.window_s * roofline.PEAK_FLOPS[run.dtype])
