"""The ConvBlock rate-change kernel's least time, and its share of it in the
traced calls.

A rate change of a (B, T, Cin) input at rate r
(``open_universe_tpu_torch/ops/kernels/rate_change.py``) is one GEMM on a
block view of the rows: down (B, ceil(T/r), r Cin) @ (r Cin, Cout), up
(B, T, Cin) @ (Cin, r Cout); in UNIVERSE++'s score network a (2r + 1)-tap
low-pass runs over the input (down) or the output (up).  Its least time is
the larger of its FLOPs at the float32 (TF32) peak, the work counted once as
``roofline.conv_block_bound_s`` counts it, and its bytes at the HBM
bandwidth: x read once, the output written once, the weights, the bias and
the taps read once, all float32.

The port's ``conv_block.rate_change`` spans carry each rate change's shape
(direction, entry, r, Cin, Cout, rows, T, antialiased); those with entry
``kernel`` are the kernel's launches.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from . import roofline, spans

KERNEL = "ou_rate_change_kernel"   # the device symbol, in every instantiation's name
SPAN = "conv_block.rate_change"
ITEM = roofline.ITEM_BYTES["float32"]


def rate_change_work(direction: str, b: int, t: int, cin: int, cout: int, r: int,
                     antialiased: bool) -> Tuple[float, float]:
    """(FLOPs, bytes) of one rate change of a (b, t, cin) input: the GEMM's
    2 b ceil(t/r) r cin cout (down) or 2 b t cin r cout (up), plus
    2 (2r + 1) per filtered element where it low-passes (the input down, the
    output up)."""
    tb = -(-t // r)
    if direction == "down":
        flops = 2.0 * b * tb * r * cin * cout
        out = b * tb * cout
        filtered = b * t * cin
    else:
        flops = 2.0 * b * t * cin * r * cout
        out = b * t * r * cout
        filtered = out
    taps = 2 * r + 1 if antialiased else 0
    flops += 2.0 * taps * filtered
    elems = b * t * cin + out + r * cin * cout + cout + taps
    return flops, float(elems * ITEM)


def rate_change_bound_s(direction: str, b: int, t: int, cin: int, cout: int, r: int,
                        antialiased: bool) -> float:
    """The least time of one rate change: the larger of its FLOPs at the
    float32 peak and its bytes at the HBM bandwidth."""
    flops, nbytes = rate_change_work(direction, b, t, cin, cout, r, antialiased)
    return max(flops / roofline.PEAK_FLOPS["float32"], nbytes / roofline.PEAK_BYTES_PER_S)


def share(run, recs: Optional[List[dict]] = None):
    """The rate-change kernel's share of its roofline in the traced calls, %:
    the summed least time of the kernel-entry ``conv_block.rate_change``
    spans over the device time of the trace's ``ou_rate_change_kernel``
    kernels.  None without a trace or sound span records (``spans.split``),
    where a span lacks the shape (a program whose spans carry only C,
    direction and entry), or where no launch or no kernel time is there."""
    if run.trace is None:
        return None
    recs = spans.records() if recs is None else recs
    if spans.split(run, recs) is None:
        return None
    launched = [r["attrs"] for r in recs
                if r["name"] == SPAN and r["attrs"].get("entry") == "kernel"]
    if not launched or any("r" not in a for a in launched):
        return None
    kernel_s = sum(e - s for name, s, e in run.trace.kernels if KERNEL in name) / 1e9
    if kernel_s <= 0:
        return None
    bound_s = sum(rate_change_bound_s(a["direction"], a["rows"], a["T"], a["Cin"], a["Cout"],
                                      a["r"], a["antialiased"]) for a in launched)
    return 100.0 * bound_s / kernel_s
