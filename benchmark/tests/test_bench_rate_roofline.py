"""The rate-change kernel's bound (``common/rate_roofline.py``) against a
hand count, and its reader (``metrics/rate_change.roofline.offline.py``) on
synthetic span records and a synthetic trace: the summed bound of the
kernel-entry spans over the kernel's device time, and no reading where the
spans lack the shape or no kernel time is there."""
from types import SimpleNamespace

import pytest

from benchmark.common import harness, rate_roofline, spans
from benchmark.common.trace import Trace

READER = "rate_change.roofline.offline"


@pytest.mark.parametrize("antialiased", [False, True])
def test_work_of_a_down_and_an_up_launch(antialiased):
    # down: (2, 10, 4) at r = 3 -> (2, 4, 8); the GEMM runs over ceil(10/3) 3 = 12 samples
    flops, nbytes = rate_roofline.rate_change_work("down", 2, 10, 4, 8, 3, antialiased)
    taps = 7 if antialiased else 0
    assert flops == 2 * 2 * 4 * (3 * 4) * 8 + 2 * taps * (2 * 10 * 4)
    assert nbytes == 4 * (2 * 10 * 4 + 2 * 4 * 8 + 3 * 4 * 8 + 8 + taps)
    # up: (2, 5, 8) at r = 3 -> (2, 15, 4); the low-pass runs over the output
    flops, nbytes = rate_roofline.rate_change_work("up", 2, 5, 8, 4, 3, antialiased)
    assert flops == 2 * 2 * 5 * 8 * (3 * 4) + 2 * taps * (2 * 15 * 4)
    assert nbytes == 4 * (2 * 5 * 8 + 2 * 15 * 4 + 8 * 3 * 4 + 4 + taps)


def test_bound_is_the_larger_of_operations_and_bytes():
    # a 24 kHz r = 8 block at batch 128 (C 384 <-> 768): bound by its operations
    flops, nbytes = rate_roofline.rate_change_work("down", 128, 200, 384, 768, 8, True)
    assert flops / 495e12 > nbytes / 3.35e12
    assert rate_roofline.rate_change_bound_s("down", 128, 200, 384, 768, 8, True) == \
        pytest.approx(flops / 495e12)
    # a 16 kHz r = 2 block (C 32 -> 64 over 64320 samples): bound by its bytes
    flops, nbytes = rate_roofline.rate_change_work("down", 128, 64320, 32, 64, 2, False)
    assert nbytes / 3.35e12 > flops / 495e12
    assert rate_roofline.rate_change_bound_s("down", 128, 64320, 32, 64, 2, False) == \
        pytest.approx(nbytes / 3.35e12)


DOWN = {"C": 48, "direction": "down", "entry": "kernel", "r": 2, "Cin": 48, "Cout": 96,
        "rows": 128, "T": 48240, "antialiased": True}
UP = {"C": 384, "direction": "up", "entry": "kernel", "r": 8, "Cin": 768, "Cout": 384,
      "rows": 128, "T": 201, "antialiased": False}
PLAIN = dict(DOWN, entry="plain")


def _records(calls, attrs):
    """``calls`` enhance spans, each holding one rate-change span per entry
    of ``attrs``."""
    recs, ids = [], iter(range(1, 1000))
    for _ in range(calls):
        enh = next(ids)
        recs.append({"name": "enhance", "id": enh, "parent": None, "thread": 1, "start_ns": 0,
                     "end_ns": 0, "device_ms": 10.0, "attrs": {}})
        recs += [{"name": "conv_block.rate_change", "id": next(ids), "parent": enh, "thread": 1,
                  "start_ns": 0, "end_ns": 0, "device_ms": 1.0, "attrs": dict(a)} for a in attrs]
    return recs


def _run(calls, kernel_ns):
    kernels = [("void ou_rate_change_kernel<false, 2, true>(float const*)", 0, kernel_ns // 2),
               ("void ou_rate_change_kernel<true, 8, false>(float const*)", kernel_ns,
                kernel_ns + kernel_ns - kernel_ns // 2),
               ("conv_block_tc_kernel", 0, 10 ** 9)]
    return SimpleNamespace(traced_calls=[object()] * calls,
                           trace=Trace(2.0, [k for k in kernels if k[2] > k[1]], []))


def test_reader_sums_the_kernel_spans_over_the_kernel_time(monkeypatch):
    recs = _records(2, [DOWN, UP, PLAIN])
    monkeypatch.setattr(spans, "records", lambda: recs)
    bound = 2 * sum(rate_roofline.rate_change_bound_s(
        a["direction"], a["rows"], a["T"], a["Cin"], a["Cout"], a["r"], a["antialiased"])
        for a in (DOWN, UP))
    got = harness.Spec.load().reader(READER)(_run(2, 40_000_000))
    assert got == pytest.approx(100.0 * bound / 0.04)


@pytest.mark.parametrize("case", ["no_r", "no_kernel_time", "no_launch", "no_trace", "mismatch"])
def test_no_reading(monkeypatch, case):
    attrs, run = [DOWN, UP], _run(2, 40_000_000)
    if case == "no_r":   # a program whose spans carry only C, direction and entry
        attrs = [{k: a[k] for k in ("C", "direction", "entry")} for a in attrs]
    elif case == "no_kernel_time":
        run = _run(2, 0)
    elif case == "no_launch":
        attrs = [PLAIN]
    elif case == "no_trace":
        run.trace = None
    else:
        run = _run(3, 40_000_000)
    recs = _records(2, attrs)
    monkeypatch.setattr(spans, "records", lambda: recs)
    assert harness.Spec.load().reader(READER)(run) is None
