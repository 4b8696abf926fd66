"""The arithmetic of ``common/spans.py`` and the readers of the program's
spans, on synthetic records: self time under nesting, the division per
traced call and per score pass, and no reading on a count mismatch, without
device time or without records."""
from types import SimpleNamespace

import pytest

from benchmark.common import harness, spans
from benchmark.common.trace import FUSED

READERS = ("sampler.self_ms.offline", "sampler.condition_ms.offline",
           "sampler.score_ms.offline", "conv_block.rate_change_ms.offline",
           "conv_block.wrapper_ms.offline")


def _call(first_id, passes=2):
    """One enhance: a conditioner pass and ``passes`` score passes, each
    holding one rate change and one chain, device ms as given."""
    recs, ids = [], iter(range(first_id, first_id + 100))

    def rec(name, ms, parent):
        recs.append({"name": name, "id": next(ids), "parent": parent, "thread": 1,
                     "start_ns": 0, "end_ns": 0, "device_ms": ms, "attrs": {}})
        return recs[-1]["id"]

    enh = rec("enhance", 100.0, None)
    for name, ms in [("enhance.condition", 20.0)] + [("enhance.score", 30.0)] * passes:
        net = rec(name, ms, enh)
        rec("conv_block.rate_change", 4.0, net)
        rec("conv_block.chain", 10.0, net)
    return recs


def _run(calls, fused_s=0.05):
    return SimpleNamespace(traced_calls=[object()] * calls,
                           trace=SimpleNamespace(groups_s={FUSED: fused_s}))


def test_self_time_subtracts_only_direct_children():
    s = spans.split(_run(2), _call(1) + _call(101))
    assert s.calls == 2 and s.count["enhance.score"] == 4
    assert s.total_ms["enhance"] == 200.0
    assert s.self_ms["enhance"] == pytest.approx(2 * (100 - 20 - 2 * 30))
    assert s.self_ms["enhance.score"] == pytest.approx(4 * (30 - 4 - 10))
    assert s.self_ms["conv_block.chain"] == s.total_ms["conv_block.chain"] == 60.0


def test_readers_divide_per_call_and_per_pass(monkeypatch):
    recs = _call(1) + _call(101)
    monkeypatch.setattr(spans, "records", lambda: recs)
    spec = harness.Spec.load()
    got = {m: spec.reader(m)(_run(2, fused_s=0.04)) for m in READERS}
    assert got == pytest.approx({
        "sampler.self_ms.offline": 20.0,
        "sampler.condition_ms.offline": 20.0,
        "sampler.score_ms.offline": 30.0,
        "conv_block.rate_change_ms.offline": 12.0,
        "conv_block.wrapper_ms.offline": (60.0 - 40.0) / 2})
    # the sum the acceptance holds: self + condition + passes x score
    assert got["sampler.self_ms.offline"] + got["sampler.condition_ms.offline"] + \
        2 * got["sampler.score_ms.offline"] == 100.0


@pytest.mark.parametrize("case", ["mismatch", "cpu", "none", "no_calls"])
def test_no_reading_without_sound_records(monkeypatch, case):
    recs = _call(1) + _call(101)
    run = _run(2)
    if case == "mismatch":
        run = _run(3)
    elif case == "cpu":
        for r in recs:
            r["device_ms"] = None
    elif case == "none":
        recs = None
    else:
        run = _run(0)
    monkeypatch.setattr(spans, "records", lambda: recs)
    spec = harness.Spec.load()
    assert spans.split(run) is None
    assert all(spec.reader(m)(run) is None for m in READERS)


def test_queue_wait_reader():
    read = harness.Spec.load().reader("serve.queue_wait_ms.serve")
    assert read(SimpleNamespace(stats={"clips": 4, "queue_wait_seconds": 0.2})) == \
        pytest.approx(50.0)
    assert read(SimpleNamespace(stats={"clips": 4})) is None  # a server without it
    assert read(SimpleNamespace(stats=None)) is None
