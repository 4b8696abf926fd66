"""The port's spans (``utils/spans.py``) on the CPU with a narrow UNIVERSE++:
nothing recorded and nothing changed without a profiler; under one, the
spans of one ``enhance`` and of the server's worker, nested as the model
calls its layers, each on its own host op's interval; and the server's
time counters in ``/stats``."""
import time

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from open_universe_tpu_torch.bin.serve import EnhanceService, _Job
from open_universe_tpu_torch.configs.registry import instantiate
from open_universe_tpu_torch.nn.blocks import ConvBlock
from open_universe_tpu_torch.nn.layers import init_weights
from open_universe_tpu_torch.utils import spans
from open_universe_tpu_torch.utils.convert import fold_weight_norm

N_STEPS = 3
T = 4000
# the published rate factors of UNIVERSE++ at 16 and 24 kHz
RATE_FACTORS = {16000: [2, 4, 4, 5], 24000: [2, 3, 5, 8]}


def _cfg(fs):
    net = dict(fb_kernel_size=3, rate_factors=RATE_FACTORS[fs], n_channels=4,
               extra_conv_block=True, use_weight_norm=True, seq_model="gru")
    return {
        "_target_": "open_universe.networks.universe.UniverseGAN",
        "fs": fs, "normalization_norm": 2,
        "normalization_kwargs": {"ref": "both", "level_db": -26.0},
        "edm": {"noise": 0.25},
        "score_model": {"_target_": "open_universe.networks.universe.ScoreNetwork", **net,
                        "n_rff": 4, "noise_cond_dim": 16, "use_antialiasing": True,
                        "time_embedding": "simple"},
        "condition_model": {"_target_": "open_universe.networks.universe.ConditionerNetwork",
                            **net, "n_mels": 8, "n_mel_oversample": 4,
                            "encoder_gru_residual": True, "use_antialiasing": False},
        "diffusion": {"schedule": "geometric", "sigma_min": 0.0005, "sigma_max": 5.0,
                      "n_steps": 8, "epsilon": 1.3},
        "losses": {"use_signal_decoupling": True, "signal_decoupling_act": "snake"},
    }


@pytest.fixture(scope="module")
def model(request):
    """The narrow UNIVERSE++ at 16 kHz, or at the sampling rate a test hands
    in (``indirect`` parametrisation)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    fs = getattr(request, "param", 16000)
    yield fold_weight_norm(init_weights(instantiate(_cfg(fs)), seed=1)).eval()
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clear():
    spans.clear()
    yield
    spans.clear()


def _mix(rows=2):
    return torch.from_numpy(np.random.default_rng(0).standard_normal((rows, T))
                            .astype(np.float32) * 0.1)


def _enhance(model):
    return model.enhance(_mix(), n_steps=N_STEPS,
                         generator=torch.Generator().manual_seed(3))


def _host_events(prof, names):
    return sorted(((e.name(), e.start_ns(), e.end_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CPU and e.name() in names),
                  key=lambda e: e[1])


def test_no_profiler_records_nothing_and_the_output_is_the_same(model):
    off = _enhance(model)
    assert spans.records() == [] and spans.dropped() == 0
    with profile(activities=[ProfilerActivity.CPU]):
        on = _enhance(model)
    assert spans.records()
    assert torch.equal(off, on)


def test_one_enhance_nests_its_spans_on_their_host_ops(model):
    blocks = {"condition": 0, "score": 0}
    calls = {"chain": 0, "rate_change": 0}

    def count(mod, args):
        calls["chain"] += 1
        calls["rate_change"] += mod.rate_change_dir != "none"

    hooks = []
    for net in ("condition", "score"):
        for m in getattr(model, f"{net}_model").modules():
            if isinstance(m, ConvBlock):
                blocks[net] += 1
                hooks.append(m.register_forward_pre_hook(count))
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _enhance(model)
    finally:
        for h in hooks:
            h.remove()
    recs = spans.records()
    by_name = {}
    for r in recs:
        by_name.setdefault(r["name"], []).append(r)
    (enh,), (cond,) = by_name["enhance"], by_name["enhance.condition"]
    scores = by_name["enhance.score"]
    assert enh["parent"] is None and enh["attrs"] == {"rows": 2, "T": T, "n_steps": N_STEPS}
    assert cond["parent"] == enh["id"]
    assert [s["attrs"]["step"] for s in scores] == list(range(N_STEPS))
    assert all(s["parent"] == enh["id"] for s in scores)
    chains, rates = by_name["conv_block.chain"], by_name["conv_block.rate_change"]
    assert len(chains) == calls["chain"] == blocks["condition"] + N_STEPS * blocks["score"]
    assert len(rates) == calls["rate_change"] > 0
    parents = {s["id"]: s["name"] for s in [cond] + scores}
    under = {p: sum(c["parent"] == p for c in chains) for p in parents}
    assert under == {p: blocks[n.split(".")[1]] for p, n in parents.items()}
    assert all(r["parent"] in parents for r in rates)
    assert {c["attrs"]["entry"] for c in chains} <= {"main", "plain"}
    assert {r["attrs"]["direction"] for r in rates} == {"up", "down"}
    assert {r["attrs"]["entry"] for r in rates} == {"plain"}  # the kernel runs on the card
    assert all(r["device_ms"] is None and r["end_ns"] >= r["start_ns"] for r in recs)
    assert len({r["thread"] for r in recs}) == 1

    # each span is a host op of its own name in the profiler's events, on
    # the same interval: the span reads the clock next to the op's stamps,
    # so only a thread taken off the CPU between the two reads parts them;
    # a span therefore matches in at least one of two calls
    def apart_us(prof, recs):
        recs = sorted(recs, key=lambda r: r["start_ns"])
        events = _host_events(prof, set(by_name))
        assert [e[0] for e in events] == [r["name"] for r in recs]
        return [max(abs(r["start_ns"] - start), abs(r["end_ns"] - end)) / 1e3
                for r, (_, start, end) in zip(recs, events)]

    first = apart_us(prof, recs)
    spans.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _enhance(model)
    second = apart_us(prof, spans.records())
    assert max(min(a, b) for a, b in zip(first, second)) < 50


@pytest.mark.parametrize("model", [16000, 24000], indirect=True)
def test_rate_change_spans_carry_the_shapes_the_blocks_use(model, monkeypatch):
    """Each ``conv_block.rate_change`` span names what its block hands the
    kernel or the module: direction, r, Cin, Cout, rows, T and whether it
    low-passes (the score network's blocks do, the conditioner's do not)."""
    handed = []
    inner = ConvBlock._rate_change

    def record(block, h, kernel):
        out = inner(block, h, kernel)
        handed.append({"direction": block.rate_change_dir, "entry": "plain", "r": block.rate,
                       "Cin": h.shape[2], "Cout": out.shape[2], "rows": h.shape[0],
                       "T": h.shape[1], "antialiased": block.rate_change_conv.antialiasing,
                       "C": min(h.shape[2], out.shape[2])})
        return out

    monkeypatch.setattr(ConvBlock, "_rate_change", record)
    with profile(activities=[ProfilerActivity.CPU]):
        _enhance(model)
    got = [r["attrs"] for r in spans.records() if r["name"] == "conv_block.rate_change"]
    assert got == handed
    assert {a["r"] for a in got} == set(RATE_FACTORS[model.fs])
    assert {a["rows"] for a in got} == {2}
    assert {(a["direction"], a["antialiased"]) for a in got} == {
        (d, aa) for d in ("down", "up") for aa in (False, True)}
    # a down block's conv doubles the width, an up block's halves it
    assert all(a["Cout"] == 2 * a["Cin"] if a["direction"] == "down"
               else a["Cin"] == 2 * a["Cout"] for a in got)


def test_server_spans_and_counters(model):
    service = EnhanceService(model, max_batch=4, batch_window_ms=50.0, bucket_seconds=0.25,
                             enhance_kwargs={"n_steps": 2})
    try:
        stats0 = dict(service.stats)
        assert {"queue_wait_seconds", "collect_seconds", "call_seconds"} <= set(stats0)
        jobs = [service.submit(np.zeros(T, np.float32)) for _ in range(2)]
        assert all(j.done.wait(timeout=60) and j.error is None for j in jobs)
        stats1 = dict(service.stats)
        job = service.submit(np.zeros(T // 2, np.float32))
        assert job.done.wait(timeout=60) and job.error is None
        stats2 = dict(service.stats)
    finally:
        service.close()
    assert not service._worker.is_alive()
    for key in ("queue_wait_seconds", "collect_seconds", "call_seconds"):
        assert stats0[key] == 0 < stats1[key] < stats2[key], key
    assert stats2["call_seconds"] == stats2["device_seconds"]
    assert [j.id for j in jobs] + [job.id] == [1, 2, 3]
    assert spans.records() == []  # the worker ran no profiler

    # the worker's steps, run on this thread under the profiler
    waiting = [_Job(audio=np.zeros(T, np.float32), id=7, submitted=time.monotonic()),
               _Job(audio=np.zeros(T, np.float32), id=8, submitted=time.monotonic())]
    for j in waiting:
        service._q.put(j)
    with profile(activities=[ProfilerActivity.CPU]):
        got = service._collect()
        service._run_bucket(T, got)
    assert got == waiting and all(j.result.shape == (T,) for j in waiting)
    recs = {r["name"]: r for r in spans.records()}
    assert recs["serve.collect"]["parent"] is None
    bucket = recs["serve.bucket"]
    assert bucket["attrs"] == {"rows": 2, "bucket": T, "requests": [7, 8]}
    assert recs["enhance"]["parent"] == recs["serve.copy_back"]["parent"] == bucket["id"]
    assert service.stats["call_seconds"] == service.stats["device_seconds"] > stats2["call_seconds"]


def test_records_are_bounded_and_count_what_they_drop(monkeypatch):
    monkeypatch.setattr(spans, "MAX_RECORDS", 3)
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(5):
            with spans.span("unit", i=i):
                pass
    assert [r["attrs"]["i"] for r in spans.records()] == [0, 1, 2]
    assert spans.dropped() == 2
    spans.clear()
    assert spans.records() == [] and spans.dropped() == 0
