"""Bulk enhancement: ``model.enhance`` on a fixed batch, call after call.

Set-up: the kernel build, the weights, the checkpoint round trip, the mix's
distinct input batches and the sampler's draws for each (made from the
seed, the draws on the device, handed in through ``enhance(noise=...)`` so
that the reference gets the same), and ``warmup_calls`` calls.  The window
cycles over the batches, one call after another, each ended by a
``torch.cuda.synchronize`` as a user reading its result waits, until
``--seconds`` have passed; the rate counts every call completed over the
whole window.  With ``--trace 1`` the profiler covers ``trace.calls`` whole
calls from the first call that starts after ``trace.start_s``.

``correct``: ``check.sample_calls`` calls, drawn from the seed, and
``check.sample_rows`` rows of each are worked out again by the plain
reference from the same inputs and draws; each row's relative error must
stay under the mix's limit.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.common import check, program, traffic, weights
from benchmark.common.harness import Call, Run
from benchmark.common.trace import Tracer
from benchmark.reference.fold import fold


def run(ctx) -> Run:
    tr = ctx.traffic
    cfg = ctx.config["model"]
    fs, n_steps = cfg["fs"], int(tr["n_steps"])
    rows, n = int(tr["rows"]), int(round(tr["clip_s"] * fs))
    program.build_kernels(ctx.device)
    state, shadow = weights.draw(cfg, ctx.seed, ctx.device)
    model = program.load(cfg, state, shadow, ctx.device)
    if ctx.fault:
        program.plant(model, ctx.fault)
    kwargs = {"n_steps": n_steps}
    if ctx.control:
        kwargs["compute_dtype"] = torch.bfloat16
    mixes = [torch.from_numpy(b).to(ctx.device)
             for b in traffic.offline_batches(ctx.seed, tr["batches"], rows, n, fs)]
    t_pad = n + model.tot_ds - n % model.tot_ds
    g = torch.Generator(device=ctx.device).manual_seed(ctx.seed)
    noises = [[torch.randn((rows, t_pad, 1), generator=g, device=ctx.device)
               for _ in range(n_steps)] for _ in mixes]

    def call(i):
        b = i % len(mixes)
        out = model.enhance(mixes[b], noise=noises[b], **kwargs)
        if ctx.device == "cuda":
            torch.cuda.synchronize()
        return out

    for i in range(tr["warmup_calls"]):
        call(i)
    if ctx.trace:
        Tracer.warm()
    outs, calls, tracer, traced_left = [], [], None, 0
    t0 = time.monotonic()
    setup_s = t0 - ctx.proc_start
    # a traced run goes on until its traced calls are done
    while time.monotonic() - t0 < ctx.seconds or traced_left:
        i = len(calls)
        start = time.monotonic()
        if ctx.trace and tracer is None and \
                start - t0 >= min(tr["trace"]["start_s"], ctx.seconds / 2):
            tracer, traced_left = Tracer(), tr["trace"]["calls"]
            tracer.start()
        c = Call(rows=rows, t=n, start=start, traced=traced_left > 0)
        before = program.launches()
        outs.append(call(i))
        c.end = time.monotonic()
        c.launches = dict(program.launches() - before)
        calls.append(c)
        if c.traced:
            traced_left -= 1
            if traced_left == 0:
                tracer.stop()
    window = time.monotonic() - t0
    if ctx.trace and tracer is None:
        raise RuntimeError("no call started after trace.start_s")
    peak = torch.cuda.max_memory_allocated() if ctx.device == "cuda" else 0
    trace = tracer.result() if tracer is not None else None
    rng = np.random.default_rng([ctx.seed, 3])
    picked = sorted(rng.choice(len(calls), min(len(calls), tr["check"]["sample_calls"]),
                               replace=False).tolist())
    sampled = {i: (sorted(rng.choice(rows, tr["check"]["sample_rows"], replace=False).tolist()),
                   outs[i].float().cpu().numpy()) for i in picked}
    del model, outs
    check.free_device()

    worst = 0.0
    t_check = time.monotonic()
    with check.full_float32():
        ref = fold(cfg, state, shadow)
        del state, shadow
        for i, (rs, got) in sampled.items():
            b = i % len(mixes)
            idx = torch.tensor(rs, device=ctx.device)
            want = ref.enhance(mixes[b][idx], [z[idx] for z in noises[b]], n_steps)
            want = want.cpu().numpy()
            for j, r in enumerate(rs):
                worst = max(worst, check.rel_err(got[r], want[j]))
    del ref
    check.free_device()
    t_check = time.monotonic() - t_check
    lim = ctx.limits["rel_err_limit"]
    return Run(
        cfg=cfg, dtype=ctx.config["dtype"], n_steps=n_steps, setup_s=setup_s, window_s=window,
        attempted=len(calls), failed=0,
        compared=[["rel_err", worst, lim, "max"],
                  ["compared_rows", sum(len(rs) for rs, _ in sampled.values()), 1, "min"]],
        memory_peak_bytes=int(peak), calls=calls, audio_s=len(calls) * rows * n / fs,
        trace=trace, notes={"check_s": t_check, "calls": len(calls), "call_s_median": float(np.median(
            [c.end - c.start for c in calls]))})
