"""Open-loop serving through the program's HTTP server.

The server (``bin/serve.py``: ``make_handler`` on its ``_Server``, as
``make_server`` builds it) runs in this process on 127.0.0.1, port 0, with
the mix's settings; its ``EnhanceService`` is subclassed here only to record
each call: its (rows, bucket), the sampler generator's state before it, the
first samples of each row (which request went where), its kernel launches
and, with ``--trace 1``, to start and stop the profiler on the worker
thread at call boundaries.  The load generator is a separate process
(``common/loadgen.py``).

Set-up: the kernel build, the weights, the checkpoint round trip, the
server's own ``precompile`` over every (bucket, rows) shape the lengths
reach, two requests through the HTTP path (its first WAV decode and encode
import their modules: a second's stall that would otherwise fall on the
window's first requests), and the load generator's bodies.  The window opens at the first
due request and lasts ``--seconds``; every request due in it is waited for
up to ``wait_s`` past its close.

``correct``: a sample of the finished requests, drawn from the seed with
the longest among them, is worked out again by the plain reference from the
clip the benchmark sent (as 16-bit PCM), zero-padded to its bucket, with the
sampler's draws redrawn from the recorded generator state in the server's
order and shape; each response's relative error must stay under the mix's
limit, and every request must be answered.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from benchmark.common import check, program, traffic, weights
from benchmark.common.harness import ROOT, Call, Run
from benchmark.common.trace import Tracer
from benchmark.reference.fold import fold

KEY = 256  # leading samples that identify a request's row


def _service_class():
    from open_universe_tpu_torch.bin.serve import EnhanceService

    class RecordingService(EnhanceService):
        def __init__(self, *args, warm_tracer=False, **kwargs):
            self.calls, self.trace_plan, self.tracer, self.trace_done = [], None, None, False
            self.warm_tracer = warm_tracer
            super().__init__(*args, **kwargs)

        def enhance(self, batch, generator):
            if generator is not self.generator:  # precompile's warm-up shapes
                if self.warm_tracer:
                    Tracer.warm()
                    self.warm_tracer = False
                return super().enhance(batch, generator)
            now = time.monotonic()
            plan = self.trace_plan
            if plan is not None and self.tracer is None and now >= plan[0]:
                with self._lock:
                    self.stats_at_trace = dict(self.stats)
                self.tracer = Tracer()
                self.tracer.start()
                self.trace_until = time.monotonic() + plan[1]
            call = Call(rows=batch.shape[0], t=batch.shape[1], start=now,
                        traced=self.tracer is not None and not self.trace_done)
            call.state = generator.get_state().clone()
            call.keys = [batch[r, :KEY].tobytes() for r in range(batch.shape[0])]
            before = program.launches()
            out = super().enhance(batch, generator)
            call.end = time.monotonic()
            call.launches = dict(program.launches() - before)
            self.calls.append(call)
            if call.traced and call.end >= self.trace_until:
                self.tracer.stop()
                self.trace_done = True
            return out

    return RecordingService


def _sample(seed: int, samples: np.ndarray, k: int) -> list:
    """The longest request and k - 1 others, drawn from the seed."""
    rng = np.random.default_rng([seed, 2])
    longest = int(np.argmax(samples))
    rest = [i for i in rng.permutation(len(samples)) if i != longest]
    return sorted([longest] + [int(i) for i in rest[: k - 1]])


def _warm_http(port: int, fs: int, seed: int) -> None:
    """Two requests through the whole HTTP path before the window, so that
    its one-time costs (the first WAV decode and encode import their
    modules) fall in set-up."""
    import http.client

    for i, seconds in enumerate((1.0, 2.0)):
        body = traffic.wav_bytes(traffic.pcm16(traffic.speech_like(
            int(seconds * fs), fs, np.random.default_rng([seed, 4, i]))), fs)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        try:
            conn.request("POST", "/enhance", body=body)
            resp = conn.getresponse()
            resp.read()
        finally:
            conn.close()
        if resp.status != 200:
            raise RuntimeError(f"the warm-up request answered {resp.status}")


def run(ctx) -> Run:
    from open_universe_tpu_torch.bin import serve

    tr, srv = ctx.traffic, ctx.traffic["server"]
    cfg = ctx.config["model"]
    fs, n_steps = cfg["fs"], int(srv["n_steps"])
    program.build_kernels(ctx.device)
    state, shadow = weights.draw(cfg, ctx.seed, ctx.device)
    model = program.load(cfg, state, shadow, ctx.device)
    if ctx.fault:
        program.plant(model, ctx.fault)
    kwargs = {"n_steps": n_steps}
    if ctx.control:
        kwargs["compute_dtype"] = torch.bfloat16
    service = _service_class()(
        model, max_batch=srv["max_batch"], batch_window_ms=srv["batch_window_ms"],
        bucket_seconds=srv["bucket_seconds"], seed=ctx.seed, enhance_kwargs=kwargs,
        warm_tracer=ctx.trace)
    server = serve._Server(("127.0.0.1", 0), serve.make_handler(service, ctx.workload))
    server.service = service
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    tmp = tempfile.TemporaryDirectory()
    loadgen = None
    try:
        if ctx.precompile:
            service.precompile(tr["lengths"]["max_s"])
        _warm_http(server.server_address[1], fs, ctx.seed)
        due, samples = traffic.schedule(tr["arrivals"], tr["lengths"], ctx.seconds, fs, ctx.seed)
        keep = _sample(ctx.seed, samples, tr["check"]["sample_requests"])
        plan = {"url": f"http://127.0.0.1:{server.server_address[1]}", "fs": fs,
                "seed": ctx.seed, "due": due.tolist(), "samples": samples.tolist(),
                "keep": keep, "seconds": ctx.seconds, "wait_s": tr["wait_s"],
                "out": os.path.join(tmp.name, "results.npz")}
        with open(os.path.join(tmp.name, "plan.json"), "w") as f:
            json.dump(plan, f)
        loadgen = subprocess.Popen(
            [sys.executable, "-m", "benchmark.common.loadgen", os.path.join(tmp.name, "plan.json")],
            cwd=ROOT, stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        if loadgen.stdout.readline().strip() != "ready":
            raise RuntimeError("the load generator did not start")
        with service._lock:
            stats0 = dict(service.stats)
        t0 = time.monotonic() + 0.05
        if ctx.trace:
            service.trace_plan = (t0 + min(tr["trace"]["start_s"], ctx.seconds / 2),
                                  tr["trace"]["seconds"])
        loadgen.stdin.write(f"{t0!r}\n")
        loadgen.stdin.flush()
        setup_s = t0 - ctx.proc_start
        rc = loadgen.wait(timeout=ctx.seconds + tr["wait_s"] + 120)
        if rc != 0:
            raise RuntimeError(f"the load generator exited {rc}")
        loadgen = None
        with service._lock:
            stats1 = dict(service.stats)
        if ctx.device == "cuda":
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
        else:
            peak = 0
        res = np.load(plan["out"])
        latency = np.where(np.isfinite(res["latency"]), res["latency"], np.inf)
        bodies = {int(k[5:]): res[k] for k in res.files if k.startswith("body_")}
        lateness = res["lateness"][np.isfinite(res["lateness"])]
    finally:
        if loadgen is not None:
            loadgen.kill()
            loadgen.wait()
        server.shutdown()
        service.close()
        server.server_close()
        thread.join(timeout=60)
        tmp.cleanup()
    calls = [c for c in service.calls if c.start >= t0]
    trace = service.tracer.result() if service.trace_done else None
    if ctx.trace and not service.trace_done:
        raise RuntimeError("the traced slice did not close inside the window")
    # a traced run reads the server's counters up to the traced slice, which
    # the profiler slows
    end = getattr(service, "stats_at_trace", stats1)
    stats = {k: end[k] - stats0[k] for k in stats0}
    del model, service, server
    check.free_device()

    # the reference, on the sampled requests that were answered
    where = {}
    for ci, c in enumerate(calls):
        for r, key in enumerate(c.keys):
            where.setdefault(key, (ci, r))
    quantum = int(srv["bucket_seconds"] * fs)
    worst, unmatched, by_bucket = 0.0, 0, {}
    for i in keep:
        if i not in bodies:
            continue
        pcm = traffic.pcm16(traffic.clip(ctx.seed, i, samples[i], fs))
        audio = pcm.astype(np.float32) / 32768.0
        loc = where.get(audio[:KEY].tobytes())
        if loc is None or calls[loc[0]].t != -(-len(audio) // quantum) * quantum:
            unmatched += 1
            continue
        by_bucket.setdefault(calls[loc[0]].t, []).append((i, audio, loc))
    t_check = time.monotonic()
    with check.full_float32():
        ref = fold(cfg, state, shadow)
        del state, shadow
        for bucket, items in sorted(by_bucket.items()):
            mix = torch.zeros(len(items), bucket, device=ctx.device)
            for j, (_, audio, _) in enumerate(items):
                mix[j, : len(audio)] = torch.from_numpy(audio)
            t_pad = bucket + ref.tot_ds - bucket % ref.tot_ds
            zs = {}
            for ci in sorted({loc[0] for _, _, loc in items}):
                g = torch.Generator(device=ctx.device)
                g.set_state(calls[ci].state)
                zs[ci] = [torch.randn((calls[ci].rows, t_pad, 1), generator=g, device=ctx.device)
                          for _ in range(n_steps)]
            draws = [torch.stack([zs[ci][s][r] for _, _, (ci, r) in items])
                     for s in range(n_steps)]
            out = ref.enhance(mix, draws, n_steps).cpu().numpy()
            for j, (i, audio, _) in enumerate(items):
                served = bodies[i].astype(np.float64) / 32768.0
                worst = max(worst, check.rel_err(served, out[j, : len(audio)]))
    del ref
    check.free_device()
    t_check = time.monotonic() - t_check
    missing = int(np.sum(~np.isfinite(latency)))
    lim = ctx.limits["rel_err_limit"]
    return Run(
        cfg=cfg, dtype=ctx.config["dtype"], n_steps=n_steps, setup_s=setup_s, window_s=ctx.seconds,
        attempted=len(due), failed=missing,
        compared=[["rel_err", worst, lim, "max"], ["missing", missing + unmatched, 0, "max"],
                  ["compared", len(keep) - missing - unmatched, 1, "min"]],
        memory_peak_bytes=int(peak), calls=calls, latencies_s=latency.tolist(),
        stats=stats, trace=trace,
        notes={"check_s": t_check, "requests": len(due), "median_latency_ms": float(np.median(latency) * 1e3),
               "generator_late_ms_median": float(np.median(lateness) * 1e3) if len(lateness) else None,
               "generator_late_ms_max": float(np.max(lateness) * 1e3) if len(lateness) else None,
               "calls": len(calls)})
