"""HTTP enhancement service with micro-batching (JAX package
``bin/serve.py``).

    python -m open_universe_tpu_torch.bin.serve --model <ckpt|hf_repo> \
        [--device cuda|cpu] [--port 8000] [--max-batch 16] \
        [--batch-window-ms 10] [--n_steps 8 ...]

Concurrent POSTs are gathered for a short window, grouped into length
buckets, padded to a power-of-two number of rows and enhanced in one
``model.enhance`` call on the device.  At batch <= 64 the ConvBlocks of
fewer than 128 channels launch the kernel's rows entry, as the JAX package's
packed mode does (``nn/blocks.py``).

API:
  POST /enhance   body = a wav/flac/mp3 file -> 200 with a WAV body at the
                  input sample rate and channel count; every channel is one
                  micro-batch row.  A body that does not decode answers 400.
  GET  /healthz   liveness and model metadata, JSON
  GET  /stats     request, batch and device-time counters, JSON

All device work runs on one worker thread; request threads only decode and
encode audio.  The sampler noise comes from one ``torch.Generator`` on the
device, seeded by ``--seed`` and advanced by each batch, so a served result
is reproducible.  ``precompile(seconds)`` runs the (bucket, rows) grid once
before traffic (the kernels' build, cuDNN's algorithm choice) with a
generator of its own.
"""
from __future__ import annotations

import argparse
import json
import queue
import sys
import tempfile
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..data.audio import load_audio, resample_audio, save_audio
from ..inference.model_loader import DEFAULT_MODEL, load_model
from ..inference.signature_to_parser import parse_with_enhance_args

DEFAULT_SEED = 1028282  # reference bin/enhance.py:112


def _sniff_suffix(body: bytes) -> str:
    if body[:4] == b"RIFF":
        return ".wav"
    if body[:4] == b"fLaC":
        return ".flac"
    return ".mp3"  # ID3 / bare MPEG frames


@dataclass
class _Job:
    audio: np.ndarray          # one channel, f32 at model fs
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[np.ndarray] = None
    error: Optional[str] = None


@dataclass
class _WarmJob:
    """Run the (rows, bucket) shape once on the device worker."""
    bucket: int
    rows: int
    done: threading.Event = field(default_factory=threading.Event)
    error: Optional[BaseException] = None


def _pow2_floor(n: int) -> int:
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


class EnhanceService:
    """Owns the model, the request queue, the sampler's generator and the
    single device worker."""

    def __init__(self, model, *, max_batch=16, batch_window_ms=10.0,
                 bucket_seconds=1.0, max_clip_seconds=60.0, seed=DEFAULT_SEED,
                 enhance_kwargs=None):
        self.model = model
        self.device = next(model.parameters()).device
        # powers of two bound the number of (bucket, rows) shapes
        self.max_batch = _pow2_floor(int(max_batch))
        self.window_s = batch_window_ms / 1000.0
        self.quantum = max(1, int(bucket_seconds * model.fs))
        self.max_clip_len = int(max_clip_seconds * model.fs)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.enhance_kwargs = dict(enhance_kwargs or {})
        self._q: "queue.Queue" = queue.Queue()
        self.stats = {"requests": 0, "batches": 0, "clips": 0,
                      "audio_seconds": 0.0, "device_seconds": 0.0,
                      "errors": 0}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="enhance-worker")
        self._worker.start()

    def enhance(self, batch: np.ndarray, generator: torch.Generator) -> np.ndarray:
        """model.enhance on a (rows, T) float32 batch; returns it on the host."""
        mix = torch.as_tensor(batch, device=self.device)
        out = self.model.enhance(mix, generator=generator, **self.enhance_kwargs)
        return out.float().cpu().numpy()

    # -------------------------------------------------------------- client
    def submit(self, audio: np.ndarray) -> _Job:
        job = _Job(audio=audio)
        if self._stop.is_set():
            job.error = "server shutting down"
            job.done.set()
            return job
        with self._lock:
            self.stats["requests"] += 1
        self._q.put(job)
        return job

    def precompile(self, seconds: float) -> int:
        """Run every (bucket <= seconds, pow2 rows <= max_batch) shape once on
        the device worker, so that no request pays for a kernel build or an
        algorithm search.  Blocks until done; returns the number of shapes,
        ceil(seconds / bucket_seconds) * (log2(max_batch) + 1).  Raises the
        first error a shape raised (a kernel that fails to build or launch,
        a width the kernel lacks)."""
        warms = []
        n_buckets = -(-int(seconds * self.model.fs) // self.quantum)
        for i in range(1, n_buckets + 1):
            rows = 1
            while rows <= self.max_batch:
                warms.append(_WarmJob(bucket=i * self.quantum, rows=rows))
                rows *= 2
        for w in warms:
            self._q.put(w)
        for w in warms:
            w.done.wait()
        for w in warms:
            if w.error is not None:
                raise RuntimeError(f"warm-up of {w.rows} x {w.bucket} samples "
                                   "failed") from w.error
        return len(warms)

    def close(self):
        """Stop the worker after its in-flight batch; fail what is queued."""
        self._stop.set()
        deadline = time.monotonic() + 300.0
        while True:
            self._drain_failed()
            # the wake-up goes in after the drain, which would swallow it
            self._q.put(None)
            self._worker.join(timeout=1.0)
            if not self._worker.is_alive() or time.monotonic() > deadline:
                break
        self._drain_failed()

    def _drain_failed(self):
        while True:
            try:
                j = self._q.get_nowait()
            except queue.Empty:
                break
            if isinstance(j, _WarmJob):
                j.done.set()
            elif j is not None:
                j.error = "server shutting down"
                j.done.set()

    # -------------------------------------------------------------- worker
    def _collect(self):
        """One blocking get, then drain for up to window_s or max_batch."""
        job = self._q.get()
        if job is None:
            return []
        jobs = [job]
        deadline = time.monotonic() + self.window_s
        while len(jobs) < self.max_batch:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                j = self._q.get(timeout=left)
            except queue.Empty:
                break
            if j is None:
                break
            jobs.append(j)
        return jobs

    def _run(self):
        warm_generator = torch.Generator(device=self.device)
        while not self._stop.is_set():
            jobs = self._collect()
            real = []
            for j in jobs:
                if isinstance(j, _WarmJob):
                    try:
                        warm_generator.manual_seed(0)
                        self.enhance(np.zeros((j.rows, j.bucket), np.float32),
                                     warm_generator)
                    except Exception as e:  # noqa: BLE001 — precompile raises it
                        j.error = e
                    j.done.set()
                else:
                    real.append(j)
            by_bucket = {}
            for j in real:
                b = -(-len(j.audio) // self.quantum) * self.quantum
                by_bucket.setdefault(b, []).append(j)
            for bucket, group in sorted(by_bucket.items()):
                try:
                    self._run_bucket(bucket, group)
                except Exception as e:  # noqa: BLE001 — reported to the client
                    with self._lock:
                        self.stats["errors"] += len(group)
                    for j in group:
                        j.error = f"{type(e).__name__}: {e}"
                        j.done.set()

    def _run_bucket(self, bucket, group):
        rows = 1
        while rows < len(group):
            rows *= 2
        batch = np.zeros((min(rows, self.max_batch), bucket), np.float32)
        for i, j in enumerate(group):
            batch[i, : len(j.audio)] = j.audio
        t0 = time.perf_counter()
        enh = self.enhance(batch, self.generator)
        dt = time.perf_counter() - t0
        with self._lock:
            self.stats["batches"] += 1
            self.stats["clips"] += len(group)
            self.stats["audio_seconds"] += sum(
                len(j.audio) for j in group) / self.model.fs
            self.stats["device_seconds"] += dt
        for i, j in enumerate(group):
            j.result = enh[i, : len(j.audio)]
            j.done.set()


def make_handler(service: EnhanceService, model_name: str,
                 request_timeout: float = 300.0):
    fs_model = service.model.fs
    # refuse bodies that cannot be a valid clip before buffering them: the
    # longest clip at 48 kHz, float32, 8 channels, plus container slack
    max_body_bytes = (int(service.max_clip_len / fs_model * 48000) * 4 * 8
                      + (1 << 20))

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _json(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"status": "ok", "model": model_name,
                                 "fs": fs_model, "device": str(service.device),
                                 "max_batch": service.max_batch,
                                 "channels": "all enhanced; output keeps "
                                             "the input channel count"})
            elif self.path == "/stats":
                with service._lock:
                    s = dict(service.stats)
                s["mean_batch"] = s["clips"] / max(s["batches"], 1)
                s["device_realtime_factor"] = (
                    s["audio_seconds"] / max(s["device_seconds"], 1e-9))
                self._json(200, s)
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            # read (or refuse) the body before any response: an unread body
            # would parse as the next request on the keep-alive stream
            cl = self.headers.get("Content-Length")
            if cl is None:
                self.close_connection = True
                self._json(411, {"error": "Content-Length required"})
                return
            try:
                cl = int(cl)
            except ValueError:
                self.close_connection = True
                self._json(400, {"error": "malformed Content-Length"})
                return
            if cl > max_body_bytes:
                self.close_connection = True
                self._json(413, {"error": f"body exceeds {max_body_bytes} "
                                          "byte limit"})
                return
            body = self.rfile.read(cl)
            if self.path != "/enhance":
                self._json(404, {"error": "not found"})
                return
            try:
                with tempfile.NamedTemporaryFile(suffix=_sniff_suffix(body)) as f:
                    f.write(body)
                    f.flush()
                    audio, fs = load_audio(f.name)
            except Exception as e:  # noqa: BLE001
                self._json(400, {"error": f"undecodable audio: {e}"})
                return
            if fs != fs_model:
                audio = resample_audio(audio, fs, fs_model)
            if audio.shape[-1] == 0:
                self._json(400, {"error": "empty audio"})
                return
            if audio.shape[-1] > service.max_clip_len:
                self._json(413, {"error": "clip too long"})
                return
            # every channel is one micro-batch row (reference
            # bin/enhance.py:183-192: channels ride the batch dim)
            jobs = [service.submit(np.asarray(ch, np.float32)) for ch in audio]
            deadline = time.monotonic() + request_timeout
            for job in jobs:
                if not job.done.wait(timeout=max(0.0, deadline - time.monotonic())):
                    self._json(504, {"error": "enhancement timed out"})
                    return
            errs = [j.error for j in jobs if j.error is not None]
            if errs:
                self._json(500, {"error": errs[0]})
                return
            out = np.stack([j.result for j in jobs])
            if fs != fs_model:
                out = resample_audio(out, fs_model, fs)
            if out.shape[0] == 1:
                out = out[0]
            with tempfile.NamedTemporaryFile(suffix=".wav") as f:
                save_audio(f.name, out, fs)
                wav = Path(f.name).read_bytes()
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Content-Length", str(len(wav)))
            self.end_headers()
            self.wfile.write(wav)

    return Handler


class _Server(ThreadingHTTPServer):
    # socketserver's listen backlog of 5 resets connections of a burst of
    # concurrent requests while the accept loop waits for the GIL
    request_queue_size = 128


def make_server(model, *, model_name="model", host="127.0.0.1", port=0,
                **service_kwargs):
    """Build (server, service); the caller runs server.serve_forever()."""
    service = EnhanceService(model, **service_kwargs)
    server = _Server((host, port), make_handler(service, model_name))
    server.service = service
    return server, service


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Serve speech enhancement over HTTP with micro-batching")
    parser.add_argument("--model", type=str, default=DEFAULT_MODEL)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--seed", type=int, default=DEFAULT_SEED)
    parser.add_argument("--max-batch", type=int, default=16)
    parser.add_argument("--batch-window-ms", type=float, default=10.0)
    parser.add_argument("--bucket-seconds", type=float, default=1.0)
    parser.add_argument("--max-clip-seconds", type=float, default=60.0)
    parser.add_argument("--warmup-seconds", type=float, default=2.0,
                        help="run every (bucket, pow2 rows <= max-batch) shape "
                             "for clips up to this long before accepting "
                             "traffic (0 disables)")
    args, model, enhance_kwargs = parse_with_enhance_args(
        parser, sys.argv[1:] if argv is None else argv, load_model)

    server, service = make_server(
        model, model_name=args.model, host=args.host, port=args.port,
        max_batch=args.max_batch, batch_window_ms=args.batch_window_ms,
        bucket_seconds=args.bucket_seconds,
        max_clip_seconds=args.max_clip_seconds, seed=args.seed,
        enhance_kwargs=enhance_kwargs)
    try:
        if args.warmup_seconds > 0:
            t0 = time.perf_counter()
            n = service.precompile(args.warmup_seconds)
            print(f"warmed {n} (bucket, rows) shapes in "
                  f"{time.perf_counter() - t0:.1f}s", file=sys.stderr)
        print(f"serving {args.model} on http://{args.host}:"
              f"{server.server_address[1]} ({service.device}, fs={model.fs}, "
              f"max_batch={service.max_batch})", file=sys.stderr)
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        service.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
