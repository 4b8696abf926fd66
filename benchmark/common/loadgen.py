"""Open-loop load generator, run as its own process so that its threads do
not contend for the server's interpreter lock.

    python -m benchmark.common.loadgen <plan.json>

The plan gives the server's URL, each request's due time (seconds from the
window's start), its clip length and the run's seed, the requests whose
response bodies to keep, how long to wait past the window, and where to
write the results.  The generator makes every WAV body first, prints
``ready``, reads the window's start (a ``time.monotonic`` reading) from
standard input, and sends each request from its own thread at its due time,
whether or not earlier ones have been answered.  Each request's latency runs
from its due time to the end of its response; one that fails or is not
answered before the wait ends has none.
"""
from __future__ import annotations

import http.client
import json
import sys
import threading
import time
from urllib.parse import urlparse

import numpy as np

from . import traffic


def _post(host, port, body, timeout):
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        conn.request("POST", "/enhance", body=body,
                     headers={"Content-Type": "audio/wav", "Content-Length": str(len(body))})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def main(plan_path: str) -> int:
    with open(plan_path) as f:
        plan = json.load(f)
    url = urlparse(plan["url"])
    fs, seed = plan["fs"], plan["seed"]
    due = np.asarray(plan["due"], np.float64)
    bodies = [traffic.wav_bytes(traffic.pcm16(traffic.clip(seed, i, n, fs)), fs)
              for i, n in enumerate(plan["samples"])]
    keep = set(plan["keep"])
    n = len(bodies)
    sent = np.full(n, np.nan)
    done = np.full(n, np.nan)
    status = np.zeros(n, np.int64)
    kept = {}

    def send(i, t0, deadline):
        sent[i] = time.monotonic() - (t0 + due[i])
        try:
            code, body = _post(url.hostname, url.port, bodies[i],
                               max(1.0, deadline - time.monotonic()))
        except (OSError, http.client.HTTPException):
            return
        status[i] = code
        if code == 200:
            done[i] = time.monotonic() - (t0 + due[i])
            if i in keep:
                kept[str(i)] = traffic.wav_pcm(body)

    print("ready", flush=True)
    t0 = float(sys.stdin.readline())
    deadline = t0 + plan["seconds"] + plan["wait_s"]
    threads = []
    for i in np.argsort(due, kind="stable"):
        pause = t0 + due[i] - time.monotonic()
        if pause > 0:
            time.sleep(pause)
        th = threading.Thread(target=send, args=(int(i), t0, deadline), daemon=True)
        th.start()
        threads.append(th)
    for th in threads:
        th.join(timeout=max(0.0, deadline - time.monotonic()))
    # a request still open at the deadline is missing: its thread's late
    # writes are not read
    late_sent, latency, codes = sent.copy(), done.copy(), status.copy()
    np.savez(plan["out"], lateness=late_sent, latency=latency, status=codes,
             **{"body_" + k: v for k, v in list(kept.items())})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
