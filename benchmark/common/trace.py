"""A device trace of part of the measured window, and what the metrics read
from it.

``Tracer`` wraps ``torch.profiler`` (CPU ops and CUDA kernels); it is
started and stopped on the thread that drives the device, so that thread's
host ops are in the trace.  ``Trace`` holds the kernels' intervals, device
time by kernel group (the grouping of the repository's ``chip_smoke.py``
phase 5, copied), the union of kernel intervals (busy time) and the idle
gaps between them, each named by the innermost host op running at the gap's
middle.
"""
from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

# first matching substring of a device kernel's lower-cased name names its
# group; casts and contiguous copies are copy kernels, pads a fill and a copy
GROUPS = (
    ("fused ConvBlock kernel", ("conv_block_kernel", "conv_block_tc_kernel")),
    ("GRU", ("rnn", "gru")),
    ("FFT", ("fft",)),
    ("cuDNN / library conv", ("conv", "fprop", "implicit", "winograd", "cudnn")),
    ("GEMM", ("gemm", "cutlass", "nvjet")),
    ("reduction", ("reduce",)),
    ("copy / cast / pad", ("copy", "fill", "memcpy", "memset")),
    ("elementwise", ("elementwise",)),
)
FUSED = GROUPS[0][0]
_RUNTIME = ("cuda", "cuLaunch", "cuModule", "cuStream", "cuEvent", "cuMem", "cuCtx")


def kernel_group(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def union_length(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


@dataclass
class Trace:
    window_s: float                       # host wall time from start to stop
    kernels: List[Tuple[str, int, int]]   # (name, start ns, end ns)
    host_ops: List[Tuple[str, int, int]]  # the driving thread's ops
    other: List[Tuple[str, float]] = field(default_factory=list)  # top "other" kernels
    groups_s: Dict[str, float] = field(default_factory=dict)
    busy_s: float = 0.0

    def __post_init__(self):
        groups = defaultdict(float)
        for name, s, e in self.kernels:
            groups[kernel_group(name)] += (e - s) / 1e9
        self.groups_s = dict(groups)
        self.busy_s = union_length((s, e) for _, s, e in self.kernels) / 1e9

    def idle_gaps(self) -> Dict[str, float]:
        """Seconds of the gaps between busy intervals, by the innermost host
        op (not a CUDA runtime call) running at each gap's middle."""
        spans, end = [], None
        for _, s, e in sorted(self.kernels, key=lambda k: k[1]):
            if end is not None and s > end:
                spans.append(((s + end) / 2, (s - end) / 1e9))
            end = e if end is None else max(end, e)
        ops = sorted(((n, s, e) for n, s, e in self.host_ops if not n.startswith(_RUNTIME)),
                     key=lambda o: (o[1], -o[2]))
        out, stack, j = defaultdict(float), [], 0
        for mid, length in sorted(spans):
            while j < len(ops) and ops[j][1] <= mid:
                while stack and stack[-1][2] <= ops[j][1]:
                    stack.pop()
                stack.append(ops[j])
                j += 1
            while stack and stack[-1][2] < mid:
                stack.pop()
            out[stack[-1][0] if stack else "(between host ops)"] += length
        return dict(out)

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.groups_s.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_gaps().items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in gaps]}


class Tracer:
    """Start and stop a ``torch.profiler`` trace on the calling thread."""

    def __init__(self):
        self.prof = None
        self.wall = 0.0

    @staticmethod
    def warm():
        """Start and stop the profiler once around a small device op: its
        first start initialises CUPTI for seconds, which belongs in set-up,
        not in the traced window."""
        import torch

        t = Tracer()
        t.start()
        if torch.cuda.is_available():
            torch.ones(8, device="cuda").sum().item()
        t.stop()

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        cuda = torch.cuda.is_available()
        if cuda:
            torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU]
                            + ([ProfilerActivity.CUDA] if cuda else []))
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self):
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.wall = time.perf_counter() - self.t0
        self.prof.stop()

    def result(self) -> Trace:
        from torch.autograd import DeviceType

        events = self.prof.profiler.kineto_results.events()
        kernels, host = [], defaultdict(list)
        other = defaultdict(float)
        for e in events:
            if e.device_type() == DeviceType.CUDA:
                kernels.append((e.name(), e.start_ns(), e.end_ns()))
                if kernel_group(e.name()) == "other":
                    other[e.name()[:100]] += (e.end_ns() - e.start_ns()) / 1e9
            elif e.device_type() == DeviceType.CPU:
                host[e.start_thread_id()].append((e.name(), e.start_ns(), e.end_ns()))
        driving = max(host.values(), key=len) if host else []
        if not kernels:
            raise RuntimeError("torch.profiler recorded no device kernel")
        return Trace(self.wall, kernels, driving,
                     sorted(other.items(), key=lambda kv: -kv[1])[:3])
