"""Spans: named intervals at the boundaries of the port's layers, recorded
only while a ``torch.profiler`` records on the calling thread.

    with spans.span("enhance.score", step=i):
        ...

Off (no profiler recording), ``span`` returns one shared no-op after one
check of the profiler's own flag: no clock is read and nothing is kept.  On,
each span keeps a record in memory:

- its name, an id, its parent's id (the innermost span open on the same
  thread) and its thread;
- its host start and end in ns on the profiler's clock (kineto's CPU events
  stand on ``time.time_ns``);
- its device interval: two ``torch.cuda.Event`` recorded on the current
  stream at entry and exit, resolved only when the records are read (none
  while CUDA is not in use);
- its attributes.

Each span also enters the profiler's trace as a host op of its own name
(``_RecordFunctionFast``: not a user annotation, so kineto mirrors nothing
of it onto the device's timeline), so a chrome export carries it.
``records()`` and ``clear()`` are the only exporter; past ``MAX_RECORDS``
the recorder counts what it drops (``dropped()``).
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import List, Optional

import torch

MAX_RECORDS = 65536

_profiling = torch._C._autograd._profiler_enabled
_host_op = torch._C._profiler._RecordFunctionFast
_clock = time.time_ns


class _Off:
    """The span while no profiler records."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_ids = itertools.count(1)
_open = threading.local()      # .stack: the thread's open spans
_lock = threading.Lock()
_kept: List["_Span"] = []
_dropped = 0


def _stack() -> list:
    stack = getattr(_open, "stack", None)
    if stack is None:
        stack = _open.stack = []
    return stack


class _Span:
    __slots__ = ("name", "id", "parent", "thread", "start_ns", "end_ns", "attrs",
                 "_exit", "_events", "_device_ms")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs
        self.id = next(_ids)
        self._events, self._device_ms = None, None

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1].id if stack else None
        self.thread = threading.get_ident()
        stack.append(self)
        if torch.cuda.is_initialized():
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
        op = _host_op(self.name)
        enter, self._exit = op.__enter__, op.__exit__
        # the clock is read next to the host op's own stamps
        enter()
        self.start_ns = _clock()
        if self._events is not None:
            self._events[0].record()
        return None

    def __exit__(self, *exc):
        if self._events is not None:
            self._events[1].record()
        self.end_ns = _clock()
        self._exit(None, None, None)
        _stack().pop()
        _keep(self)
        return False

    def device_ms(self) -> Optional[float]:
        if self._device_ms is None and self._events is not None:
            start, end = self._events
            end.synchronize()
            self._device_ms = start.elapsed_time(end)
            self._events = None
        return self._device_ms


def _keep(s: _Span) -> None:
    global _dropped
    with _lock:
        if len(_kept) < MAX_RECORDS:
            _kept.append(s)
        else:
            _dropped += 1


def span(name: str, **attrs):
    """A context manager naming the work inside it; see the module's
    docstring.  It records only while a profiler records."""
    if not _profiling():
        return _OFF
    return _Span(name, attrs)


def records() -> List[dict]:
    """Every kept span, in the order they were opened: name, id, parent,
    thread, start_ns, end_ns, device_ms (None without CUDA) and attrs.
    Waits for the device to pass each span's end."""
    with _lock:
        kept = sorted(_kept, key=lambda s: s.id)
    return [{"name": s.name, "id": s.id, "parent": s.parent, "thread": s.thread,
             "start_ns": s.start_ns, "end_ns": s.end_ns, "device_ms": s.device_ms(),
             "attrs": dict(s.attrs)} for s in kept]


def dropped() -> int:
    """Spans not kept since the last ``clear()``: the records were full."""
    return _dropped


def clear() -> None:
    global _dropped
    with _lock:
        _kept.clear()
        _dropped = 0
