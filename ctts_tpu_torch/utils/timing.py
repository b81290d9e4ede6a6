"""The port's tracing: named spans and counters where the work happens,
on the host's perf_counter clock, and the CLI's per-stage timings.

Counterpart of ctts_tpu/utils/timing.py's stage timer. The reference
has a `print_timing` config flag that is parsed but never read
(SURVEY.md §5.1, a stub); here `StageTimer` implements it as a view
over `span`. That module's device_trace has no counterpart: a profiler
trace of the port holds its spans (below).

    with timing.span("batch.lower", req):   # a span of request `req`
        ...
    timing.count("rows.pad", 3)             # adds to a counter

The recorder records while it is enabled (`enable()`) or while a torch
profiler records, and does nothing otherwise: `span` then returns one
shared no-op context after a flag check and a read of the profiler's
flag, with no clock read, no allocation and no record_function; `count`
returns after the same check. So a traced run records from the
profiler's start, and an operator can record without the profiler. The
first span or count under a profiler, after one with neither recording,
starts a fresh ring: one profiler session's spans do not pile up into
the next.

A recorded span keeps its name, an id, its parent (the innermost span
open on its own thread when it opened), the thread's name, its start
and end from time.perf_counter_ns(), and a request id (given, or its
parent's: the batch's number in BatchSynthesizer, the call's number in
CTTSEngine.synthesize, so that a batch's spans on the calling and the
drain thread share it). While a torch profiler records, a span also
opens torch.profiler.record_function("ctts::" + name): it then sits in
the profiler's own events beside the kernels it launched. A counter's
increments are kept as marks on the same clock (name, time, n), so a
reader can take a counter's change over any window. Spans and marks go
into one ring of RING entries; what falls off it is counted as
`trace.dropped`. `snapshot()` reads them.
"""

from __future__ import annotations

import contextlib
import itertools
import sys
import threading
import time
from collections import deque
from typing import NamedTuple, Optional

import torch.autograd.profiler as _profiler

RING = 2 ** 18
PREFIX = "ctts::"


class Span(NamedTuple):
    name: str
    id: int
    parent: Optional[int]
    thread: str
    start_ns: int
    end_ns: int
    req: Optional[int]


class Mark(NamedTuple):
    """One increment of a counter."""

    name: str
    at_ns: int
    n: int
    thread: str
    req: Optional[int]


_on = False
_session = False     # recording because a torch profiler records
_lock = threading.Lock()
_ring: deque = deque(maxlen=RING)
_dropped = 0         # the trace.dropped counter
_ids = itertools.count(1)
_local = threading.local()


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def recording() -> bool:
    return _on or _profiler._is_profiler_enabled


def reset() -> None:
    """Forget every span and mark."""
    global _dropped
    with _lock:
        _ring.clear()
        _dropped = 0


def _follow_profiler() -> None:
    """A profiler records and the recorder follows it: at the session's
    first span or count, start a fresh ring."""
    global _session, _dropped
    with _lock:
        if not _session:
            _ring.clear()
            _dropped = 0
            _session = True


def _leave_profiler() -> None:
    global _session
    _session = False


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _keep(entry) -> None:
    # Under _lock.
    global _dropped
    if len(_ring) == _ring.maxlen:
        _dropped += 1
    _ring.append(entry)


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _Open:
    """A span being recorded."""

    __slots__ = ("name", "req", "id", "parent", "start", "end", "_rf")

    def __init__(self, name: str, req: Optional[int]):
        self.name = name
        self.req = req
        self.start = self.end = 0

    def __enter__(self):
        stack = _stack()
        parent = stack[-1] if stack else None
        self.parent = None if parent is None else parent.id
        if self.req is None and parent is not None:
            self.req = parent.req
        self.id = next(_ids)
        stack.append(self)
        self._rf = None
        if _profiler._is_profiler_enabled:
            self._rf = _profiler.record_function(PREFIX + self.name)
            self._rf.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end = time.perf_counter_ns()
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
        _stack().pop()
        entry = Span(self.name, self.id, self.parent,
                     threading.current_thread().name, self.start, self.end,
                     self.req)
        with _lock:
            _keep(entry)
        return False

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e9


def span(name: str, req: Optional[int] = None):
    """A context that records the enclosed work as span `name` of
    request `req` (None: its parent's) while the recorder records."""
    if _on:
        return _Open(name, req)
    if _profiler._is_profiler_enabled:
        if not _session:
            _follow_profiler()
        return _Open(name, req)
    if _session:
        _leave_profiler()
    return _NOOP


def count(name: str, n: int = 1) -> None:
    """Add n to counter `name` while the recorder records."""
    if not _on:
        if not _profiler._is_profiler_enabled:
            if _session:
                _leave_profiler()
            return
        if not _session:
            _follow_profiler()
    stack = _stack()
    req = stack[-1].req if stack else None
    mark = Mark(name, time.perf_counter_ns(), int(n),
                threading.current_thread().name, req)
    with _lock:
        _keep(mark)


def snapshot() -> dict:
    """{"spans": [Span], "marks": [Mark], "dropped": n}: what the ring
    holds, oldest first, and the trace.dropped counter."""
    with _lock:
        entries = list(_ring)
        dropped = _dropped
    return {"spans": [e for e in entries if isinstance(e, Span)],
            "marks": [e for e in entries if isinstance(e, Mark)],
            "dropped": dropped}


class StageTimer:
    """The CLI's per-stage wall clock: each stage a `cli.stage` span
    (recorded whether or not the recorder is on), printed as a summary like the reference prints its stats.

    A stage that ends on device work reads its clock only once that work
    is on the host: the port's entry points (execute_plan_torch,
    BatchSynthesizer.synthesize, CTTSEngine) return numpy arrays, which
    wait for the card, so a stage around one of them times the device
    work too."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.stages: list[tuple[str, float]] = []

    @contextlib.contextmanager
    def stage(self, name: str):
        if not self.enabled:
            yield
            return
        sp = _Open("cli.stage", None)
        try:
            with sp:
                yield
        finally:
            self.stages.append((name, sp.seconds))

    def report(self, file=sys.stderr) -> None:
        if not self.enabled or not self.stages:
            return
        total = sum(d for _, d in self.stages)
        print("Timing:", file=file)
        for name, dur in self.stages:
            print(f"  {name:<24s} {dur * 1000:9.2f} ms", file=file)
        print(f"  {'total':<24s} {total * 1000:9.2f} ms", file=file)
