"""The program's own spans and counters (ctts_tpu_torch/utils/timing.py),
read for the per-layer metrics that name them.

The program's recorder records while a torch profiler records, so a
traced run (--trace 1) holds the spans of the profiler's window, on the
harness's perf_counter clock, and a --trace 0 run holds none. A reader
takes the spans that ended in the traced window [t_open, t_trace_close]
(as Run.span_s takes the wrapped calls), or the counter increments
made in it, sums them per request (a batch of the stream, a call of the
engine) and averages over the requests.
None where the program has no recorder, where it recorded nothing in
the window, or where its ring dropped entries that the window needs.
"""

from __future__ import annotations


def snapshot():
    """The recorder's snapshot, or None where the program has none."""
    try:
        from ctts_tpu_torch.utils import timing
    except ImportError:
        return None
    read = getattr(timing, "snapshot", None)
    return read() if read is not None else None


def window(run, snap=None):
    """(spans, counter marks) of the traced window, or None."""
    if run.t_open is None or run.t_trace_close is None:
        return None
    snap = snapshot() if snap is None else snap
    if not snap or not snap["spans"]:
        return None
    lo, hi = run.t_open * 1e9, run.t_trace_close * 1e9
    if snap.get("dropped", 0):
        oldest = min([s.start_ns for s in snap["spans"]]
                     + [m.at_ns for m in snap["marks"]])
        if oldest > lo:
            return None
    return ([s for s in snap["spans"] if lo <= s.end_ns <= hi],
            [m for m in snap["marks"] if lo <= m.at_ns <= hi])


def _per_request(items, names, size) -> float | None:
    sums: dict = {}
    for it in items:
        if it.name in names and it.req is not None:
            sums[it.req] = sums.get(it.req, 0) + size(it)
    if not sums:
        return None
    return sum(sums.values()) / len(sums)


def per_request_ms(run, names) -> float | None:
    """Mean over requests of the milliseconds of their spans named in
    `names` that ended in the traced window."""
    got = window(run)
    if got is None:
        return None
    mean = _per_request(got[0], names, lambda s: s.end_ns - s.start_ns)
    return None if mean is None else mean / 1e6


def per_request_count(run, name: str) -> float | None:
    """Mean over requests of what counter `name` added in the traced
    window."""
    got = window(run)
    if got is None:
        return None
    return _per_request(got[1], (name,), lambda m: m.n)


def counted(run, name: str) -> int | None:
    """What counter `name` added in the traced window."""
    got = window(run)
    if got is None:
        return None
    return sum(m.n for m in got[1] if m.name == name)
