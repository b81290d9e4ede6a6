"""The traced run's device timeline: torch.profiler over the window, read
back as device intervals, kernel times by name, and idle gaps labelled
by the host calls open during them.

The union of kernel, copy and fill intervals inside the host window is
chip_smoke.py's device_idle (chip_smoke.py:1370-1434): its events are
those of device_events (:1365), its window a record_function span of
the host. Here the events come from the profiler's results in memory
(no trace file is written), and the window opens and closes where the
harness's window does.
"""

from __future__ import annotations

import time

WINDOW_MARK = "bench_window"
# The profiler's kinds of device operation (chip_smoke.py:1365): a
# record_function span is mirrored onto the device's timeline as a
# "gpu_user_annotation", which is no work of the device.
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


class DeviceTrace:
    """What the traced window holds, on one clock (nanoseconds of the
    profiler): the window, the device's busy intervals, every device
    operation as (name, start, end), and the offset that maps the
    harness's perf_counter seconds onto that clock."""

    def __init__(self, w0, w1, ops, offset_ns):
        self.w0, self.w1 = w0, w1
        self.ops = [(n, max(a, w0), min(b, w1)) for n, a, b in ops
                    if b > w0 and a < w1]
        self.offset_ns = offset_ns
        self.busy = union(sorted((a, b) for _, a, b in self.ops))

    @property
    def window_s(self) -> float:
        return (self.w1 - self.w0) / 1e9

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) / 1e9

    def kernel_s(self, names) -> float:
        """Seconds of the device operations whose name holds any of
        `names`, inside the window."""
        return sum(b - a for n, a, b in self.ops
                   if any(k in n for k in names)) / 1e9

    def top_ops(self, k: int = 10) -> list:
        by_name: dict = {}
        for n, a, b in self.ops:
            by_name[n] = by_name.get(n, 0.0) + (b - a) / 1e9
        return sorted(([n[:120], s] for n, s in by_name.items()),
                      key=lambda kv: -kv[1])[:k]

    def gaps(self) -> list:
        """The window's idle intervals, (start, end) in ns."""
        out, at = [], self.w0
        for a, b in self.busy:
            if a > at:
                out.append((at, a))
            at = max(at, b)
        if at < self.w1:
            out.append((at, self.w1))
        return out

    def labelled_gaps(self, spans: dict, k: int = 10) -> list:
        """The k longest idle gaps, each named by the wrapped host calls
        that overlap it ("+"-joined, by name), or "none"."""
        spans_ns = {name: [(a * 1e9 + self.offset_ns, b * 1e9 + self.offset_ns)
                           for a, b in log] for name, log in spans.items()}
        out = []
        for a, b in sorted(self.gaps(), key=lambda g: g[0] - g[1])[:k]:
            open_ = [name for name, log in sorted(spans_ns.items())
                     if any(s < b and e > a for s, e in log)]
            out.append(["+".join(open_) or "none", (b - a) / 1e9])
        return out


def union(intervals) -> list:
    """The union of sorted (start, end) intervals, as disjoint intervals."""
    out: list = []
    for a, b in intervals:
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


class Tracer:
    """torch.profiler (CPU and CUDA) started before the window, with a
    record_function span from the window's open to its close."""

    def __init__(self, torch):
        self.torch = torch
        self.prof = None
        self.mark = None
        self.host_open = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        self.torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()

    def open_window(self) -> float:
        self.mark = self.torch.profiler.record_function(WINDOW_MARK)
        self.mark.__enter__()
        self.host_open = time.perf_counter()
        return self.host_open

    def close_window(self):
        self.mark.__exit__(None, None, None)

    def stop(self) -> DeviceTrace | None:
        """Ends the profiler and reads its events; None where the trace
        holds no window mark or no device operation."""
        self.torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        return read_events(self.prof.profiler.kineto_results.events(),
                           self.host_open)


def _ns(ev, what: str) -> int:
    if hasattr(ev, f"{what}_ns"):
        return int(getattr(ev, f"{what}_ns")())
    return int(getattr(ev, f"{what}_us")() * 1000)


def kind(ev) -> str:
    """The event's kind. A user annotation (a record_function span, on
    the host or mirrored onto the device) is never a device operation;
    where the profiler's events do not name their kind, any other event
    on a CUDA device counts as a kernel."""
    if ev.name() == WINDOW_MARK or (hasattr(ev, "is_user_annotation")
                                    and ev.is_user_annotation()):
        return "user_annotation"
    if hasattr(ev, "activity_type"):
        return ev.activity_type()
    return "kernel" if str(ev.device_type()).endswith("CUDA") else "cpu"


def read_events(events, host_open: float) -> DeviceTrace | None:
    """The window mark and the device operations (kernels, copies,
    fills: every event the profiler puts on a CUDA device) of a list
    of profiler events."""
    window, ops, kinds = None, [], {}
    for ev in events:
        start = _ns(ev, "start")
        end = start + _ns(ev, "duration")
        k = kind(ev)
        if str(ev.device_type()).endswith("CUDA"):
            kinds[k] = kinds.get(k, 0) + 1
        if k in DEVICE_KINDS:
            ops.append((ev.name(), start, end))
        elif ev.name() == WINDOW_MARK and not str(
                ev.device_type()).endswith("CUDA"):
            window = (start, end)
    if window is None or not ops:
        return None
    trace = DeviceTrace(window[0], window[1], ops,
                        window[0] - host_open * 1e9)
    trace.kinds = kinds
    return trace
