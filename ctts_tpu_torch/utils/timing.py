"""Per-stage timing observability.

Counterpart of ctts_tpu/utils/timing.py. The reference has a
`print_timing` config flag that is parsed but never read (SURVEY.md
§5.1 — a stub). Here it is implemented for real: a lightweight stage
timer the engine uses when the flag is set (a copy of the JAX
package's), plus a torch.profiler trace for device work.

A stage that ends on device work reads its clock only once that work is
on the host: the port's entry points (execute_plan_torch,
BatchSynthesizer.synthesize, CTTSEngine) return numpy arrays, which
wait for the card, so a stage around one of them times the device work
too.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time


class StageTimer:
    """Wall-clock per-stage timings; prints a summary like the reference
    prints its stats."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.stages: list[tuple[str, float]] = []

    @contextlib.contextmanager
    def stage(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stages.append((name, time.perf_counter() - t0))

    def report(self, file=sys.stderr) -> None:
        if not self.enabled or not self.stages:
            return
        total = sum(d for _, d in self.stages)
        print("Timing:", file=file)
        for name, dur in self.stages:
            print(f"  {name:<24s} {dur * 1000:9.2f} ms", file=file)
        print(f"  {'total':<24s} {total * 1000:9.2f} ms", file=file)


@contextlib.contextmanager
def device_trace(trace_dir: str | None):
    """Wrap a block in a torch.profiler trace (CPU and, where there is a
    card, CUDA activity) when a directory is given; the Chrome trace is
    written to `trace_dir`/trace.json when the block ends."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
