#!/usr/bin/env python3
"""Device milliseconds per stage of one batch of the port's synthesis
core on one CUDA card: the counterpart of tools/profile_stages.py.

    python3 tools/torch_profile_stages.py [--reps N] [--root DIR]

DIR (default: this checkout) is the root of a checkout whose
ctts_tpu_torch is profiled, one with the compiled core's staged
methods (prologue / refine_trip / epilogue); the batch and the timers
come from this checkout's chip_smoke.py.

The JAX tool cuts the jitted core after each stage and takes wall-clock
differences. Here the eager core (synth/device.py SynthesisCore, with
synth/compiled.py's pack and wire encode after it, as the epilogue
graph covers them) runs one batch with every stage's entry and exit
marked (stage_marks): each mark waits for the card, enqueues a spin
kernel that outlasts the host's enqueue of what follows (checked, and
lengthened until it does), and records a CUDA event. (One spin before
the whole batch cannot keep the host out: the batch makes more launches
than the card's launch queue holds.) The time between two marks goes to
the innermost stage open at the first, the spins to none. Each stage
gets two numbers: its device ms, the durations of its kernels, copies
and fills in a torch.profiler trace of one such batch (the spin kernels
split the card's in-order timeline into the marks' intervals), and its
event ms, the CUDA events' medians over --reps batches, which also hold
the eager core's gaps between kernels. The batch is chip_smoke.py's
serving bucket (batch_texts(0), 144 rows at 1.0) at speed 1.0 and 1.5,
served as a card serves it (the wire codec on). Stages, in order:
  prologue (bank pick and crossfade curves: on the card one unit_base
  launch and its glue, a checkout from before that kernel its XLA-form
  ops; head pitch, K2), each refine trip (compose K1; boundary_heads,
  K2; the contributions, one unit_contrib launch, and glue; before that
  kernel the contributions are in the glue), the epilogue's
  contributions and glue, the final compose (K1), tail
  fades, the silence tables (on the card one ctts_silence_tables launch
  and the fill of its overflow counts; a checkout from before that
  kernel runs the XLA-form ops, its torch.cumsum scans on a row of their
  own), compaction (K3), the contour and interrogative-fall zones,
  region_post, assembly (K4), WSOLA (K5 with its energy table and
  finish; at 1.5), the pack and wire encode (one pack_encode launch; a
  checkout from before it: pack, then wire encode, each in XLA form),
  and "other" (outside every stage).
Checks, each printed, the exit code 1 where one fails:
  - the stages' device ms sum to within 5% of torch.profiler's device
    total (kernels, copies and fills) for the same batch run unmarked;
  - the batch's captured graphs (prologue, the trip graph once per trip,
    epilogue), replayed behind a spin kernel, take within 5% of that
    total.
A trace that lacks a pause's spin kernel (a rare event, seen at 1.5)
is described (which pause, the spin time its CUDA
events measured, the kernel launches of the run that have no kernel in
the trace) in "spin_losses", and the profiled batch runs again, at
most SPIN_RETRIES times.
One JSON line a speed, then the card's name and power limit. Needs one
CUDA card, and fails without one.
"""

import argparse
import importlib.util
import json
import os
import sys
import time
from contextlib import contextmanager

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TOLERANCE = 0.05
SPIN_CYCLES = 200_000_000   # ~0.1 s at the H100's clock, doubled as needed
PAUSE_CYCLES = 40_000_000   # ~20 ms, before each stage
OTHER = "other"
PAUSE = "(spin)"
SPIN_KERNEL = "spin_kernel"     # what torch.cuda._sleep launches
SCANS = "silence tables: cumsum scans (XLA form)"
SPIN_RETRIES = 3


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


class StageMarks:
    """Stamps at each stage's entry and exit: `stamp()` makes one (a
    recorded CUDA event on the card, a host clock reading in the CPU
    test). The interval from a stamp to the next belongs to the
    innermost stage open at the first, or to OTHER. With `pause`, every
    entry and exit is preceded by pause() (on the card: wait for the
    card, then a spin kernel that lets the host enqueue what follows
    before the card reaches it); the paused intervals belong to PAUSE
    and count in no stage, and `pauses` keeps, per pause, its PAUSE mark
    and the host clock before and after it."""

    def __init__(self, stamp, pause=None):
        self.stamp = stamp
        self.pause = pause
        self.marks = []
        self.stack = []
        self.pauses = []          # (index of the PAUSE mark, clock, clock)

    def _enter(self, label: str) -> None:
        if self.pause is not None:
            before = time.perf_counter()
            self.marks.append((self.stamp(), PAUSE))
            self.pause()
            self.pauses.append((len(self.marks) - 1, before,
                                time.perf_counter()))
        self.marks.append((self.stamp(), label))

    def open(self, label: str) -> None:
        self.stack.append(label)
        self._enter(label)

    def close(self) -> None:
        self.stack.pop()
        self._enter(self.top() or OTHER)

    def top(self):
        return self.stack[-1] if self.stack else None

    def totals(self, elapsed) -> dict:
        """label -> summed milliseconds, elapsed(a, b) the ms between two
        stamps; every interval but the paused ones is counted once."""
        out: dict = {}
        for (a, label), (b, _) in zip(self.marks, self.marks[1:]):
            if label != PAUSE:
                out[label] = out.get(label, 0.0) + elapsed(a, b)
        return out

    def paused_labels(self) -> list:
        """The label of the interval after each pause, in order."""
        return [self.marks[i + 1][1] for i, _, _ in self.pauses]

    def short_pauses(self, elapsed, end_s: float) -> list:
        """The pauses that did not outlast the host's enqueue of what
        follows them (up to the next pause, or end_s): (the stage after
        it, pause ms on the card, enqueue ms on the host)."""
        short = []
        for k, (i, _, t0) in enumerate(self.pauses):
            t1 = self.pauses[k + 1][1] if k + 1 < len(self.pauses) else end_s
            spin_ms = elapsed(self.marks[i][0], self.marks[i + 1][0])
            if spin_ms <= 1.2 * (t1 - t0) * 1e3:
                short.append((self.marks[i + 1][1], spin_ms,
                              (t1 - t0) * 1e3))
        return short


class SpinLost(RuntimeError):
    """The trace holds fewer or more spin kernels than the run paused."""


def spin_loss(events: list, spin_ms: list, labels: list) -> dict:
    """What a trace that lost spin kernels shows: the pauses whose spin
    is missing (the trace's spins aligned in order with the spin times
    the CUDA events measured, spin_ms, within 10%), and the kernel
    launches on the host side (cudaLaunchKernel and the like) whose
    correlation id has no kernel in the trace."""
    spins = sorted((e for e in events if e.get("ph") == "X"
                    and e.get("cat") == "kernel"
                    and SPIN_KERNEL in e.get("name", "")),
                   key=lambda e: float(e["ts"]))
    got = [float(e["dur"]) / 1e3 for e in spins]
    missing, j = [], 0
    for i, want in enumerate(spin_ms):
        if j < len(got) and abs(got[j] - want) <= 0.1 * want:
            j += 1
        else:
            missing.append({"pause": i, "of": len(spin_ms),
                            "label_after": labels[i], "spin_ms": want})
    kernels = {e.get("args", {}).get("correlation") for e in events
               if e.get("ph") == "X" and e.get("cat") == "kernel"}
    orphans = [e for e in events if e.get("ph") == "X"
               and e.get("cat") == "cuda_runtime"
               and "LaunchKernel" in e.get("name", "")
               and e.get("args", {}).get("correlation") not in kernels]
    return {"spins_traced": len(got), "pauses": len(spin_ms),
            "missing": missing, "unaligned_spins": len(got) - j,
            "launches_without_kernel": len(orphans),
            "first_orphan_ts_us": [float(e["ts"]) for e in orphans[:4]]}


def attribute(device_events: list, labels: list) -> dict:
    """Device time per stage from a profiler trace of a paused batch:
    the card runs one stream in order, so its kernels, copies and fills
    (device_events), sorted by start, fall between the spin kernels of
    the pauses, and the run after the k-th spin belongs to labels[k].
    Returns label -> {"ms": summed durations, "ops": count}."""
    evs = sorted(device_events, key=lambda e: float(e["ts"]))
    spins = [k for k, e in enumerate(evs) if SPIN_KERNEL in e["name"]]
    if len(spins) != len(labels):
        raise SpinLost(f"{len(spins)} spin kernels in the trace for "
                       f"{len(labels)} pauses")
    out: dict = {}
    for k, start in enumerate(spins):
        end = spins[k + 1] if k + 1 < len(spins) else len(evs)
        got = out.setdefault(labels[k], {"ms": 0.0, "ops": 0})
        for e in evs[start + 1:end]:
            got["ms"] += float(e["dur"]) / 1e3
            got["ops"] += 1
    if spins and spins[0] != 0:
        raise RuntimeError("device work in the trace before the first pause")
    return out


# Each stage: the function wrapped, and its label, or the label it takes
# inside each enclosing stage (elsewhere it runs unmarked).
PROLOGUE = "prologue: bank pick and curves"
TRIP = "refine trip: contributions and glue"
EPILOGUE = "epilogue: contributions and glue"
SEGTABLES = "silence tables (kernel; XLA form: all but the scans)"
METHODS = {
    "prologue": PROLOGUE,
    "_head_pitch": {PROLOGUE: "prologue: head pitch (K2)"},
    "refine_trip": TRIP,
    "_boundary_heads": {TRIP: "refine trip: boundary_heads (K2)"},
    "_compose": {TRIP: "refine trip: compose (K1)",
                 EPILOGUE: "final compose (K1)"},
    "_contrib": {TRIP: "refine trip: contributions (unit_contrib)",
                 EPILOGUE: "epilogue: contributions (unit_contrib)"},
    "epilogue": EPILOGUE,
    "_tail_fades": "tail fades",
    "_seg_tables": SEGTABLES,
    "_contour": "contour and fall zones",
    "_region_post": "region_post",
    "_layout": "assembly (K4)",
    "_assemble": "assembly (K4)",
}
PACK_ENCODE = "pack and wire encode (pack_encode)"
FUNCTIONS = [("synth.device", "compact", "compaction (K3)"),
             ("synth.device", "time_stretch", "WSOLA (K5, tables, finish)"),
             ("synth.device", "unit_base", {PROLOGUE: "prologue: unit_base"}),
             ("synth.compiled", "pack_encode", PACK_ENCODE),
             ("synth.compiled", "pack_rows", "pack"),
             ("ops.wire", "encode", "wire encode"),
             ("torch", "cumsum", {SEGTABLES: SCANS})]


@contextmanager
def stage_marks(core, marks: StageMarks):
    """Wrap the stages of `core` (METHODS, and FUNCTIONS: the module
    functions it and synth/compiled.py call, torch.cumsum inside the
    silence tables) so that each opens and closes its stage on `marks`;
    everything is restored on exit. The computation is unchanged. A
    method or function the checkout lacks (one from before it) is not
    marked: its ops stay in the stage that calls them."""
    import importlib

    def staged(fn, label):
        def call(*args, **kwargs):
            name = label.get(marks.top()) if isinstance(label, dict) \
                else label
            if name is None:
                return fn(*args, **kwargs)
            marks.open(name)
            try:
                return fn(*args, **kwargs)
            finally:
                marks.close()
        return call

    mods = [(importlib.import_module(
        m if m == "torch" else f"ctts_tpu_torch.{m}"), name, label)
        for m, name, label in FUNCTIONS]
    mods = [(mod, name, label) for mod, name, label in mods
            if hasattr(mod, name)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in mods]
    methods = [name for name in METHODS if hasattr(core, name)]
    for name in methods:
        setattr(core, name, staged(getattr(core, name), METHODS[name]))
    for mod, name, label in mods:
        setattr(mod, name, staged(getattr(mod, name), label))
    try:
        yield marks
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
        for name in methods:
            delattr(core, name)


def marked_batch(core, batch, stamp, pause=None):
    """batch() (one batch of `core`) with the core's stages marked:
    (its outputs, StageMarks, host clock at its end)."""
    marks = StageMarks(stamp, pause)
    with stage_marks(core, marks):
        marks.open(OTHER)
        out = batch()
        marks.close()
    return out, marks, time.perf_counter()


def eager_stages(cs, torch, np, core, batch, reps: int):
    """batch() (one eager batch of `core`) with every stage entry and
    exit paused (on an idle card, behind a spin kernel): from one such
    run under torch.profiler, each stage's kernel, copy and fill ms
    (attribute); and each stage's CUDA event ms, medians over reps,
    which also hold the eager core's launch gaps between kernels, with
    every spin checked to outlast the host's enqueue of what follows it
    (and lengthened until it does). Returns (stage -> {"ms", "ops",
    "event_ms"}, the pause's cycles, spin_loss() of each profiled run
    whose trace lost a spin kernel, before the one used)."""
    def stamp():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def elapsed(a, b):
        return a.elapsed_time(b)

    def pause():
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)

    def run():
        torch.cuda.synchronize()
        _, marks, end_s = marked_batch(core, batch, stamp, pause)
        torch.cuda.synchronize()
        return marks, marks.short_pauses(elapsed, end_s)

    per = {}
    cycles = PAUSE_CYCLES
    profiled = None
    lost = []
    while profiled is None:
        timing = len(next(iter(per.values()), [])) < reps
        if timing:
            marks, short = run()
        else:
            (marks, short), events, _ = cs.profile_events(torch, run)
        if short:
            cycles *= 2
            if cycles > 16 * PAUSE_CYCLES:
                raise RuntimeError(f"stages whose enqueue outlasted every "
                                   f"spin (stage, spin ms, host ms): {short}")
            continue
        if timing:
            for k, v in marks.totals(elapsed).items():
                per.setdefault(k, []).append(v)
            continue
        labels = marks.paused_labels()
        try:
            profiled = attribute(cs.device_events(events), labels)
        except SpinLost:
            spin_ms = [elapsed(marks.marks[i][0], marks.marks[i + 1][0])
                       for i, _, _ in marks.pauses]
            lost.append(spin_loss(events, spin_ms, labels))
            print("spin_loss " + json.dumps(lost[-1]), flush=True)
            if len(lost) > SPIN_RETRIES:
                raise
    stages = {k: dict(v, event_ms=float(np.median(per[k])))
              for k, v in profiled.items()}
    return stages, cycles, lost


def behind_spin(torch, enqueue):
    """Enqueue `enqueue()` (a few launches) behind a spin kernel long
    enough to outlast the host's enqueue; returns enqueue()'s result once
    the card is done, and raises if no spin outlasted it."""
    cycles = SPIN_CYCLES
    for _ in range(4):
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        a = torch.cuda.Event(enable_timing=True)
        s.record()
        torch.cuda._sleep(cycles)
        a.record()
        t0 = time.perf_counter()
        out = enqueue()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if s.elapsed_time(a) > 1.2 * host_ms:
            return out
        cycles *= 2
    raise RuntimeError("the spin never outlasted the enqueue")


def graph_ms(torch, np, entry, merged, trips: int, reps: int) -> float:
    """Device ms of the three graphs of a signature, replayed behind a
    spin kernel (median over reps)."""
    entry.layout.upload(merged, entry.static_in.device, entry.static_in)
    times = []
    for _ in range(reps):
        def enqueue():
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            entry.prologue.replay()
            for _ in range(trips):
                entry.trip.replay()
            entry.epilogue.replay()
            b.record()
            return a, b
        a, b = behind_spin(torch, enqueue)
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def profiler_totals(cs, torch, run) -> dict:
    """torch.profiler's device totals over run(): kernels, and copies
    and fills."""
    _, events, _ = cs.profile_events(torch, run)
    dev = cs.device_events(events)
    kern = [e for e in dev if e["cat"] == "kernel"]
    k_ms = sum(float(e["dur"]) for e in kern) / 1e3
    cf_ms = sum(float(e["dur"]) for e in dev if e["cat"] != "kernel") / 1e3
    return {"kernel_ms": k_ms, "copy_fill_ms": cf_ms,
            "device_ms": k_ms + cf_ms, "kernels": len(kern)}


def profile_speed(cs, torch, np, bs, speed: float, reps: int) -> dict:
    """The stage table of one serving batch at `speed`, its checks and
    its graphs' device time."""
    core = bs.shards[0].core
    (_, per_bucket), _ = bs._lower_batch(cs.batch_texts(0), speed, True)
    per_bucket.sort(key=lambda b: -b[2][1]["speed"].shape[0])
    dims, _, (n, stacked, shared) = per_bucket[0]
    res = {"speed": speed, "rows": int(stacked["speed"].shape[0]),
           "real_rows": n, "buckets": len(per_bucket)}
    from ctts_tpu_torch.synth import compiled
    from ctts_tpu_torch.synth.device import refine_depth

    sig, layout, merged = compiled.signature(core, dims, stacked, shared,
                                             bs.wire)
    trips = refine_depth(merged)
    for _ in range(2):    # a signature's first batch runs eagerly, its
        compiled.run_batch(core, dims, stacked, shared, bs.wire)  # second
    entry = compiled.captured(sig)                                # captures
    if entry is None:
        raise RuntimeError(f"speed {speed}: the batch was not captured")
    ar = layout.upload(merged, bs.device)

    def batch():
        return compiled.batch_core(core, dims, ar, trips, bs.wire)

    batch()                                                 # warm-up
    stages, cycles, lost = eager_stages(cs, torch, np, core, batch, reps)
    prof = profiler_totals(cs, torch, batch)
    g_ms = graph_ms(torch, np, entry, merged, trips, reps)
    stage_sum = sum(v["ms"] for v in stages.values())
    event_sum = sum(v["event_ms"] for v in stages.values())
    checks = {
        "stage_sum_within_5pct_of_profiler":
            abs(stage_sum / prof["device_ms"] - 1) <= TOLERANCE,
        "graphs_within_5pct_of_eager":
            abs(g_ms / prof["device_ms"] - 1) <= TOLERANCE}
    trip = sum(v["ms"] for k, v in stages.items()
               if k.startswith("refine trip"))
    return dict(
        res, trips=trips, wire=bs.wire, stages=stages,
        refine_trip_ms_each=trip / max(trips, 1),
        stage_sum_ms=stage_sum, event_sum_ms=event_sum,
        pause_cycles=cycles, spin_losses=lost, profiler=prof,
        stage_sum_over_profiler=stage_sum / prof["device_ms"],
        event_sum_over_profiler=event_sum / prof["device_ms"],
        graph_ms=g_ms, graph_over_eager=g_ms / prof["device_ms"],
        checks=checks)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--root", default=HERE)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_profile_stages.py: no CUDA device", file=sys.stderr)
        return 2
    import tempfile

    from ctts_tpu_torch import env
    from ctts_tpu_torch.config import config_defaults
    from ctts_tpu_torch.db.reader import VoiceDatabase
    from ctts_tpu_torch.parallel.batch import BatchSynthesizer

    cs = _chip_smoke()
    rc = 0
    with tempfile.TemporaryDirectory() as tmp, torch.no_grad():
        db = VoiceDatabase(cs.make_voice(tmp))
        bs = BatchSynthesizer(db, config_defaults(), device=env.device(),
                              dims_floor=cs.FLOOR)
        for speed in (1.0, cs.STRETCH_SPEED):
            res = profile_speed(cs, torch, np, bs, speed, args.reps)
            print("stages " + json.dumps(dict(res, root=root)), flush=True)
            rc = rc or (0 if all(res["checks"].values()) else 1)
    print(env.gpu_name_and_power_limit(), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
