"""The port's recorder (ctts_tpu_torch/utils/timing.py) on the CPU.

(a) off: nothing recorded, one shared no-op context, no clock read;
(b) on: parents nest per thread, request ids pass to children, counter
    marks carry the request of the span open around them;
(c) a torch profiler turns recording on for its length, every span has
    its `ctts::` event, and that event's start, mapped onto the host
    clock by the offset the benchmark's trace takes (benchmark/trace.py
    DeviceTrace.offset_ns), lies within 100 us of the span's; a new
    profiler session starts a fresh ring;
(d) a ring that overflows counts what it dropped in `trace.dropped`;
(e) counters from many threads lose no increment;
(f) BatchSynthesizer.stream over 3 tiny batches: every span of batch N,
    on the calling thread and on `ctts-drain`, carries N's request id;
    the counters of rows, pad rows, buckets and copied bytes;
(g) CTTSEngine.synthesize: one request a call, its compile, lowering,
    core run and syncs under it;
(h) the stage timer's report keeps its form.
"""

import io
import re
import sys
import threading
import time
from collections import deque

import pytest
import torch

from ctts_tpu_torch.config import config_defaults
from ctts_tpu_torch.db.reader import VoiceDatabase
from ctts_tpu_torch.utils import timing

CPU = torch.device("cpu")
BATCHES = [["como vai", "bom dia. tudo bem."],
           ["que legal", "a rosa", "oi"],
           ["vamos", "oi"]]


@pytest.fixture(autouse=True)
def _fresh():
    timing.disable()
    timing.reset()
    yield
    timing.disable()
    timing.reset()


def _names(snap):
    return [s.name for s in snap["spans"]]


def _totals(snap):
    out: dict = {}
    for m in snap["marks"]:
        out[m.name] = out.get(m.name, 0) + m.n
    return out


def test_off_records_nothing(monkeypatch):
    assert not timing.recording()
    a, b = timing.span("a"), timing.span("b", 3)
    assert a is b

    def no_clock():
        raise AssertionError("the clock was read")

    monkeypatch.setattr(timing.time, "perf_counter_ns", no_clock)
    with timing.span("x") as sp:
        timing.count("rows.real", 4)
    assert sp is a
    snap = timing.snapshot()
    assert snap["spans"] == [] and snap["marks"] == []
    assert snap["dropped"] == 0


def test_spans_nest_per_thread_and_pass_request_ids():
    timing.enable()
    box = {}

    def other():
        with timing.span("t.outer", 7):
            with timing.span("t.inner"):
                timing.count("rows.pad", 2)
        box["done"] = True

    with timing.span("outer", 1):
        with timing.span("inner"):
            th = threading.Thread(target=other, name="worker")
            th.start()
            th.join(timeout=30)
            assert not th.is_alive() and box["done"]
            timing.count("rows.real", 5)
    with timing.span("root"):
        pass
    snap = timing.snapshot()
    by = {s.name: s for s in snap["spans"]}
    assert by["inner"].parent == by["outer"].id
    assert by["outer"].parent is None and by["t.outer"].parent is None
    assert by["t.inner"].parent == by["t.outer"].id
    assert (by["outer"].req, by["inner"].req) == (1, 1)
    assert (by["t.outer"].req, by["t.inner"].req) == (7, 7)
    assert by["root"].req is None
    assert by["t.inner"].thread == "worker"
    assert by["inner"].thread == threading.current_thread().name
    assert by["outer"].start_ns <= by["inner"].start_ns \
        <= by["inner"].end_ns <= by["outer"].end_ns
    assert len({s.id for s in snap["spans"]}) == len(snap["spans"])
    marks = {m.name: m for m in snap["marks"]}
    assert (marks["rows.real"].n, marks["rows.real"].req) == (5, 1)
    assert (marks["rows.pad"].req, marks["rows.pad"].thread) == (7, "worker")
    assert _totals(snap) == {"rows.real": 5, "rows.pad": 2}
    timing.disable()
    with timing.span("after"):
        pass
    assert "after" not in _names(timing.snapshot())


def test_a_profiler_session_starts_a_fresh_ring():
    """Spans recorded under one profiler session are gone at the first
    span of the next, and what the recorder holds after a session stays
    readable until then; an enabled recorder keeps its ring."""
    from torch.profiler import ProfilerActivity, profile

    for i in range(2):
        with profile(activities=[ProfilerActivity.CPU]):
            with timing.span("s", i):
                timing.count("rows.pad", i + 1)
        with timing.span("between"):
            pass
        snap = timing.snapshot()
        assert [s.req for s in snap["spans"]] == [i]
        assert [m.n for m in snap["marks"]] == [i + 1]
    timing.enable()
    with timing.span("mine"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with timing.span("s", 2):
            pass
    assert [s.name for s in timing.snapshot()["spans"]] == ["s", "mine",
                                                             "s"]


def test_profiler_records_ctts_events_on_the_shared_clock():
    """The recorder off, a profiler on: the spans are recorded and each
    has its ctts:: event; the host offset is taken as the benchmark's
    Tracer takes it (a record_function mark, then perf_counter), after
    spans have run under the profiler, as in the Tracer's settling
    yields (the first record_function of a profile pays its set-up,
    ~1 ms, inside its event)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert timing.recording()
        with timing.span("settle"):
            pass
        with torch.profiler.record_function("bench_window"):
            host_open = time.perf_counter()
            for i in range(5):
                with timing.span("outer", i):
                    with timing.span("inner"):
                        torch.ones(256).sum()
                    time.sleep(0.001)
    assert not timing.recording()
    spans = timing.snapshot()["spans"]
    assert len(spans) == 11
    events = [e for e in prof.profiler.kineto_results.events()
              if str(e.device_type()).endswith("CPU")]
    window = next(e for e in events if e.name() == "bench_window")
    offset = window.start_ns() - host_open * 1e9
    ctts = {}
    for e in events:
        if e.name().startswith(timing.PREFIX):
            ctts.setdefault(e.name(), []).append(e.start_ns())
    for name in ("outer", "inner"):
        ours = sorted(s.start_ns for s in spans if s.name == name)
        theirs = sorted(ctts[timing.PREFIX + name])
        assert len(theirs) == len(ours) == 5
        for a, b in zip(ours, theirs):
            assert abs((b - offset) - a) < 100_000, (name, a, b - offset)


def test_ring_overflow_counts_dropped(monkeypatch):
    monkeypatch.setattr(timing, "_ring", deque(maxlen=8))
    timing.enable()
    for i in range(10):
        with timing.span("s", i):
            pass
    timing.count("rows.pad", 1)
    snap = timing.snapshot()
    assert snap["dropped"] == 3
    assert [s.req for s in snap["spans"]] == list(range(3, 10))
    assert len(snap["spans"]) + len(snap["marks"]) == 8


def test_counters_lose_no_increment_across_threads():
    timing.enable()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(2000):
                timing.count("n")
                with timing.span("w"):
                    timing.count("m", 2)

        threads = [threading.Thread(target=work) for _ in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    counters = _totals(timing.snapshot())
    assert counters["n"] == 24000 and counters["m"] == 48000


@pytest.fixture(scope="module")
def db(voice_db):
    d = VoiceDatabase(voice_db)
    yield d
    d.close()


def test_stream_spans_share_a_request_id_across_threads(db):
    from ctts_tpu_torch.parallel.batch import BatchSynthesizer

    bs = BatchSynthesizer(db, config_defaults(), device=CPU, wire=True)
    timing.enable()
    outs = list(bs.stream(iter(BATCHES)))
    timing.disable()
    assert [len(o) for o in outs] == [len(b) for b in BATCHES]
    snap = timing.snapshot()
    spans = snap["spans"]
    main = threading.current_thread().name
    reqs = sorted({s.req for s in spans if s.name == "batch.lower"})
    assert len(reqs) == 3
    by_id = {s.id: s for s in spans}
    for s in spans:
        assert s.req in reqs, s
        if s.parent is not None:
            assert by_id[s.parent].req == s.req
            assert by_id[s.parent].thread == s.thread
    for r in reqs:
        mine = [s for s in spans if s.req == r]
        names = {s.name for s in mine}
        assert {"batch.lower", "batch.enqueue", "core.run", "batch.trim",
                "trim.sync", "batch.drain", "drain.wait_copy",
                "drain.decode", "drain.rows"} <= names, names
        for s in mine:
            if s.name.startswith(("batch.drain", "drain.")):
                # The last batch drains on the calling thread.
                assert s.thread.startswith("ctts-drain") or r == reqs[-1]
            else:
                assert s.thread == main, s
    waits = [s for s in spans if s.name == "stream.wait_drain"]
    assert sorted(s.req for s in waits) == reqs[:-1]
    assert all(s.thread == main for s in waits)
    counters = _totals(snap)
    assert counters["rows.real"] >= sum(len(b) for b in BATCHES)
    assert counters["rows.pad"] + counters["rows.real"] \
        == 8 * counters["buckets"]
    assert counters["bytes.d2h"] > 0
    assert counters["buckets"] == len(
        [s for s in spans if s.name == "core.run"])
    assert {m.req for m in snap["marks"]} == set(reqs)


def test_synthesize_is_one_request_with_its_parts(db):
    from ctts_tpu_torch.models.engine import CTTSEngine

    eng = CTTSEngine(db.path, device=CPU)
    try:
        timing.enable()
        for text in ("como vai", "bom dia"):
            eng.synthesize(text)
        timing.disable()
    finally:
        eng.close()
    spans = timing.snapshot()["spans"]
    calls = [s for s in spans if s.name == "sentence"]
    assert [s.req for s in calls] == [0, 1]
    by_id = {s.id: s for s in spans}
    for call in calls:
        kids = [s for s in spans if s.parent == call.id]
        names = [s.name for s in kids]
        assert names == ["sentence.compile", "sentence.lower", "core.run",
                         "sentence.sync", "sentence.sync"], names
        assert all(s.req == call.req for s in kids)
        assert sum(s.end_ns - s.start_ns for s in kids) \
            <= call.end_ns - call.start_ns
    assert all(by_id[s.parent].name == "sentence" for s in spans
               if s.name == "sentence.lower")


def test_stage_timer_report_keeps_its_form():
    timer = timing.StageTimer()
    with timer.stage("load rules"):
        pass
    with timer.stage("execute (torch)"):
        time.sleep(0.002)
    out = io.StringIO()
    timer.report(file=out)
    lines = out.getvalue().splitlines()
    assert lines[0] == "Timing:"
    for line, name in zip(lines[1:], ("load rules", "execute (torch)",
                                      "total")):
        assert re.fullmatch(rf"  {re.escape(name):<24s} +\d+\.\d\d ms", line)
    assert len(lines) == 4
    assert timer.stages[1][1] >= 0.002
    # The stages are spans of the recorder, which they leave off.
    assert not timing.recording()
    stages = [s for s in timing.snapshot()["spans"] if s.name == "cli.stage"]
    assert [s.end_ns - s.start_ns for s in stages] == [
        round(d * 1e9) for _, d in timer.stages]
