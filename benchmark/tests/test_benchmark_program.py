"""The per-layer metrics read from the program's own spans and counters
(benchmark/program.py, ctts_tpu_torch/utils/timing.py): read in the tiny
CPU cells with the recorder on, absent from an untraced run, silent for
a program without a recorder; spans and counter increments summed per
request in the traced window; the device timeline unchanged by the
spans' ctts:: annotations."""

import json
import os
import time
from types import SimpleNamespace

import pytest
import torch

from benchmark import program
from benchmark.harness import run_cell
from benchmark.trace import read_events

CPU = torch.device("cpu")
BATCH = {"copy_wait_ms.batch", "decode_ms.batch", "trim_sync_ms.batch",
         "enqueue_ms.batch", "drain_stall_ms.batch", "pad_share.batch",
         "d2h_mb.batch", "buckets.batch"}
SENTENCE = {"host_ms.sentence", "sync_ms.sentence"}


@pytest.fixture(autouse=True)
def _recorder_off():
    from ctts_tpu_torch.utils import timing

    timing.disable()
    timing.reset()
    yield timing
    timing.disable()
    timing.reset()


def _run(tiny, cell, trace):
    root, bench, spec = tiny
    return run_cell(root, spec, cell, 2**31 + 7, 1.5, trace,
                    time.perf_counter(), device=CPU, bench_dir=bench)


def _wire_on(tiny):
    """The tiny 1.0 configuration with the wire codec on, as on a card
    (off by default on the CPU), so that the drain decodes."""
    path = os.path.join(tiny[1], "configs", "ctts_ptbr_1x.json")
    with open(path) as f:
        cfg = json.load(f)
    cfg["wire"] = True
    with open(path, "w") as f:
        json.dump(cfg, f)


def test_untraced_run_never_turns_the_recorder_on(tiny, _recorder_off):
    r = _run(tiny, "batch_ctts_ptbr_1x", False)
    assert r["correct"]
    snap = _recorder_off.snapshot()
    assert snap["spans"] == [] and snap["marks"] == []
    assert snap["dropped"] == 0


@pytest.mark.parametrize("cell,want", [("batch_ctts_ptbr_1x", BATCH),
                                       ("call_ctts_ptbr_1x", SENTENCE)])
def test_new_metrics_read_with_the_recorder_on(tiny, _recorder_off, cell,
                                               want):
    """A traced run on the CPU runs no profiler: with the recorder on,
    as the profiler turns it on in a run on the card, every metric of
    the program's spans and counters reads a number."""
    _wire_on(tiny)
    _recorder_off.enable()
    r = _run(tiny, cell, True)
    assert r["correct"]
    got = {k: v["value"] for k, v in r["metrics"].items()}
    assert want <= set(got), got
    for name in want:
        assert got[name] >= 0
    if cell.startswith("batch"):
        assert 0 < got["pad_share.batch"] < 100
        assert got["decode_ms.batch"] > 0 and got["enqueue_ms.batch"] > 0
        assert got["d2h_mb.batch"] > 0 and got["buckets.batch"] >= 1
    else:
        assert got["host_ms.sentence"] > 0 and got["sync_ms.sentence"] > 0


def _span(name, thread, start, end, req=0):
    from ctts_tpu_torch.utils.timing import Span

    return Span(name, 0, None, thread, start, end, req)


def _mark(name, at, n, req):
    from ctts_tpu_torch.utils.timing import Mark

    return Mark(name, at, n, "MainThread", req)


def test_readers_are_silent_without_a_recorder(monkeypatch):
    from ctts_tpu_torch.utils import timing

    run = SimpleNamespace(t_open=1.0, t_trace_close=2.0)
    monkeypatch.delattr(timing, "snapshot")
    assert program.snapshot() is None
    assert program.per_request_ms(run, ("drain.decode",)) is None
    assert program.counted(run, "rows.pad") is None
    assert program.per_request_count(run, "buckets") is None


def test_window_sums_per_request_and_refuses_a_dropped_start():
    run = SimpleNamespace(t_open=1.0, t_trace_close=2.0)
    spans = [_span("drain.decode", "d", 0.5e9, 0.9e9, 0),   # before
             _span("drain.decode", "d", 1.0e9, 1.1e9, 1),
             _span("drain.decode", "d", 1.1e9, 1.3e9, 1),
             _span("drain.decode", "d", 1.5e9, 1.6e9, 2),
             _span("drain.decode", "d", 1.9e9, 2.1e9, 3)]   # after
    snap = {"spans": spans, "marks": [], "dropped": 0}
    got = program.window(run, snap)
    assert [s.req for s in got[0]] == [1, 1, 2]
    snap["dropped"] = 4                        # dropped before the window
    assert program.window(run, snap) is not None
    snap["spans"] = spans[2:]                  # dropped inside it
    assert program.window(run, snap) is None


class _Ev:
    def __init__(self, name, device, kind, start, dur):
        self._v = (name, device, kind, start, dur)

    def name(self):
        return self._v[0]

    def device_type(self):
        return "DeviceType." + self._v[1]

    def activity_type(self):
        return self._v[2]

    def is_user_annotation(self):
        return self._v[2] in ("user_annotation", "gpu_user_annotation")

    def start_ns(self):
        return self._v[3]

    def duration_ns(self):
        return self._v[4]


def test_ctts_annotations_leave_the_device_timeline_alone():
    base = [_Ev("bench_window", "CPU", "user_annotation", 0, 1000),
            _Ev("k1", "CUDA", "kernel", 100, 100),
            _Ev("copy", "CUDA", "gpu_memcpy", 400, 50),
            _Ev("k2", "CUDA", "kernel", 700, 100)]
    notes = [_Ev("ctts::batch.enqueue", "CPU", "user_annotation", 50, 300),
             _Ev("ctts::batch.enqueue", "CUDA", "gpu_user_annotation",
                 100, 700),
             _Ev("ctts::core.run", "CUDA", "gpu_user_annotation", 0, 1000)]
    plain = read_events(base, 0.0)
    noted = read_events(base + notes, 0.0)
    assert plain.busy_s == noted.busy_s == 250e-9
    assert plain.window_s == noted.window_s
    assert sum(v for k, v in noted.kinds.items() if "annotation" in k) == 2


def test_counts_and_spans_are_means_over_requests(monkeypatch):
    """Each reader sums a request's spans or increments inside the
    window [t_open, t_trace_close] and averages over the requests."""
    run = SimpleNamespace(t_open=1.0, t_trace_close=2.0)
    snap = {"spans": [_span("drain.decode", "d", 1.0e9, 1.1e9, 1),
                      _span("drain.decode", "d", 1.1e9, 1.3e9, 1),
                      _span("drain.rows", "d", 1.3e9, 1.4e9, 1),
                      _span("drain.decode", "d", 1.5e9, 1.6e9, 2)],
            "marks": [_mark("buckets", 0.9e9, 5, 0),          # before
                      _mark("buckets", 1.2e9, 1, 1),
                      _mark("buckets", 1.3e9, 1, 1),
                      _mark("bytes.d2h", 1.3e9, 4000, 1),
                      _mark("buckets", 1.6e9, 1, 2),
                      _mark("buckets", 1.7e9, 1, None)],     # no request
            "dropped": 0}
    monkeypatch.setattr(program, "snapshot", lambda: snap)
    assert program.per_request_ms(run, ("drain.decode",)) \
        == pytest.approx((300 + 100) / 2)
    assert program.per_request_ms(run, ("drain.decode", "drain.rows")) \
        == pytest.approx((400 + 100) / 2)
    assert program.per_request_count(run, "buckets") == pytest.approx(1.5)
    assert program.per_request_count(run, "bytes.d2h") == 4000
    assert program.counted(run, "buckets") == 4
    assert program.per_request_count(run, "rows.pad") is None
