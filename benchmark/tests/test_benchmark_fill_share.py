"""fill_native_share.batch and fill_ms.batch (benchmark/metrics/) on
synthetic runs: the share of the filled rows that the native bucket call
wrote, from the counter marks in the traced window, None where nothing
was filled, as with a program that has no such counters; the fill's
milliseconds a batch from the `lower.fill` spans in the window."""

import os
from types import SimpleNamespace

import pytest

from conftest import ROOT

from benchmark import program
from benchmark.harness import Cell, load_json

SPEC = load_json(os.path.join(ROOT, "BENCHMARK.json"))
RUN = SimpleNamespace(t_open=1.0, t_trace_close=2.0)


def _mark(name, at, n, req):
    from ctts_tpu_torch.utils.timing import Mark

    return Mark(name, at, n, "MainThread", req)


def _span(name, start, end, req):
    from ctts_tpu_torch.utils.timing import Span

    return Span(name, 0, None, "MainThread", start, end, req)


@pytest.mark.parametrize("marks,want", [
    ([("fill.rows", 1.2e9, 120, 1), ("fill.native", 1.2e9, 120, 1),
      ("fill.rows", 1.3e9, 8, 1), ("fill.native", 1.3e9, 8, 1)], 100.0),
    ([("fill.rows", 1.2e9, 30, 1), ("fill.native", 1.2e9, 30, 1),
      ("fill.rows", 1.5e9, 10, 2),                          # Python path
      ("fill.rows", 2.5e9, 50, 3),                          # after
      ("fill.native", 2.5e9, 50, 3)], 75.0),
    ([("fill.rows", 1.2e9, 40, 1)], 0.0),
    ([("buckets", 1.2e9, 6, 1)], None),                     # no fill
])
def test_native_share_reads_the_window(monkeypatch, marks, want):
    read = Cell(SPEC, "batch_1x").reader("fill_native_share.batch")
    snap = {"spans": [_span("batch.lower", 1.1e9, 1.2e9, 1)],
            "marks": [_mark(*m) for m in marks], "dropped": 0}
    monkeypatch.setattr(program, "snapshot", lambda: snap)
    got = read(RUN)
    assert got == (None if want is None else pytest.approx(want))


def test_fill_ms_reads_the_spans(monkeypatch):
    read = Cell(SPEC, "batch_1.5x").reader("fill_ms.batch")
    spans = [_span("lower.fill", 1.10e9, 1.102e9, 1),
             _span("lower.fill", 1.20e9, 1.204e9, 2),
             _span("lower.fill", 2.10e9, 2.300e9, 3),      # after
             _span("batch.lower", 1.10e9, 1.110e9, 1)]
    monkeypatch.setattr(program, "snapshot", lambda: {
        "spans": spans, "marks": [], "dropped": 0})
    assert read(RUN) == pytest.approx(3.0)
    monkeypatch.setattr(program, "snapshot", lambda: {
        "spans": spans[3:], "marks": [], "dropped": 0})
    assert read(RUN) is None                               # no fill span


@pytest.mark.parametrize("metric", ["fill_native_share.batch",
                                    "fill_ms.batch"])
def test_fill_metrics_are_silent_without_a_recorder(monkeypatch, metric):
    read = Cell(SPEC, "batch_1x").reader(metric)
    monkeypatch.setattr(program, "snapshot", lambda: None)
    assert read(RUN) is None
    assert read(SimpleNamespace(t_open=None, t_trace_close=None)) is None
