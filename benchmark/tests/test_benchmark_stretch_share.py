"""stretch_batched_share.batch (benchmark/metrics/) on synthetic runs: the
share of the stretching buckets' real rows whose decide ran in the
batch's table launch, from the counter marks in the traced window; None
without stretch rows, as at speed 1.0 or with a program that has no such
counters."""

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
    ([("stretch.rows", 1.2e9, 120, 1), ("stretch.batched", 1.2e9, 120, 1),
      ("stretch.rows", 1.3e9, 8, 1), ("stretch.batched", 1.3e9, 8, 1)],
     100.0),
    ([("stretch.rows", 1.2e9, 30, 1), ("stretch.batched", 1.2e9, 30, 1),
      ("stretch.rows", 1.5e9, 10, 2),            # a first, eager batch
      ("stretch.batched", 1.5e9, 0, 2),
      ("stretch.rows", 2.5e9, 50, 3),            # after the window
      ("stretch.batched", 2.5e9, 50, 3)], 75.0),
    ([("stretch.rows", 1.2e9, 40, 1)], 0.0),
    ([("buckets", 1.2e9, 6, 1), ("rows.real", 1.2e9, 128, 1)], None),
])
def test_stretch_share_reads_the_window(monkeypatch, marks, want):
    read = Cell(SPEC, "batch_1.5x").reader("stretch_batched_share.batch")
    snap = {"spans": [_span("batch.enqueue", 1.1e9, 1.2e9, 1)],
            "marks": [_mark(*m) for m in marks], "dropped": 0}
    monkeypatch.setattr(program, "snapshot", lambda: snap)
    got = read(RUN)
    assert got == (None if want is None else pytest.approx(want))


def test_stretch_share_is_silent_without_a_recorder(monkeypatch):
    read = Cell(SPEC, "batch_1.5x").reader("stretch_batched_share.batch")
    monkeypatch.setattr(program, "snapshot", lambda: None)
    assert read(RUN) is None
    assert read(SimpleNamespace(t_open=None, t_trace_close=None)) is None
