"""decode_vector_share.batch (benchmark/metrics/decode_vector_share.batch.py)
on synthetic runs: the share of the decoded samples that the vector path
wrote, from the counter marks in the traced window; None where nothing
was decoded, as with a program that has no such counters."""

import os
from types import SimpleNamespace

import pytest

from conftest import ROOT

from benchmark import program
from benchmark.harness import Cell, load_json

SPEC = load_json(os.path.join(ROOT, "BENCHMARK.json"))


def _mark(name, at, n, req):
    from ctts_tpu_torch.utils.timing import Mark

    return Mark(name, at, n, "ctts-drain_0", req)


def _span(name, start, end, req):
    from ctts_tpu_torch.utils.timing import Span

    return Span(name, 0, None, "ctts-drain_0", start, end, req)


@pytest.mark.parametrize("marks,want", [
    ([("decode.samples", 1.2e9, 4000, 1), ("decode.vector", 1.2e9, 4000, 1),
      ("decode.samples", 1.5e9, 1000, 2), ("decode.vector", 1.5e9, 0, 2),
      ("decode.samples", 2.5e9, 9000, 3),                   # after
      ("decode.vector", 2.5e9, 9000, 3)], 80.0),
    ([("decode.samples", 1.2e9, 4000, 1), ("decode.vector", 1.2e9, 4000, 1)],
     100.0),
    ([("decode.samples", 1.2e9, 4000, 1), ("decode.vector", 1.2e9, 0, 1)],
     0.0),
    ([("buckets", 1.2e9, 6, 1)], None),                     # no decode
])
def test_vector_share_reads_the_window(monkeypatch, marks, want):
    cell = Cell(SPEC, "batch_1x")
    read = cell.reader("decode_vector_share.batch")
    run = SimpleNamespace(t_open=1.0, t_trace_close=2.0)
    snap = {"spans": [_span("drain.decode", 1.1e9, 1.2e9, 1)],
            "marks": [_mark(*m) for m in marks], "dropped": 0}
    monkeypatch.setattr(program, "snapshot", lambda: snap)
    got = read(run)
    assert got == (None if want is None else pytest.approx(want))


def test_vector_share_is_silent_without_a_recorder(monkeypatch):
    read = Cell(SPEC, "batch_1.5x").reader("decode_vector_share.batch")
    monkeypatch.setattr(program, "snapshot", lambda: None)
    assert read(SimpleNamespace(t_open=1.0, t_trace_close=2.0)) is None
    assert read(SimpleNamespace(t_open=None, t_trace_close=None)) is None
