"""The codec-off drain's readers (benchmark/metrics/raw_ms.batch.py,
raw_native_share.batch.py) on synthetic runs: the `drain.raw` spans and
the raw.samples / raw.native counter marks of the traced window; None
where nothing was copied, as with a program that has no such span or
counters. The cell batch_1x_wire0 takes the codec off and reads them."""

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

    return Mark(name, at, n, "ctts-drain_0", req)


def _span(name, start, end, req):
    from ctts_tpu_torch.utils.timing import Span

    return Span(name, 0, None, "ctts-drain_0", start, end, req)


@pytest.mark.parametrize("marks,want", [
    ([("raw.samples", 1.2e9, 4000, 1), ("raw.native", 1.2e9, 4000, 1),
      ("raw.samples", 1.5e9, 1000, 2), ("raw.native", 1.5e9, 0, 2),
      ("raw.samples", 2.5e9, 9000, 3),                      # after
      ("raw.native", 2.5e9, 9000, 3)], 80.0),
    ([("raw.samples", 1.2e9, 4000, 1), ("raw.native", 1.2e9, 4000, 1)],
     100.0),
    ([("raw.samples", 1.2e9, 4000, 1), ("raw.native", 1.2e9, 3000, 1)],
     75.0),
    ([("decode.samples", 1.2e9, 4000, 1),
      ("decode.vector", 1.2e9, 4000, 1)], None),            # codec on
    ([("buckets", 1.2e9, 6, 1)], None),                     # no copy
])
def test_native_share_reads_the_window(monkeypatch, marks, want):
    read = Cell(SPEC, "batch_1x_wire0").reader("raw_native_share.batch")
    snap = {"spans": [_span("drain.raw", 1.1e9, 1.2e9, 1)],
            "marks": [_mark(*m) for m in marks], "dropped": 0}
    monkeypatch.setattr(program, "snapshot", lambda: snap)
    got = read(RUN)
    assert got == (None if want is None else pytest.approx(want))


def test_raw_ms_is_the_mean_a_batch(monkeypatch):
    read = Cell(SPEC, "batch_1x_wire0").reader("raw_ms.batch")
    spans = [_span("drain.raw", 0.5e9, 0.9e9, 0),           # before
             _span("drain.raw", 1.0e9, 1.004e9, 1),
             _span("drain.raw", 1.5e9, 1.508e9, 2),
             _span("drain.decode", 1.6e9, 1.7e9, 3),        # codec on
             _span("drain.raw", 1.9e9, 2.1e9, 4)]           # after
    monkeypatch.setattr(program, "snapshot", lambda: {
        "spans": spans, "marks": [], "dropped": 0})
    assert read(RUN) == pytest.approx(6.0)
    monkeypatch.setattr(program, "snapshot", lambda: {
        "spans": [_span("drain.decode", 1.1e9, 1.2e9, 1)], "marks": [],
        "dropped": 0})
    assert read(RUN) is None


@pytest.mark.parametrize("metric", ["raw_ms.batch", "raw_native_share.batch"])
def test_readers_are_silent_without_a_recorder(monkeypatch, metric):
    read = Cell(SPEC, "batch_1x_wire0").reader(metric)
    monkeypatch.setattr(program, "snapshot", lambda: None)
    assert read(RUN) is None
    assert read(SimpleNamespace(t_open=None, t_trace_close=None)) is None


def test_cell_takes_the_codec_off_and_reads_its_metrics():
    cell = Cell(SPEC, "batch_1x_wire0")
    assert cell.config["wire"] is False
    assert cell.workload["traffic"] == "batch"
    assert cell.workload["chips"] == 1
    assert {k: v for k, v in cell.config.items()
            if k not in ("name", "deployment", "dims_floor_source", "wire",
                         "wire_note", "assumed", "reference")} == {
        k: v for k, v in Cell(SPEC, "batch_1x").config.items()
        if k not in ("name", "deployment", "dims_floor_source", "wire",
                     "wire_note", "assumed")}
    assert [m["name"] for m in cell.end_to_end] == [
        "setup_s", "audio_s_per_s", "batch_p95_ms"]
    assert sorted(m["name"] for m in cell.per_layer) == sorted(
        n + ".batch" for n in (
            "lower_ms", "drain_ms", "device_ms", "idle_share",
            "copy_wait_ms", "trim_sync_ms", "enqueue_ms", "drain_stall_ms",
            "pad_share", "d2h_mb", "buckets", "fill_ms",
            "fill_native_share", "raw_ms", "raw_native_share"))
