"""The frozen arithmetic on synthetic inputs: the idle share as the
union of device intervals, the metrics over every request, and the
WSOLA bound as a lower bound of the work the chain does."""

import dataclasses
import os

import numpy as np
import pytest

from conftest import ROOT

from benchmark import trace, yardstick
from benchmark.harness import Cell, Run, load_json

SPEC = load_json(os.path.join(ROOT, "BENCHMARK.json"))


class Ev:
    """A profiler event as read_events sees it."""

    def __init__(self, name, dev, start, dur, kind):
        self._n, self._d, self._s, self._u, self._k = name, dev, start, dur, kind

    def name(self):
        return self._n

    def device_type(self):
        return "DeviceType." + self._d

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._u

    def activity_type(self):
        return self._k


def _trace():
    evs = [Ev(trace.WINDOW_MARK, "CPU", 1000, 100, "user_annotation"),
           Ev(trace.WINDOW_MARK, "CUDA", 1000, 100, "gpu_user_annotation"),
           Ev("k1", "CUDA", 1010, 10, "kernel"),
           Ev("k1", "CUDA", 1015, 15, "kernel"),
           Ev("Memcpy DtoH", "CUDA", 1050, 10, "gpu_memcpy"),
           Ev("k2", "CUDA", 995, 10, "kernel"),        # starts before
           Ev("k3", "CUDA", 1095, 15, "kernel"),       # ends after
           Ev("aten::add", "CPU", 1020, 5, "cpu_op")]
    return trace.read_events(evs, host_open=1e-6)


def test_idle_share_is_the_union_of_device_intervals():
    t = _trace()
    # inside [1000, 1100]: [1000,1005] [1010,1030] [1050,1060] [1095,1100]
    assert t.window_s == pytest.approx(100e-9)
    assert t.busy_s == pytest.approx(40e-9)
    assert t.gaps() == [(1005, 1010), (1030, 1050), (1060, 1095)]
    assert t.kernel_s(("k1",)) == pytest.approx(25e-9)
    assert [n for n, _ in t.top_ops()][0] == "k1"
    # host_open (1e-6 s on the host's clock) is the window's 1000 ns
    assert t.labelled_gaps({"lower": [(1.03e-6, 1.05e-6)]}, 2) == [
        ["none", pytest.approx(35e-9)], ["lower", pytest.approx(20e-9)]]


def test_no_window_or_no_device_work_reads_nothing():
    assert trace.read_events([Ev("k", "CUDA", 0, 5, "kernel")], 0.0) is None
    assert trace.read_events(
        [Ev(trace.WINDOW_MARK, "CPU", 0, 5, "user_annotation")], 0.0) is None


def _run(kind, speed=1.5):
    run = Run(kind, speed, 2.0, 0.0)
    run.setup_s = 3.0
    run.t_open, run.t_close, run.t_trace_close = 10.0, 12.0, 12.5
    rng = np.random.default_rng(0)
    ends = np.sort(rng.uniform(10.0, 12.4, 300))
    run.done = [(e - rng.uniform(0.001, 0.2), e,
                 rng.integers(2000, 60000, 4 if kind == "stream" else 1))
                for e in ends]
    run.trace = _trace()
    run.spans = {"lower": [(10.5, 10.52), (12.6, 12.7)]}
    return run


def _read(metric, run):
    cell = Cell(SPEC, SPEC["workloads"][0]["name"])
    return cell.reader(metric)(run)


def test_end_to_end_metrics_take_every_request_of_the_window():
    run = _run("stream")
    inside = [d for d in run.done if d[1] <= 12.0]
    lat = [(b - a) * 1e3 for a, b, _ in inside]
    assert _read("batch_p95_ms", run) == pytest.approx(np.percentile(lat, 95))
    audio = sum(int(l.sum()) for _, _, l in inside) / 22050 / 2.0
    assert _read("audio_s_per_s", run) == pytest.approx(audio)
    assert _read("setup_s", run) == 3.0
    call = _run("call")
    lat = [(b - a) * 1e3 for a, b, _ in call.done if b <= 12.0]
    assert _read("sentence_p95_ms", call) == pytest.approx(
        np.percentile(lat, 95))
    call.done = []
    assert _read("sentence_p95_ms", call) is None
    assert _read("batch_p95_ms", call) is None


def test_the_workloads_key_decides_which_cells_read_a_metric():
    batch, sentence = Cell(SPEC, "batch_1x"), Cell(SPEC, "sentence_1.5x")
    assert {m["name"] for m in batch.end_to_end} == {
        "setup_s", "audio_s_per_s", "batch_p95_ms"}
    assert {m["name"] for m in sentence.end_to_end} == {
        "setup_s", "sentence_p95_ms"}
    assert all(m["name"].endswith(".batch") for m in batch.per_layer)
    assert all(m["name"].endswith(".sentence") for m in sentence.per_layer)
    assert "wsola_roofline.sentence" in {m["name"] for m in sentence.per_layer}


def test_layer_metrics_read_the_traced_window():
    run = _run("stream")
    assert _read("idle_share.batch", run) == pytest.approx(60.0)
    n = sum(1 for d in run.done if d[1] <= 12.5)
    assert _read("device_ms.batch", run) == pytest.approx(40e-6 / n)
    assert _read("lower_ms.batch", run) == pytest.approx(20.0)
    assert _read("drain_ms.batch", run) is None
    run.trace = None
    assert _read("device_ms.batch", run) is None
    assert _read("wsola_roofline.batch", run) is None


def test_wsola_bound_is_below_the_chain_s_work():
    """wsola_work's frames and candidates, from an answer's length, stay
    at or below what the port's plain chain counts on that answer's
    input, and reach most of it."""
    import torch

    from benchmark import voice
    from benchmark.reference import Reference, dsp_np
    from benchmark.reference.compiler import compile_plan
    from benchmark.reference.oracle import execute_plan_oracle
    from ctts_tpu_torch.config import config_defaults
    from ctts_tpu_torch.ops import wsola as tw

    ref = Reference(dataclasses.asdict(config_defaults()), voice.units())
    for text in ("como vai?", "o brasil é um país muito bonito"):
        x = execute_plan_oracle(
            compile_plan(ref.table, text, ref.config, 1.0), ref.table)
        out = dsp_np.time_stretch(x, 1.5)
        inp = torch.tensor(x, dtype=torch.float32)[None]
        S, hop = inp.shape[1], tw.synthesis_hop_for_speed(1.5)
        size = ((S - 512) // 128 + 1) * hop + 512 + 1024
        ic = torch.tensor([S], dtype=torch.int32)
        nrun = tw.run_counts(ic, S, size, hop)
        searched = {}
        tw.wsola_frames_plain(inp, tw.energy_table(inp), ic, nrun, hop, size,
                              searched=searched)
        frames, coarse, fine, n_in, _ = yardstick.wsola_work(len(out), 1.5)
        assert frames <= int(nrun) and coarse <= searched["coarse"]
        assert fine <= searched["fine"] and n_in <= S
        assert yardstick.wsola_ops({"coarse": coarse, "fine": fine}, frames) \
            >= 0.6 * yardstick.wsola_ops(searched, nrun.numpy())
    assert yardstick.wsola_work(50000, 1.0) == (0, 0, 0, 0, 0)
    b = yardstick.wsola_bound([30000, 40000], 1.5)
    assert b["bound_ms"] > 0 and b["frames"] > 0


def test_bound_is_the_larger_term():
    b = yardstick.bound(3.35e9, 0.0)
    assert b["bound_ms"] == pytest.approx(1.0) and b["bound_by"] == "bytes"
    b = yardstick.bound(0, 67e9)
    assert b["bound_ms"] == pytest.approx(1.0) and b["bound_by"] == "operations"
