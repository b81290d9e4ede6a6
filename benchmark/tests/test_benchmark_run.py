"""Whole runs of the harness on the CPU at a tiny size: both loops,
both configurations, traced and not; a configuration, a traffic mix and
a metric added as files only; the control and planted faults, which
`correct` has to catch."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from conftest import ROOT

from benchmark import check
from benchmark.control import control_numbers
from benchmark.harness import Cell, run_cell

CPU = torch.device("cpu")
CELLS = ["batch_ctts_ptbr_1x", "call_ctts_ptbr_1x", "batch_ctts_ptbr_1.5x",
         "call_ctts_ptbr_1.5x"]


def _run(tiny, cell, trace=False, seconds=2.0):
    root, bench, spec = tiny
    return run_cell(root, spec, cell, 2**31 + 99, seconds, trace,
                    time.perf_counter(), device=CPU, bench_dir=bench)


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_run(tiny, cell):
    r = _run(tiny, cell)
    assert list(r)[-2:] == ["check", "info"]
    assert r["correct"], r["check"]
    assert r["attempted"] > 0 and r["failed"] == 0
    want = {"setup_s", "audio_s_per_s" if cell.startswith("batch")
            else "sentence_p95_ms"}
    assert set(r["metrics"]) == want | ({"batch_p95_ms"}
                                        if cell.startswith("batch") else set())
    assert r["check"]["compared"]["value"] > 0
    assert r["info"]["runs_in_window"] == {"eager": 0, "capture": 0}
    assert r["device"]["platform"] == "cpu"


@pytest.mark.parametrize("cell", CELLS[:2])
def test_tiny_traced_run(tiny, cell):
    """On the CPU the host spans are read; the device metrics, which need
    the card's trace, are left out rather than read as 0."""
    r = _run(tiny, cell, trace=True)
    assert r["correct"]
    names = set(r["metrics"])
    assert names == ({"lower_ms.batch", "drain_ms.batch"}
                     if cell.startswith("batch") else {"compile_ms.sentence"})
    assert "busy_s" not in r["device"]


def test_a_cell_added_by_files_only(tiny):
    """A new configuration, traffic mix and per-layer metric: files under
    the benchmark's directory and entries in the spec, no code."""
    root, bench, spec = tiny
    with open(os.path.join(bench, "configs", "ctts_ptbr_1x.json")) as f:
        cfg = json.load(f)
    cfg.update(name="ctts_ptbr_longfade", speed=1.0)
    cfg["config"]["crossfade_ms"] = 60.0
    with open(os.path.join(bench, "configs", "ctts_ptbr_longfade.json"),
              "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(bench, "traffic", "tiny_call2.json"), "w") as f:
        json.dump({"loop": "call", "texts": "tiny.json",
                   "check_texts": 2, "check_answers": 4}, f)
    with open(os.path.join(bench, "metrics", "calls_per_s.sentence.py"),
              "w") as f:
        f.write("def read(run):\n"
                "    return len(run.in_window()) / run.seconds\n")
    spec["workloads"].append({"name": "longfade", "config":
                              "ctts_ptbr_longfade", "traffic": "tiny_call2",
                              "chips": 1, "why": "added"})
    spec["end_to_end"].append({"name": "calls_per_s.sentence", "unit": "1/s",
                               "better": "higher", "bound": 0.05,
                               "source": "host_clock",
                               "workloads": ["longfade"]})
    r = _run((root, bench, spec), "longfade")
    assert r["correct"], r["check"]
    assert r["metrics"]["calls_per_s.sentence"]["value"] > 0
    assert "calls_per_s.sentence" not in _run(
        (root, bench, spec), "call_ctts_ptbr_1x")["metrics"]


@pytest.mark.parametrize("cell,seeds", [("sentence_1x", (1, 2, 3)),
                                        ("batch_1.5x", (4,))])
def test_control_fails_the_check(cell, seeds):
    """The control at the cell's own check size (its 48 texts): the
    reference in the program's place, its samples once in bfloat16,
    fails the cell's limit on every seed."""
    c = Cell(json.load(open(os.path.join(ROOT, "BENCHMARK.json"))), cell)
    for seed in seeds:
        got = control_numbers(c, seed)
        assert not got["correct"]
        assert got["check"]["max_lsb"]["value"] \
            > c.config["check"]["max_lsb"]


def test_bfloat16_rounds_to_8_significant_bits():
    x = np.array([0, 1, -1, 255, 257, 8223, -20001, 32767], np.int16)
    assert check.max_lsb(check.bfloat16(x), x) == 33    # -20001 -> -19968
    assert check.max_lsb(x, x) == 0


def _alter(outs):
    outs = list(outs)
    o = outs[0].copy()
    o[len(o) // 2] += 1000
    outs[0] = o
    return outs


FAULTS = {
    # one answer altered where it is produced
    "answer_altered": lambda outs: _alter(outs),
    # half of the batch left out
    "half_left_out": lambda outs: outs[:len(outs) // 2],
    # the step returns its state unchanged: the output rows as allocated
    "state_unchanged": lambda outs: [np.zeros_like(o) for o in outs],
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_makes_the_run_incorrect(tiny, monkeypatch, fault):
    """The timed path broken underneath the harness (its look for a
    card skipped): `correct` comes out false. One chip, so no exchange
    between chips to leave out."""
    from ctts_tpu_torch.parallel.batch import BatchSynthesizer

    finish = BatchSynthesizer._finish
    monkeypatch.setattr(BatchSynthesizer, "_finish",
                        lambda self, t, s: FAULTS[fault](finish(self, t, s)))
    r = _run(tiny, "batch_ctts_ptbr_1x")
    assert not r["correct"]


def test_planted_fault_on_the_sentence_path(tiny, monkeypatch):
    from ctts_tpu_torch.synth import device

    execute = device.execute_plan_torch
    monkeypatch.setattr(device, "execute_plan_torch",
                        lambda *a: _alter([execute(*a)])[0])
    assert not _run(tiny, "call_ctts_ptbr_1.5x")["correct"]


@pytest.mark.cuda
def test_a_cell_on_the_card():
    """One short run of each loop on the card, started from the root:
    correct, with its metrics and the card's name."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for cell in ("sentence_1x", "batch_1x"):
        r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                            cell, "--seed", "3", "--seconds", "2",
                            "--trace", "0"], cwd=ROOT, capture_output=True,
                           text=True, timeout=900)
        assert r.returncode == 0, r.stderr[-2000:]
        out = json.loads(r.stdout.strip().splitlines()[-1])
        assert out["correct"] and out["device"]["platform"] == "gpu"
        assert "setup_s" in out["metrics"]
