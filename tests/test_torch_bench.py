"""The port's benchmark (ctts_tpu_torch/bench.py, the counterpart of
bench.py) and its per-stage tool (tools/torch_profile_stages.py), on the
CPU at a tiny size.

(a) run() over every section gives a line with every key of bench.py's
    line (read from bench.py as text), parity 0 against the oracle with
    lengths equal, the mesh equal to the unsharded stream, and the keys
    of its own;
(b) the paragraph and mixed sections at a tiny size;
(c) warm() and the timed runs' bookkeeping, and the headline's
    whole-window rate against the per-yield median;
(d) with no card `python -m ctts_tpu_torch.bench` exits nonzero after
    one parseable JSON line;
(e) the bench's copies of bench.py's texts, floor and C-reference
    helpers equal bench.py's;
(f) the tool's stage marks cover every stage of a batch and leave the
    computation and the wrapped functions as they were.
"""

import ast
import importlib.util
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from ctts_tpu_torch import bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
# tests/test_device_executor.py::CASES texts.
TINY = ["como vai", "que legal!"]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """A small intra-op pool (the suite runs in six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _bench_py():
    with open(os.path.join(REPO, "bench.py"), encoding="utf-8") as f:
        return ast.parse(f.read())


def _function(tree, name):
    return next(n for n in ast.walk(tree)
                if isinstance(n, ast.FunctionDef) and n.name == name)


def _assigned(fn, name):
    """The literal assigned to `name` inside function `fn`."""
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == name for t in node.targets):
            return ast.literal_eval(node.value)
    raise KeyError(name)


def bench_py_keys():
    """The keys of the JSON line bench.py's main() prints on success."""
    main = _function(_bench_py(), "main")
    dicts = [n for n in ast.walk(main) if isinstance(n, ast.Dict)
             and any(isinstance(k, ast.Constant) and k.value == "metric"
                     for k in n.keys)]
    return [k.value for k in max(dicts, key=lambda d: len(d.keys)).keys]


def test_bench_line_has_bench_py_keys(voice_db, tmp_path):
    keys = bench_py_keys()
    assert len(keys) >= 25 and "mesh_matches_unsharded" in keys
    line = bench.run(CPU, voice_db, str(tmp_path), texts=TINY, batch_mult=1,
                     iters=2, K=1, paragraph=None, mixed=0, floor=None,
                     compute_reps=1, latency_reps=1)
    json.dumps(line)
    assert set(keys) <= set(line), sorted(set(keys) - set(line))
    assert line["backend"] == "cpu" and line["n_chips"] == 1
    assert line["batch_sentences"] == len(TINY)
    assert line["value"] > 0 and line["device_compute_x_realtime_per_chip"] > 0
    assert line["stretch_x_realtime_per_chip"] > 0
    assert line["parity_max_abs_vs_oracle"] == 0.0
    assert line["parity_frac_samples_over_1e3"] == 0.0
    assert line["parity_length_match"] is True
    assert line["stretch_parity_max_abs_vs_oracle"] == 0.0
    assert line["stretch_parity_length_match"] is True
    assert line["mesh_matches_unsharded"] is True and line["mesh_error"] == ""
    assert line["silence_rows_rerun"] == 0
    assert line["d2h_transfer_mbps"] > 0
    # The C reference is absent here: 0.0 and said so, nothing in its place.
    assert line["vs_baseline"] == 0.0 == line["c_reference_x_realtime"]
    assert "C reference" in line["error"]
    assert line["wire"] is False                      # the CPU's default
    assert line["headline_window_x_realtime_per_chip"] > 0
    assert line["peak_device_memory_bytes"] is None
    assert line["latency_ms_single_sentence"] > 0
    # On the CPU the compiled core runs eagerly and counts nothing.
    assert (line["timed_eager_runs"], line["timed_capture_runs"],
            line["timed_replay_runs"]) == (0, 0, 0)
    assert {"headline", "compute", "mesh", "stretch",
            "latency_single_sentence"} <= set(line["timed_compiled_runs"])


def test_paragraph_and_mixed_sections(voice_db):
    from ctts_tpu_torch.config import config_defaults
    from ctts_tpu_torch.db.reader import VoiceDatabase
    from ctts_tpu_torch.parallel.batch import BatchSynthesizer

    bs = BatchSynthesizer(VoiceDatabase(voice_db), config_defaults(),
                          device=CPU)
    runs = bench.TimedRuns()
    para = bench.paragraph_section(bs, runs, "bom dia. tudo bem.", copies=1,
                                   iters=2)
    assert para["paragraph_parity_ok"] is True
    assert para["paragraph_x_realtime_per_chip"] > 0
    mix = bench.mixed_section(bs, 2, runs, n=3)
    assert mix["sentences"] == 3 and mix["chunk"] == 2
    assert mix["mixed1024_aggregate_x_realtime"] > 0
    assert set(runs.by_section) == {"paragraph", "mixed1024"}


def test_headline_window_rate_sees_a_stall():
    """The per-yield median (bench.py's statistic) does not move when one
    yield of the window stalls; the whole-window rate does."""
    steady = [(1.0, 0.5)] * 5
    stalled = steady + [(1.0, 10.0)]
    assert bench.median_rate(steady) == bench.median_rate(stalled) == 2.0
    assert bench.window_rate(steady) == pytest.approx(2.0)
    assert bench.window_rate(stalled) == pytest.approx(6.0 / 12.5)


def test_warm_and_timed_runs(monkeypatch):
    from collections import Counter

    from ctts_tpu_torch.synth import compiled

    monkeypatch.setattr(compiled, "runs", Counter())
    sightings = []

    def batch():
        """A signature's first sighting runs eagerly, its second
        captures, later ones replay."""
        kind = ("eager", "capture", "replay")[min(len(sightings), 2)]
        sightings.append(kind)
        compiled.runs[kind] += 1

    bench.warm(batch)
    assert sightings == ["eager", "capture", "replay"]
    runs = bench.TimedRuns()
    with runs.timed("a"):
        batch()
    with runs.timed("a"):
        compiled.runs["capture"] += 1
    with runs.timed("b"):
        pass
    assert runs.by_section == {"a": {"eager": 0, "capture": 1, "replay": 1},
                               "b": {"eager": 0, "capture": 0, "replay": 0}}
    assert runs.totals() == {"timed_eager_runs": 0, "timed_capture_runs": 1,
                             "timed_replay_runs": 1}
    calls = []
    bench.warm(lambda: calls.append(0))              # nothing counted: once
    assert calls == [0]


def test_bench_without_a_card_exits_nonzero():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-m", "ctts_tpu_torch.bench"],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    lines = r.stdout.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["value"] == 0.0 and line["vs_baseline"] == 0.0
    assert line["backend"] == "none" and "CUDA" in line["error"]
    assert line["metric"] == bench.METRIC


def _body(fn):
    """The function's statements without its docstring, as an AST dump."""
    body = fn.body[1:] if isinstance(fn.body[0], ast.Expr) and isinstance(
        fn.body[0].value, ast.Constant) else fn.body
    return [ast.dump(s) for s in body]


def test_bench_copies_equal_bench_py():
    import bench as jax_bench   # stdlib and numpy only at import

    tree = _bench_py()
    main = _function(tree, "main")
    assert bench.TEXTS == jax_bench.TEXTS
    assert bench.SAMPLE_RATE == jax_bench.SAMPLE_RATE
    assert bench.FLOOR == _assigned(main, "floor")
    assert bench.PARAGRAPH == _assigned(main, "paragraph")
    assert bench.LONG_TEXTS == _assigned(main, "long_texts")
    with open(bench.__file__, encoding="utf-8") as f:
        port = ast.parse(f.read())
    # compile_c_reference: bench.py's, but for where the reference lies.
    got = _body(_function(port, "compile_c_reference"))
    want = _body(_function(tree, "compile_c_reference"))
    first = _function(tree, "compile_c_reference").body[1]
    assert isinstance(first, ast.Assign) and first.targets[0].id == "ref"
    assert first.value.value.endswith("/reference/ctts.c")
    assert got[0] == ast.dump(ast.parse("ref = REFERENCE_C").body[0])
    assert got[1:] == want[1:]
    assert _body(_function(port, "c_reference_pass")) == \
        _body(_function(tree, "c_reference_pass"))
    # Looked for inside the checkout only.
    assert bench.REFERENCE_C == os.path.join(REPO, "reference", "ctts.c")


def _tool():
    spec = importlib.util.spec_from_file_location(
        "torch_profile_stages",
        os.path.join(REPO, "tools", "torch_profile_stages.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_stage_marks_cover_the_batch(voice_db):
    from ctts_tpu_torch.config import config_defaults
    from ctts_tpu_torch.db.reader import VoiceDatabase
    from ctts_tpu_torch.ops import wire
    from ctts_tpu_torch.parallel.batch import BatchSynthesizer
    from ctts_tpu_torch.synth import compiled, device

    tool = _tool()
    bs = BatchSynthesizer(VoiceDatabase(voice_db), config_defaults(),
                          device=CPU)
    core = bs.shards[0].core
    (_, per_bucket), _ = bs._lower_batch(TINY, 1.5, True)
    dims, _, (_, stacked, shared) = per_bucket[0]
    _, layout, merged = compiled.signature(core, dims, stacked, shared, True)
    ar = layout.upload(merged, CPU)
    trips = device.refine_depth(merged)
    want = compiled.batch_core(core, dims, ar, trips, True)
    originals = (device.compact, device.time_stretch, device.unit_base,
                 compiled.pack_encode, compiled.pack_rows, wire.encode,
                 torch.cumsum)
    def batch():
        return compiled.batch_core(core, dims, ar, trips, True)

    got, marks, _ = tool.marked_batch(core, batch, time.perf_counter)
    # The wire words past the valid prefix are not written.
    words, classes, lens, ovf = got
    assert torch.equal(classes, want[1]) and torch.equal(lens, want[2])
    assert torch.equal(ovf, want[3])
    valid = wire.wire_valid_words(classes.numpy(), int(lens.sum()))
    assert valid > 0 and torch.equal(words[:valid], want[0][:valid])
    assert (device.compact, device.time_stretch, device.unit_base,
            compiled.pack_encode, compiled.pack_rows, wire.encode,
            torch.cumsum) == originals
    assert not set(tool.METHODS) & set(vars(core))
    totals = marks.totals(lambda a, b: (b - a) * 1e3)
    # On the CPU pack_encode's plain version calls wire.encode (marked
    # inside it) and its own pack_rows (not compiled.pack_rows, which a
    # checkout from before the kernel calls: unmarked here).
    assert set(totals) == {
        "other", "prologue: bank pick and curves", "prologue: unit_base",
        "prologue: head pitch (K2)", tool.TRIP, "refine trip: compose (K1)",
        "refine trip: boundary_heads (K2)",
        "refine trip: contributions (unit_contrib)", tool.EPILOGUE,
        "epilogue: contributions (unit_contrib)",
        "final compose (K1)", "tail fades", tool.SEGTABLES, tool.SCANS,
        "compaction (K3)", "contour and fall zones", "region_post",
        "assembly (K4)", "WSOLA (K5, tables, finish)", tool.PACK_ENCODE,
        "wire encode"}
    span = (marks.marks[-1][0] - marks.marks[0][0]) * 1e3
    assert sum(totals.values()) == pytest.approx(span)
    labels = [label for _, label in marks.marks]
    assert labels.count("refine trip: compose (K1)") == trips >= 1
    # With a pause before each stage, the pauses count in no stage.
    pauses = []
    _, paused, end = tool.marked_batch(core, batch, time.perf_counter,
                                       lambda: pauses.append(0))
    opened = sum(1 for _, label in paused.marks if label == tool.PAUSE)
    assert len(pauses) == len(paused.pauses) == opened > 10
    got = paused.totals(lambda a, b: (b - a) * 1e3)
    assert set(got) == set(totals) and tool.PAUSE not in got
    assert paused.short_pauses(lambda a, b: 1e9, end) == []
    short = paused.short_pauses(lambda a, b: 0.0, end)
    assert len(short) == opened and short[0][0] == "other"
    # Every entry and exit pauses; what follows a pause is one interval.
    after = paused.paused_labels()
    assert len(after) == len(paused.marks) // 2 and after[0] == "other"
    assert all(a == tool.PAUSE for _, a in paused.marks[::2])


def test_stage_attribution_splits_at_spins():
    tool = _tool()

    def ev(name, ts, dur):
        return {"name": name, "ts": ts, "dur": dur}

    spin = tool.SPIN_KERNEL
    events = [ev("k3", 50, 4000), ev(spin, 0, 20), ev("k1", 21, 1000),
              ev("k2", 30, 2000), ev("void at::spin_kernel(long)", 40, 9),
              ev(spin, 60, 1), ev("k4", 70, 500)]
    got = tool.attribute(events, ["a", "b", "a"])
    assert got == {"a": {"ms": 3.5, "ops": 3}, "b": {"ms": 4.0, "ops": 1}}
    with pytest.raises(RuntimeError, match="spin kernels"):
        tool.attribute(events, ["a", "b"])
    with pytest.raises(RuntimeError, match="before the first pause"):
        tool.attribute([ev("k0", -5, 1)] + events, ["a", "b", "a"])


def test_spin_loss_names_the_pause_without_a_spin():
    tool = _tool()

    def ev(name, ts, dur, corr, cat="kernel"):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "args": {"correlation": corr}}

    spin = tool.SPIN_KERNEL
    # Three pauses of 20, 30 and 40 ms; the trace lost the second spin,
    # whose host-side launch (correlation 3) is still there.
    events = [ev(spin, 0, 20000, 1), ev("k1", 20001, 5, 2),
              ev(spin, 60000, 40000, 4), ev("k2", 100001, 5, 5)]
    events += [ev("cudaLaunchKernel", 0, 1, c, "cuda_runtime")
               for c in (1, 2, 3, 4, 5)]
    with pytest.raises(tool.SpinLost):
        tool.attribute(events, ["a", "b", "c"])
    got = tool.spin_loss(events, [20.5, 30.2, 40.1], ["a", "b", "c"])
    assert got["missing"] == [{"pause": 1, "of": 3, "label_after": "b",
                               "spin_ms": 30.2}]
    assert got["spins_traced"] == 2 and got["unaligned_spins"] == 0
    assert got["launches_without_kernel"] == 1
