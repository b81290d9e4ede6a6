"""The per-stage tool (tools/torch_profile_stages.py) on the CPU at a
tiny size, and the serving batch it profiles.

(a) the tool's stage marks cover every stage of a batch and leave the
    computation and the wrapped functions as they were;
(b) the trace's device work is attributed to stages at the spin
    kernels, and a trace that lost a spin kernel names its pause;
(c) chip_smoke.py's copies of bench.py's texts and bucket floor, of
    which the tool's batch is made, equal bench.py's.
"""

import ast
import importlib.util
import os
import time

import pytest
import torch

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


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tool():
    return _load("torch_profile_stages",
                 os.path.join(REPO, "tools", "torch_profile_stages.py"))


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


def test_chip_smoke_copies_equal_bench_py():
    import bench as jax_bench   # stdlib and numpy only at import

    cs = _load("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    with open(os.path.join(REPO, "bench.py"), encoding="utf-8") as f:
        main = next(n for n in ast.walk(ast.parse(f.read()))
                    if isinstance(n, ast.FunctionDef) and n.name == "main")
    floor = next(n.value for n in ast.walk(main)
                 if isinstance(n, ast.Assign)
                 and any(isinstance(t, ast.Name) and t.id == "floor"
                         for t in n.targets))
    assert cs.TEXTS == jax_bench.TEXTS
    assert cs.FLOOR == ast.literal_eval(floor)
