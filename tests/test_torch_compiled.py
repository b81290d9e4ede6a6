"""The compiled batch core of ctts_tpu_torch (synth/compiled.py) and the
shape-static core it captures (synth/device.py), on the CPU.

(a) each stage of SynthesisCore (prologue, refine trip, epilogue) on two
    batches of one signature with different texts (tests/
    test_device_executor.py's texts at its serving floor) makes the same
    ops on the same shapes and dtypes, and none of them reads a value
    back to the host: the CPU proof that CUDA graphs can capture them;
(b) the zones of contour_zones give what the per-row contour_segment
    gives on the rows a host picks (the rise, then the fall);
(c) the staging buffer round-trips every array bit for bit;
(d) signatures (the refine depth is a replay count, not part of one),
    capture at a signature's second sighting, the 64-entry LRU,
    release_compiled and the launch counts a capture records;
(e) the served path (stream, synthesize, CTTSEngine.synthesize_batch)
    runs the compiled core, and on the CPU equals the oracle;
(f) on a card: graph-served outputs equal the eager core's bit for bit
    over batches of different texts (skipped without one);
(g) the one-sentence path (execute_plan_torch) runs the compiled core
    as a batch of one row on its voice's one core: two calls share the
    core and the signature, and on the CPU the output equals run_eager's
    and is held to the oracle, at 1.0 and 0.5; on a card its replays
    equal its eager runs (skipped without one);
(h) BatchSynthesizer.execute(plans) equals synthesize(texts, split=False),
    and CTTSEngine.close drops the graphs of both its paths;
(i) BatchSynthesizer.stream at its default floor over two short texts
    (0 LSB from the oracle), a paragraph (at 1.0 split at its
    sentence boundaries, within 32 LSB of the oracle's one buffer; at
    1.5 one row, within 2 LSB) and batches of two sizes through one
    stream (within 2 LSB), at 1.0 and 1.5, every length equal to the
    oracle's and no row run again.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ctts_tpu.config import config_defaults
from ctts_tpu.db.reader import VoiceDatabase
from ctts_tpu.plan.compiler import compile_plan
from ctts_tpu.synth.oracle import execute_plan_oracle

CPU = torch.device("cpu")
# tests/test_device_executor.py:277-281 (the serving floor its corpus
# test holds to one bucket) and its stream batches (:313-315).
FLOOR = {"U": 32, "R": 16, "FD": 8, "WREG": 32768, "SMAX": 131072,
         "CONTW": 32768, "WIN": 2048, "CFMAX": 1024}
PAIR = (["como vai", "bom dia. tudo bem."],
        ["que legal!", "como se chama?"])
BATCHES = [["como vai", "bom dia. tudo bem."],
           ["que legal", "a rosa"],
           ["vamos", "oi"]]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """A small intra-op pool (the suite runs in six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def db(voice_db):
    return VoiceDatabase(voice_db)


@pytest.fixture(scope="module")
def served(db):
    from ctts_tpu_torch.parallel.batch import BatchSynthesizer

    return BatchSynthesizer(db, config_defaults(), device=CPU,
                            dims_floor=FLOOR)


def _one_bucket(bs, texts, speed=1.0):
    """(dims, stacked arrays, shared tables) of a batch in one bucket."""
    (_, per_bucket), _ = bs._lower_batch(texts, speed, True)
    assert len(per_bucket) == 1
    dims, _, (_, stacked, shared) = per_bucket[0]
    return dims, stacked, shared


def _max_diff(a, b):
    assert a.shape == b.shape
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max(initial=0))


class _Record(TorchDispatchMode):
    """(op, argument shapes/dtypes or values) of every op dispatched."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}

        def desc(x):
            if isinstance(x, torch.Tensor):
                return ("T", tuple(x.shape), x.dtype, x.device.type)
            if isinstance(x, (list, tuple)):
                return tuple(desc(v) for v in x)
            return repr(x)

        self.ops.append((str(func), desc(args),
                         tuple(sorted((k, desc(v))
                                      for k, v in kwargs.items()))))
        return func(*args, **kwargs)


HOST_READS = ("aten._local_scalar_dense", "aten.item", "aten.nonzero",
              "aten.masked_select", "aten.unique")


def test_forward_launches_depend_only_on_the_signature(db, served):
    """Each stage of the core (prologue, one refine trip, epilogue) makes
    the same ops on the same shapes for two batches of one signature, and
    forward is the prologue, `trips` trips and the epilogue."""
    from ctts_tpu_torch.synth import compiled
    from ctts_tpu_torch.synth.device import refine_depth, stage_inputs

    core = served.shards[0].core
    records = []
    for texts in PAIR[:1] + PAIR:
        dims, stacked, shared = _one_bucket(served, texts)
        sig, _, merged = compiled.signature(core, dims, stacked, shared,
                                            False)
        ar = stage_inputs(merged, CPU)
        stages = []
        with _Record() as rec:
            st = core.prologue(dims, ar)
        stages.append(rec.ops)
        with _Record() as rec:
            core.refine_trip(dims, st)
        stages.append(rec.ops)
        for _ in range(refine_depth(merged) - 1):
            core.refine_trip(dims, st)
        with _Record() as rec:
            out = core.epilogue(dims, st)
        stages.append(rec.ops)
        records.append((sig, stages, ar, out, refine_depth(merged)))
    # The first call uploads the LUT and Hann tables (lru_cache, once
    # per device): what a signature's first, eager batch absorbs.
    assert any("lift_fresh" in op for stage in records.pop(0)[1]
               for op, _, _ in stage)
    (sig_a, ops_a, ar, out, trips), (sig_b, ops_b, _, _, _) = records
    assert sig_a == sig_b and trips >= 1
    assert min(len(ops) for ops in ops_a) > 100
    assert ops_a == ops_b
    for op, args, kwargs in (x for ops in ops_a for x in ops):
        assert not op.startswith(HOST_READS), op
        # A copy to another device (.cpu(), .to(device)) names it.
        assert not (op.startswith(("aten._to_copy", "aten.to."))
                    and "device" in dict(kwargs)), (op, kwargs)
    for got, want in zip(core(sig_a.dims, ar, trips), out):
        assert torch.equal(got, want)


def _sequential_contour(rows, M, W, cnt, do_dsp, qfinal, active, c):
    """The per-row contour of the eager core before zones: the rise on
    the DSP rows a host picks, then the fall on the question-final ones,
    each merged before the next pass reads."""
    from ctts_tpu_torch.ops import device_ops as dops

    n = rows.shape[0]
    max_frames = max((W - 256) // 128 + 2, 1)
    rows = rows.clone()
    sel = np.flatnonzero(do_dsp)
    if sel.size:
        idx = torch.as_tensor(sel)
        k = cnt[idx]
        rise = (k.to(torch.float32) * 0.6).to(torch.int64)
        split = qfinal[idx] & (rise > 100) & (k - rise > 100)
        rows[idx, M:M + W] = dops.contour_segment(
            rows[idx, M:M + W], torch.zeros_like(k),
            torch.where(split, rise, k), c[idx, 0],
            torch.where(split, c[idx, 2], c[idx, 1]), max_frames)
    sel = np.flatnonzero(qfinal.numpy() & do_dsp & active.numpy())
    if sel.size:
        idx = torch.as_tensor(sel)
        k = cnt[idx]
        rise = (k.to(torch.float32) * 0.6).to(torch.int64)
        split = (rise > 100) & (k - rise > 100)
        rows[idx, M:M + W] = dops.contour_segment(
            rows[idx, M:M + W], rise, torch.where(split, k - rise, 0),
            c[idx, 2], c[idx, 1], max_frames)
    assert rows.shape[0] == n
    return rows


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_contour_zones_equal_per_row_contour(seed):
    """Random region rows, lengths that fill each sentence's budget,
    every mix of DSP / question-final / active rows, equal and near-equal
    pitch factors, and a count of 256 (the reference's 1/0 frame,
    NaN on both sides)."""
    from ctts_tpu_torch.ops import device_ops as dops
    from ctts_tpu_torch.synth.device import SynthesisCore

    rng = np.random.default_rng(seed)
    B, R, M, W, WREG, SMAX = 3, 6, 512, 3072, 4096, 8192
    rows = rng.integers(-20000, 20000, (B, R, WREG)).astype(np.float32)
    cnt = np.zeros((B, R), np.int64)
    for b in range(B):
        cuts = np.sort(rng.integers(0, min(SMAX, R * W), R - 1))
        cnt[b] = np.minimum(np.diff(np.r_[0, cuts, SMAX]), W)
    cnt[0, :4] = [0, 99, 256, 427]          # 427: rise 256
    do_dsp = rng.random((B, R)) < 0.7
    qfinal = rng.random((B, R)) < 0.5
    active = rng.random((B, R)) < 0.8
    c = rng.uniform(0.9, 1.1, (B, R, 5)).astype(np.float32)
    c[1, 0, 1] = c[1, 0, 0]                  # a rise with no pitch change
    c[1, 1, 2] = c[1, 1, 1] + np.float32(0.005)
    ar = {"region_contour": torch.as_tensor(c),
          "region_qfinal": torch.as_tensor(qfinal),
          "region_do_dsp": torch.as_tensor(do_dsp),
          "region_active": torch.as_tensor(active)}

    class Dims:
        pass

    dims = Dims()
    dims.R, dims.MARGIN, dims.SMAX = R, M, SMAX
    got = SynthesisCore._contour(None, dims, ar,
                                 torch.as_tensor(rows.copy()),
                                 torch.as_tensor(cnt))
    want = _sequential_contour(
        torch.as_tensor(rows.reshape(B * R, WREG)), M, W,
        torch.as_tensor(cnt.reshape(-1)), do_dsp.reshape(-1),
        torch.as_tensor(qfinal.reshape(-1)),
        torch.as_tensor(active.reshape(-1)),
        torch.as_tensor(c.reshape(-1, 5)))
    assert np.array_equal(got.reshape(B * R, WREG).numpy(), want.numpy(),
                          equal_nan=True)
    assert not np.array_equal(got.numpy(), rows)      # something ran
    assert dops.zone_slots(SMAX, 2 * R) * 128 >= SMAX


def test_staging_round_trips_every_array(db, served):
    from ctts_tpu_torch.synth.device import Staging, stage_inputs

    dims, stacked, shared = _one_bucket(served, PAIR[1], 1.5)
    arrays = dict(stacked, **shared)
    # Values whose bits a lossy path would change.
    arrays["speed"] = arrays["speed"].copy()
    arrays["speed"][:3] = [np.float32(-0.0), np.float32(np.nan),
                           np.float32(1e-45)]
    layout = Staging(arrays)
    assert layout.nbytes % Staging.ALIGN == 0
    assert len(layout.fields) == len(arrays) > 20
    views = stage_inputs(arrays, CPU)
    for name, a in arrays.items():
        a = np.asarray(a)
        v = views[name].numpy()
        assert v.dtype == a.dtype and v.shape == a.shape, name
        assert v.tobytes() == a.tobytes(), name
    assert {dt for _, dt, _, _ in layout.fields} >= {
        np.dtype(np.int32), np.dtype(np.float32), np.dtype(bool)}
    with pytest.raises(ValueError, match="staging"):
        layout.pack(dict(arrays, speed=arrays["speed"][:2]),
                    np.zeros(layout.nbytes, np.uint8))


def test_signatures_lru_and_release(db, served, monkeypatch):
    from ctts_tpu_torch.parallel.batch import release_compiled as released
    from ctts_tpu_torch.synth import compiled

    core = served.shards[0].core
    dims, stacked, shared = _one_bucket(served, PAIR[0])
    sig, _, _ = compiled.signature(core, dims, stacked, shared, False)
    assert released is compiled.release_compiled
    assert sig.device == "cpu" and sig.dims == dims
    assert compiled.signature(core, dims, stacked, shared, True)[0] != sig
    # The refine depth is a replay count, not part of the signature.
    deeper = dict(stacked, refine_trips=stacked["refine_trips"] + 1)
    assert compiled.signature(core, dims, deeper, shared, False)[0] == sig
    wider = dict(shared, cf_values=np.zeros(16, np.int32))
    assert compiled.signature(core, dims, stacked, wider, False)[0] != sig
    half = {k: v[:4] for k, v in stacked.items()}
    assert compiled.signature(core, dims, half, shared, False)[0] != sig
    other = type(core)(served.voice)
    assert compiled.signature(other, dims, stacked, shared, False)[0] != sig

    compiled.release_compiled()
    runs = dict(compiled.runs)
    made = []
    # First sighting: nothing is made (the batch runs eagerly); second:
    # made; later: the cached entry.
    assert compiled.cached(sig, lambda: made.append(0) or "graph") is None
    assert compiled.cached(sig, lambda: made.append(1) or "graph") == "graph"
    assert compiled.cached(sig, lambda: made.append(2) or "again") == "graph"
    assert made == [1]
    assert [compiled.runs[k] - runs.get(k, 0)
            for k in ("eager", "capture", "replay")] == [1, 1, 1]
    compiled.release_compiled()
    assert compiled.cached(sig, lambda: "x") is None    # seen again
    compiled.release_compiled()
    made = []
    for i in range(compiled.MAX_GRAPHS + 6):
        key = sig._replace(layout=(i,))
        compiled.cached(key, lambda: None)
        compiled.cached(key, lambda i=i: made.append(i) or f"graph {i}")
    assert len(made) == compiled.MAX_GRAPHS + 6
    assert compiled.cached(sig._replace(layout=(10,)), lambda: "again") \
        == "graph 10"
    keys = compiled.signatures()
    assert len(keys) == compiled.MAX_GRAPHS
    assert [k.layout for k in keys[:3]] == [(6,), (7,), (8,)]  # 0-5 gone
    assert keys[-1].layout == (10,)                     # most recent
    for i in range(compiled.MAX_SEEN + 1):              # seen once only
        compiled.cached(sig._replace(layout=("once", i)), lambda: "no")
    assert compiled.cached(sig._replace(layout=("once", 0)),
                           lambda: "no") is None        # dropped, unseen
    compiled.release_compiled(other)                    # none of its own
    assert len(compiled.signatures()) == compiled.MAX_GRAPHS
    compiled.release_compiled(core)
    assert compiled.signatures() == []
    compiled.cached(sig, lambda: "x")
    compiled.cached(sig, lambda: "x")
    compiled.release_compiled()
    assert compiled.signatures() == [] and compiled.captured(sig) is None


def test_recorded_launches_count_per_replay():
    from ctts_tpu_torch.ops import hopper

    hopper.reset_launches()
    hopper.compose.launches = 5
    with hopper.recorded_launches() as rec:
        hopper.compose.launches += 2       # what a capture counts
        hopper.pitch.launches += 2
    assert hopper.launch_counts()["compose"] == 5
    assert rec["compose"] == 2 and rec["pitch_corr"] == 2
    assert rec["assemble"] == 0
    for _ in range(3):
        hopper.add_launches(rec)           # three replays
    assert hopper.launch_counts()["compose"] == 11
    assert hopper.launch_counts()["pitch_corr"] == 6
    hopper.reset_launches()


def test_served_path_runs_the_compiled_core(db, served, monkeypatch):
    from ctts_tpu_torch.models.engine import CTTSEngine
    from ctts_tpu_torch.parallel.batch import BatchSynthesizer
    from ctts_tpu_torch.synth import compiled

    calls = []
    run = compiled.run_batch

    def counted(*args, **kwargs):
        calls.append(args[1])
        return run(*args, **kwargs)

    assert BatchSynthesizer._run_core is compiled.run_batch
    monkeypatch.setattr(BatchSynthesizer, "_run_core",
                        staticmethod(counted))
    got = list(served.stream(iter(BATCHES)))
    assert len(calls) == len(BATCHES)
    for texts, outs in zip(BATCHES, got):
        for t, o in zip(texts, outs):
            ref = execute_plan_oracle(
                compile_plan(db, t, config_defaults(), None, 1.0), db)
            assert o.dtype == np.int16 and _max_diff(o, ref) <= 2, t
    eng = CTTSEngine(db.path, device=CPU)
    try:
        outs = eng.synthesize_batch(BATCHES[1], 1.5)
    finally:
        eng.close()
    assert len(calls) == len(BATCHES) + 1 and len(outs) == 2


@pytest.mark.cuda
def test_graph_equals_eager_on_the_card(db):
    """Batches of different texts through the graphs (captured at a
    signature's second batch, then replayed) and through the eager core,
    in turns, with the wire codec on and off: equal bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ctts_tpu_torch.parallel.batch import BatchSynthesizer
    from ctts_tpu_torch.synth import compiled

    dev = torch.device("cuda")
    # Twice over: a signature's first batch runs eagerly, its second is
    # captured, later ones replay.
    batches = [PAIR[0] * 4, PAIR[1] * 4, BATCHES[1] * 4] * 2
    before = dict(compiled.runs)
    for wire in (True, False):
        graph = BatchSynthesizer(db, config_defaults(), device=dev,
                                 dims_floor=FLOOR, wire=wire)
        eager = BatchSynthesizer(db, config_defaults(), device=dev,
                                 dims_floor=FLOOR, wire=wire)
        eager._run_core = compiled.run_eager
        for speed in (1.0, 1.5):
            got = list(graph.stream(iter(batches), speed=speed))
            want = list(eager.stream(iter(batches), speed=speed))
            for g, w in zip(got, want):
                for a, b in zip(g, w):
                    assert a.dtype == b.dtype and np.array_equal(a, b)
    assert compiled.runs["capture"] > before.get("capture", 0)
    assert compiled.runs["replay"] > before.get("replay", 0)
    compiled.release_compiled()


# tests/test_device_executor.py::CASES at 1.0 and 0.5.
SENTENCES = [("como se chama?", 1.0), ("a rosa azul", 0.5)]


@pytest.mark.parametrize("text,speed", SENTENCES)
def test_one_sentence_path_runs_the_compiled_core(db, monkeypatch, text,
                                                  speed):
    from ctts_tpu_torch.synth import compiled
    from ctts_tpu_torch.synth.device import DeviceVoice, execute_plan_torch

    calls = []
    run = compiled.run_batch

    def recorded(core, dims, arrays, shared, wire):
        calls.append((core, compiled.signature(core, dims, arrays, shared,
                                               wire)[0],
                      compiled.run_eager(core, dims, arrays, shared, wire)))
        return run(core, dims, arrays, shared, wire)

    monkeypatch.setattr(compiled, "run_batch", recorded)
    voice = DeviceVoice(db, device=CPU)
    plan = compile_plan(db, text, config_defaults(), None, speed)
    outs = [execute_plan_torch(plan, db, voice) for _ in range(2)]
    (core_a, sig_a, eager), (core_b, sig_b, _) = calls
    assert core_a is core_b is voice.core()
    assert sig_a == sig_b and sig_a.core == core_a._graph_token
    assert sig_a.wire is False and sig_a.dims.stretch == (speed != 1.0)
    assert dict((n, s) for n, _, s in sig_a.layout)["speed"] == (1,)
    packed, classes, lens, _ = eager
    assert classes is None
    want = packed[:int(lens[0])].numpy()
    ref = execute_plan_oracle(plan, db)
    for got in outs:
        assert got.dtype == np.int16 and np.array_equal(got, want)
        assert _max_diff(got, ref) <= 2


def test_execute_equals_synthesize(db):
    from ctts_tpu_torch.parallel.batch import BatchSynthesizer

    bs = BatchSynthesizer(db, config_defaults(), device=CPU)
    texts = BATCHES[1] + ["como se chama?"]
    got = bs.execute(bs.compile_plans(texts))
    want = bs.synthesize(texts, split=False)
    assert len(got) == len(want) == len(texts)
    for g, w in zip(got, want):
        assert g.dtype == np.int16 and np.array_equal(g, w)


def test_engine_close_drops_both_paths_graphs(db, monkeypatch):
    from ctts_tpu_torch.models.engine import CTTSEngine
    from ctts_tpu_torch.synth import compiled

    released = []
    monkeypatch.setattr(compiled, "release_compiled", released.append)
    eng = CTTSEngine(db.path, device=CPU)
    eng.synthesize("como vai")
    eng.synthesize_batch(["como vai"])
    voice_core = eng._voice.core()
    batch_core = eng._batcher.shards[0].core
    eng.close()
    assert released == [voice_core, batch_core]
    assert voice_core is not batch_core


@pytest.mark.cuda
def test_one_sentence_replay_equals_eager_on_the_card(db):
    """Each sentence three times on one voice (eager, capture, replay)
    and through the eager core: equal bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ctts_tpu_torch.synth import compiled
    from ctts_tpu_torch.synth.device import DeviceVoice, execute_plan_torch

    voice = DeviceVoice(db, device=torch.device("cuda"))
    before = dict(compiled.runs)
    for text, speed in SENTENCES:
        plan = compile_plan(db, text, config_defaults(), None, speed)
        outs = [execute_plan_torch(plan, db, voice) for _ in range(3)]
        run = compiled.run_batch
        compiled.run_batch = compiled.run_eager
        try:
            want = execute_plan_torch(plan, db, voice)
        finally:
            compiled.run_batch = run
        for got in outs:
            assert got.dtype == want.dtype and np.array_equal(got, want)
    assert compiled.runs["replay"] - before.get("replay", 0) >= 2
    compiled.release_compiled(voice.core())


# (batches of one stream, speed, LSB bound against the oracle): two
# short texts of tests/test_device_executor.py::CASES; a paragraph, at
# 1.0 split at its sentence boundaries into rows and held to the
# oracle's one buffer (plan/split.py splits at 1.0 only: at 1.5 it is
# one row); bench.py's first three texts in batches of 2 (sizes 2, 1).
PARAGRAPH = "bom dia. tudo bem."
MIXED = [["como vai?", "que legal!"], ["eu quero café, pão, e manteiga"]]
STREAMS = {"short_1.0": ([["como vai", "que legal!"]], 1.0, 0),
           "short_1.5": ([["como vai", "que legal!"]], 1.5, 0),
           "paragraph_1.0": ([[PARAGRAPH]], 1.0, 32),
           "paragraph_1.5": ([[PARAGRAPH]], 1.5, 2),
           "mixed_1.0": (MIXED, 1.0, 2),
           "mixed_1.5": (MIXED, 1.5, 2)}


@pytest.fixture(scope="module")
def unfloored(db):
    from ctts_tpu_torch.parallel.batch import BatchSynthesizer

    return BatchSynthesizer(db, config_defaults(), device=CPU)


@pytest.mark.parametrize("case", list(STREAMS))
def test_stream_held_to_the_oracle(db, unfloored, case):
    from ctts_tpu_torch.synth import compiled

    batches, speed, bound = STREAMS[case]
    widened = dict(compiled.widened)
    got = list(unfloored.stream(iter(batches), speed=speed))
    assert dict(compiled.widened) == widened
    assert [len(b) for b in got] == [len(b) for b in batches]
    for texts, outs in zip(batches, got):
        for t, o in zip(texts, outs):
            ref = execute_plan_oracle(
                compile_plan(db, t, config_defaults(), None, speed), db)
            assert o.dtype == np.int16 and _max_diff(o, ref) <= bound, t
    if PARAGRAPH in batches[0]:
        _, spans = unfloored._lower_batch([PARAGRAPH], speed, True)
        assert spans == [(0, 2 if speed == 1.0 else 1)]

