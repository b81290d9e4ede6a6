"""One decide launch a batch over every stretch bucket (ops/hopper/wsola.py
decide_table, synth/compiled.py Pending), on the CPU and on a card.

(a) decide_table's plain path gives each segment the positions that
    wsola_frames_plain's `choices` give its bucket: segments of other
    B, S and max_steps, hop 85 (1.5) and 256 (0.5), rows with nrun 0
    and pad rows (copies of the last real row);
(b) the launch tables: every segment once, the widest first, at most
    MAX_SEGMENTS a launch (past 32 segments, a second);
(c) the serving loop's pending set: two shards on one CPU device share
    a signature, so each bucket's second shard flushes the set first;
    the outputs equal the eager core's (a decide in every bucket's own
    epilogue) and one shard's bit for bit, and the counters stretch.rows
    and stretch.batched count the stretch buckets' real rows; at 1.0
    nothing waits;
(d) on a card: the table launch's positions equal each bucket's own
    decide launch, over 40 segments; a stream at 1.5 through the split
    graphs equals the same stream through the whole epilogue graphs
    (per-bucket K5) bit for bit, and is held to the oracle.

The file imports no JAX (the card's host has none): run its card cases
there with `python -m pytest --noconftest -m cuda
tests/test_torch_wsola_table.py`.
"""

import os

import numpy as np
import pytest
import torch

from ctts_tpu_torch.ops import wsola as tw
from ctts_tpu_torch.ops.hopper import wsola as hwsola

CPU = torch.device("cpu")

# (B, S, speed, [(kind, input count)] of the real rows, pad rows).
SEGMENTS = [
    (3, 4096, 1.5, [("tonal", 4096), ("noise", 3000), ("tonal", 400)], 0),
    (4, 6144, 0.5, [("periodic", 5000), ("tonal", 2500)], 2),
    (2, 2048, 1.5, [("noise", 1800), ("tonal", 0)], 0),
    (8, 3072, 1.5, [("tonal", 3072), ("periodic", 2100), ("noise", 700)], 5),
]


def _signal(rng, n, kind):
    t = np.arange(n, dtype=np.float32)
    if kind == "tonal":
        x = (6000 * np.sin(2 * np.pi * 137.3 * t / 22050)
             + 2500 * np.sin(2 * np.pi * 291.7 * t / 22050)
             + rng.normal(0, 300, n))
    elif kind == "noise":
        x = rng.normal(0, 5000, n)
    else:  # periodic near-ties: the tie-break stressor
        x = 8000 * np.sin(2 * np.pi * 128 * t / 22050)
    return np.trunc(np.clip(x, -32768, 32767)).astype(np.float32)


def _bucket(B, S, speed, rows, pads, seed, device=CPU):
    """(Segment with pos filled with -7, hop, out_size) of one bucket:
    the real rows, then `pads` copies of the last one."""
    rng = np.random.default_rng(seed)
    inp = np.zeros((B, S), np.float32)
    counts = []
    for b, (kind, n) in enumerate(rows):
        inp[b, :n] = _signal(rng, n, kind)
        counts.append(n)
    for b in range(len(rows), len(rows) + pads):
        inp[b] = inp[len(rows) - 1]
        counts.append(counts[-1])
    counts += [0] * (B - len(counts))
    hop = tw.synthesis_hop_for_speed(speed)
    out_size = 2 * S + 2048
    inp = torch.as_tensor(inp, device=device)
    ic = torch.tensor(counts, dtype=torch.int32, device=device)
    nrun = tw.run_counts(ic, S, out_size, hop)
    pos = torch.full((B, tw.max_steps_for(S, out_size, hop)), -7,
                     dtype=torch.int32, device=device)
    return hwsola.Segment(inp, tw.energy_table(inp), ic, nrun, pos), hop, \
        out_size


def _choices(seg, hop, out_size):
    got = {}
    tw.wsola_frames_plain(seg.inp.cpu(), seg.sq.cpu(), seg.input_count.cpu(),
                          seg.nrun.cpu(), hop, out_size, choices=got)
    return got["pos"]


@pytest.mark.parametrize("picks", [[0], [1, 2], [0, 1, 2, 3]])
def test_table_plain_equals_each_bucket_choices(picks):
    made = [_bucket(*SEGMENTS[i], seed=10 + i) for i in picks]
    hwsola.decide_table([seg for seg, _, _ in made])
    for seg, hop, out_size in made:
        want = _choices(seg, hop, out_size)
        assert torch.equal(seg.pos, want)
        nr = seg.nrun.numpy()
        for b in range(seg.pos.shape[0]):
            assert (seg.pos[b, nr[b]:] == -1).all()


def test_tables_widest_first_and_chunked():
    segs = []
    for i in range(hwsola.MAX_SEGMENTS + 8):
        S = 1024 + 128 * ((7 * i) % 13)
        B = 1 + i % 3
        segs.append(hwsola.Segment(
            torch.zeros(B, S), torch.zeros(B, S),
            torch.zeros(B, dtype=torch.int32),
            torch.zeros(B, dtype=torch.int32),
            torch.zeros(B, 5 + i, dtype=torch.int32)))
    tables = hwsola._tables(segs)
    assert [len(t) for t in tables] == [hwsola.MAX_SEGMENTS, 8]
    rows = [r for t in tables for r in t]
    assert [r.S for r in rows] == sorted((s.inp.shape[1] for s in segs),
                                         reverse=True)
    by_inp = {r.inp: r for r in rows}
    assert len(by_inp) == len(segs)
    for s in segs:
        r = by_inp[s.inp.data_ptr()]
        assert (r.sq, r.input_count, r.nrun, r.pos) == (
            s.sq.data_ptr(), s.input_count.data_ptr(), s.nrun.data_ptr(),
            s.pos.data_ptr())
        assert (r.rows, r.S, r.max_steps) == (*s.inp.shape, s.pos.shape[1])
    assert hwsola._tables([]) == []


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    """A voice built from the generated dataset (the port's copies of the
    generator and the builder)."""
    from ctts_tpu_torch.db.builder import build_database
    from ctts_tpu_torch.db.dataset import generate_dataset
    from ctts_tpu_torch.db.reader import VoiceDatabase

    root = str(tmp_path_factory.mktemp("wsola_table"))
    ds = os.path.join(root, "dataset")
    generate_dataset(ds)
    out = os.path.join(root, "voice.db")
    build_database(os.path.join(ds, "letters", "wavs"),
                   os.path.join(ds, "letters", "letters.txt"),
                   os.path.join(ds, "syllables", "wavs"),
                   os.path.join(ds, "syllables", "sillabes.txt"), out,
                   verbose=False)
    return VoiceDatabase(out)


# Two batches of one stream; the second meets the first's signatures
# again. Short texts keep the CPU runs small.
BATCHES = [["como vai", "que legal!", "a rosa"],
           ["oi", "bom dia", "como se chama?"]]


def _synth(db, device, **kw):
    from ctts_tpu_torch.config import config_defaults
    from ctts_tpu_torch.parallel.batch import BatchSynthesizer

    return BatchSynthesizer(db, config_defaults(), device=device, **kw)


def _stream(bs, speed):
    return list(bs.stream(iter(BATCHES), speed=speed))


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert a.dtype == b.dtype == np.int16 and np.array_equal(a, b)


@pytest.mark.parametrize("speed", [1.5, 1.0])
def test_pending_flushes_when_a_signature_recurs(db, monkeypatch, speed):
    from ctts_tpu_torch.parallel import make_mesh
    from ctts_tpu_torch.synth import compiled
    from ctts_tpu_torch.utils import timing

    two = _synth(db, None, mesh=make_mesh([CPU, CPU]))
    one = _synth(db, CPU)
    eager = _synth(db, CPU)
    eager._run_core = compiled.run_eager
    want = _stream(eager, speed)

    tables = []
    table = hwsola.decide_table

    def recorded(segments):
        tables.append(len(segments))
        return table(segments)

    monkeypatch.setattr(hwsola, "decide_table", recorded)
    timing.disable()
    timing.reset()
    timing.enable()
    try:
        got = _stream(two, speed)
    finally:
        timing.disable()
    marks = timing.snapshot()["marks"]
    timing.reset()
    _equal(got, want)
    flushes = len(tables)
    _equal(_stream(one, speed), want)

    counted = {}
    for m in marks:
        counted[m.name] = counted.get(m.name, 0) + m.n
    buckets = counted["buckets"]
    if speed == 1.0:
        assert tables == []
        assert "stretch.rows" not in counted
        return
    # Every bucket waits on both shards; the second shard's signature is
    # the first's, so it flushes the set (the first shard alone, or with
    # the buckets before it), and each batch ends with a flush.
    assert sum(tables[:flushes]) == 2 * buckets
    assert flushes == buckets + len(BATCHES)
    assert tables[0] == 1
    assert counted["stretch.rows"] == counted["stretch.batched"] \
        == counted["rows.real"] == sum(len(b) for b in BATCHES)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_table_launch_equals_each_bucket_decide(cuda_device):
    """40 segments (past MAX_SEGMENTS: two launches), pos pre-filled with
    -7: every row of every segment is written, with the positions of the
    segment's own decide launch and of the plain chain."""
    made = []
    for i in range(hwsola.MAX_SEGMENTS + 8):
        B, S, speed, rows, pads = SEGMENTS[i % len(SEGMENTS)]
        made.append(_bucket(B, S, speed, rows, pads, seed=100 + i,
                            device=cuda_device))
    before = hwsola.decide_kernel.launches, hwsola.launches
    hwsola.decide_table([seg for seg, _, _ in made])
    assert (hwsola.decide_kernel.launches, hwsola.launches) == (
        before[0] + 2, before[1])
    for seg, hop, out_size in made:
        own = hwsola.decide(seg.inp, seg.sq, seg.input_count, seg.nrun,
                            seg.pos.shape[1])
        assert torch.equal(seg.pos, own)
        assert torch.equal(seg.pos.cpu(), _choices(seg, hop, out_size))
        acc, norm = hwsola.emit(seg.inp, seg.pos, seg.nrun, hop, out_size)
        want = hwsola.wsola_frames(seg.inp, seg.sq, seg.input_count,
                                   seg.nrun, hop, out_size)
        assert torch.equal(acc, want[0]) and torch.equal(norm, want[1])


@pytest.mark.cuda
def test_split_stream_equals_per_bucket_and_oracle(db, cuda_device):
    """A stream at 1.5 three times (each signature's first batch eager,
    its second captured, then replays) through the split graphs and
    through the whole epilogue graphs (a decide launch a bucket), with
    the wire codec on and off: equal bit for bit, and within 2 LSB of
    the oracle."""
    from ctts_tpu_torch.config import config_defaults
    from ctts_tpu_torch.plan.compiler import compile_plan
    from ctts_tpu_torch.synth import compiled
    from ctts_tpu_torch.synth.oracle import execute_plan_oracle

    def whole(*args, pending=None, **kwargs):
        return compiled.run_batch(*args, **kwargs)

    for wire in (True, False):
        split = _synth(db, cuda_device, wire=wire)
        per_bucket = _synth(db, cuda_device, wire=wire)
        per_bucket._run_core = whole
        runs = dict(compiled.runs)
        tables = hwsola.decide_kernel.launches
        for _ in range(3):
            got = _stream(split, 1.5)
            _equal(got, _stream(per_bucket, 1.5))
        assert compiled.runs["replay"] > runs.get("replay", 0)
        assert hwsola.decide_kernel.launches > tables
        assert any(s.split for s in compiled.signatures())
        compiled.release_compiled()
    for texts, outs in zip(BATCHES, got):
        for t, o in zip(texts, outs):
            ref = execute_plan_oracle(
                compile_plan(db, t, config_defaults(), None, 1.5), db)
            assert o.shape == ref.shape
            assert np.abs(o.astype(np.int32) - ref.astype(np.int32)).max(
                initial=0) <= 2, t
