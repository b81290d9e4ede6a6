"""The serving drain's native wire decode (ctts_tpu_torch/ops/wire_rows.py,
ops/wire_rows.cpp) on the CPU.

(a) both exported paths, AVX2 and scalar, write what decode_np gives,
    sliced at the row ends, into the rows' own arrays, bit for bit: word
    streams of random classes 1-5 (random residual nibbles, so both
    running sums wrap), encoded int16 extremes that wrap through
    +-32768, rows ending mid-block and on block edges, empty rows, one
    row, 128 rows, a last partial block, 0 samples, two shards in one
    call, skipped rows;
(b) a class of 0 or 7 and too few words or classes raise the ValueError
    that decode_host raises;
(c) BatchSynthesizer with the codec equals it without, through
    synthesize and stream, on one shard and on a two-shard mesh: equal
    rows, each owning its data; the drain's spans and the decode
    counters are recorded;
(d) copy_rows, the codec-off pass, writes what a NumPy slice copy
    writes: several shards, rows of length 0, skipped rows; too few
    samples, addresses that do not match the ends and decreasing ends
    raise ValueError;
(e) BatchSynthesizer without the codec, texts split into several rows
    and a row run again (_widen), gives the rows a plain Python copy of
    each row gives, bit for bit, and the oracle's samples within 2 LSB;
    the pass's span and counters are recorded.
"""

import numpy as np
import pytest
import torch

from ctts_tpu_torch.ops import wire as twire
from ctts_tpu_torch.ops import wire_rows
from ctts_tpu_torch.utils import timing

CPU = torch.device("cpu")


def _addresses(rows):
    return np.array([0 if r is None else r.ctypes.data for r in rows],
                    np.uint64)
K = twire.WIRE_BLOCK
TEXTS = ["como vai", "bom dia. tudo bem.", "que legal!", "a rosa", "oi"]


def _words(classes, rng):
    """A word stream in the codec's layout for `classes`: random
    residuals of each block's class width, as its nibble planes."""
    words = []
    for c in classes:
        z = rng.integers(0, 16 ** int(c), K, dtype=np.int64)
        for p in range(int(c)):
            nib = ((z >> (4 * p)) & 0xF).reshape(-1, 8).astype(np.uint32)
            words.append((nib << (4 * np.arange(8, dtype=np.uint32))
                          ).sum(axis=1, dtype=np.uint32))
    if not words:
        return np.zeros(0, np.int32)
    return np.concatenate(words).view(np.int32)


def _random(nblk, seed):
    rng = np.random.default_rng(seed)
    classes = rng.integers(1, 6, nblk).astype(np.int32)
    return _words(classes, rng), classes


def _extremes():
    """int16 extremes through the encoder: 5-plane blocks whose samples
    wrap through +-32768, beside 1-plane ones."""
    rng = np.random.default_rng(11)
    x = rng.choice(np.array([-32768, 32767, -1, 0, 1], np.int16), 6 * K)
    x[2 * K:3 * K] = 0
    w, c = twire.encode(torch.from_numpy(x))
    return w.numpy(), c.numpy()


def _ends(total, n, rng, edges=False):
    """n row ends in [0, total], the last at total; on block edges where
    `edges`."""
    if edges:
        cuts = rng.integers(0, total // K + 1, n - 1) * K
    else:
        cuts = rng.integers(0, total + 1, n - 1)
    return np.append(np.sort(cuts), total).astype(np.int64)


def _case(name):
    """[(words, classes, ends)] of one call."""
    rng = np.random.default_rng(CASES.index(name))
    if name == "random_classes":
        w, c = _random(40, 1)
        return [(w, c, _ends(40 * K - 100, 17, rng))]
    if name == "block_edges":
        w, c = _random(24, 2)
        ends = np.array([0, K, K, 5 * K, 6 * K, 6 * K, 20 * K, 24 * K],
                        np.int64)
        return [(w, c, ends)]
    if name == "mid_and_edge":
        w, c = _random(24, 3)
        ends = np.sort(np.concatenate([_ends(24 * K, 9, rng, edges=True),
                                       _ends(24 * K, 9, rng)]))
        return [(w, c, ends)]
    if name == "one_row":
        w, c = _random(9, 4)
        return [(w, c, np.array([9 * K - 7], np.int64))]
    if name == "rows_128":
        w, c = _random(70, 5)
        return [(w, c, _ends(70 * K - 300, 128, rng))]
    if name == "partial_last":
        w, c = _random(6, 6)
        return [(w, c, np.array([K + 3, 5 * K + 1], np.int64))]
    if name == "wrap_int16":
        w, c = _extremes()
        return [(w, c, _ends(6 * K, 11, rng))]
    if name == "zero_samples":
        return [(np.zeros(0, np.int32), np.zeros(0, np.int32),
                 np.zeros(3, np.int64))]
    if name == "two_shards":
        w1, c1 = _random(13, 7)
        w2, c2 = _extremes()
        return [(w1, c1, _ends(13 * K - 40, 30, rng)),
                (w2, c2, _ends(5 * K + 9, 30, rng))]
    raise KeyError(name)


CASES = ["random_classes", "block_edges", "mid_and_edge", "one_row",
         "rows_128", "partial_last", "wrap_int16", "zero_samples",
         "two_shards"]


@pytest.mark.parametrize("which", wire_rows.PATHS)
@pytest.mark.parametrize("name", CASES + ["skipped_rows"])
def test_paths_equal_decode_np_sliced(name, which):
    """Every row's array holds decode_np's samples of its range; a row
    given no array (every third one, in the skipped_rows case) is left
    alone and not counted."""
    skipping = name == "skipped_rows"
    shards, checks, want_total = [], [], 0
    for w, c, ends in _case("rows_128" if skipping else name):
        want = twire.decode_np(w, c, int(ends[-1]))
        starts = np.concatenate([[0], ends[:-1]]).astype(np.int64)
        rows = [np.full(e - s, 7, np.int16) for s, e in zip(starts, ends)]
        skip = set(range(0, len(rows), 3)) if skipping else set()
        shards.append((w, c, ends, _addresses(
            [None if i in skip else r for i, r in enumerate(rows)])))
        checks.append((want, starts, ends, rows, skip))
        want_total += sum(len(r) for i, r in enumerate(rows)
                          if i not in skip)
    assert wire_rows.decode_rows(shards, which) == want_total
    for want, starts, ends, rows, skip in checks:
        for i, (s, e, r) in enumerate(zip(starts, ends, rows)):
            if i in skip:
                assert (r == 7).all(), i
            else:
                assert np.array_equal(r, want[s:e]), (i, s, e)


def test_path_is_chosen_at_load():
    assert wire_rows.path() in wire_rows.PATHS
    w, c = _random(8, 9)
    ends = np.array([8 * K - 5], np.int64)
    a, b = np.empty(8 * K - 5, np.int16), np.empty(8 * K - 5, np.int16)
    wire_rows.decode_rows([(w, c, ends, _addresses([a]))])
    wire_rows.decode_rows([(w, c, ends, _addresses([b]))], wire_rows.path())
    assert np.array_equal(a, b)


@pytest.mark.parametrize("which", wire_rows.PATHS)
@pytest.mark.parametrize("bad,match", [
    ("class0", "outside 1..5"), ("class7", "outside 1..5"),
    ("few_words", "words"), ("few_classes", "words")])
def test_bad_input_raises_as_decode_host(bad, match, which):
    wire = np.zeros(twire.WIRE_CHUNK_W * 7, np.int32)
    n, classes = K, np.array([1], np.int32)
    if bad == "class0":
        n, classes = K + 1, np.array([0, 1], np.int32)
    elif bad == "class7":
        classes = np.array([7], np.int32)
    elif bad == "few_words":
        wire = wire[:10]
    else:
        n = 2 * K
    with pytest.raises(ValueError, match=match):
        twire.decode_host(wire, classes, n)
    with pytest.raises(ValueError, match=match):
        wire_rows.decode_rows(
            [(wire, classes, np.array([n], np.int64),
              _addresses([np.empty(n, np.int16)]))], which)


@pytest.fixture(scope="module")
def db(voice_db):
    from ctts_tpu_torch.db.reader import VoiceDatabase

    d = VoiceDatabase(voice_db)
    yield d
    d.close()


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("shards", [1, 2], ids=["one_shard", "mesh2"])
def test_serving_with_codec_equals_without(db, shards):
    from ctts_tpu_torch.config import config_defaults
    from ctts_tpu_torch.parallel import BatchSynthesizer, make_mesh

    mesh = make_mesh([CPU] * 2) if shards == 2 else None
    kw = dict(mesh=mesh) if mesh is not None else dict(device=CPU)
    plain = BatchSynthesizer(db, config_defaults(), wire=False, **kw)
    wired = BatchSynthesizer(db, config_defaults(), wire=True, **kw)
    assert len(wired.shards) == shards
    want = plain.synthesize(TEXTS)
    timing.disable()
    timing.reset()
    timing.enable()
    try:
        got = wired.synthesize(TEXTS)
        streamed = list(wired.stream(iter([TEXTS[:2], TEXTS[2:]])))
    finally:
        timing.disable()
    snap = timing.snapshot()
    timing.reset()
    for t, w, g, s in zip(TEXTS, want, got, streamed[0] + streamed[1]):
        assert g.dtype == s.dtype == np.int16
        assert np.array_equal(w, g) and np.array_equal(w, s), t
        assert g.flags.owndata and s.flags.owndata, t
    names = {s.name for s in snap["spans"]}
    assert {"drain.decode", "drain.rows", "drain.wait_copy"} <= names
    marks = {}
    for m in snap["marks"]:
        marks[m.name] = marks.get(m.name, 0) + m.n
    samples = 2 * sum(len(w) for w in want)
    assert marks["decode.samples"] == samples
    vector = samples if wire_rows.path() != "scalar" else 0
    assert marks["decode.vector"] == vector


def _raw_case(name):
    """[(samples, ends, skipped row indices)] of one copy_rows call."""
    rng = np.random.default_rng(RAW_CASES.index(name) + 50)
    if name == "one_shard":
        return [(rng.integers(-32768, 32768, 5000, dtype=np.int16),
                 _ends(4990, 17, rng), set())]
    if name == "empty_rows":
        return [(rng.integers(-32768, 32768, 900, dtype=np.int16),
                 np.array([0, 0, 300, 300, 300, 899, 899], np.int64),
                 set())]
    if name == "skipped_rows":
        return [(rng.integers(-32768, 32768, 7000, dtype=np.int16),
                 _ends(7000, 128, rng), set(range(0, 128, 3)))]
    if name == "three_shards":
        return [(rng.integers(-32768, 32768, n, dtype=np.int16),
                 _ends(n - extra, rows, rng), skip)
                for n, extra, rows, skip in ((3000, 0, 9, {4}),
                                             (0, 0, 2, set()),
                                             (1200, 37, 30, {0, 29}))]
    raise KeyError(name)


RAW_CASES = ["one_shard", "empty_rows", "skipped_rows", "three_shards"]


@pytest.mark.parametrize("name", RAW_CASES)
def test_copy_rows_equals_numpy_slices(name):
    """Every row's array holds its range of its shard's samples, as a
    NumPy slice copy gives it; a skipped row (address 0) is left alone
    and not counted."""
    shards, checks, want_total = [], [], 0
    for x, ends, skip in _raw_case(name):
        starts = np.concatenate([[0], ends[:-1]]).astype(np.int64)
        rows = [np.full(e - s, 7, np.int16) for s, e in zip(starts, ends)]
        shards.append((x, ends, _addresses(
            [None if i in skip else r for i, r in enumerate(rows)])))
        checks.append((x, starts, ends, rows, skip))
        want_total += sum(len(r) for i, r in enumerate(rows)
                          if i not in skip)
    assert wire_rows.copy_rows(shards) == want_total
    for x, starts, ends, rows, skip in checks:
        for i, (s, e, r) in enumerate(zip(starts, ends, rows)):
            want = np.full(e - s, 7, np.int16) if i in skip else x[s:e]
            assert np.array_equal(r, want), (i, s, e)


@pytest.mark.parametrize("bad,match", [
    ("few_samples", "samples"), ("addresses", "addresses"),
    ("decreasing", "decreasing")])
def test_copy_rows_bad_input_raises(bad, match):
    x = np.arange(100, dtype=np.int16)
    ends = np.array([40, 100], np.int64)
    rows = [np.empty(40, np.int16), np.empty(60, np.int16)]
    addrs = _addresses(rows)
    if bad == "few_samples":
        x = x[:99]
    elif bad == "addresses":
        addrs = addrs[:1]
    else:
        ends = np.array([60, 40], np.int64)
    with pytest.raises(ValueError, match=match):
        wire_rows.copy_rows([(x, ends, addrs)])


# The bucket floor of tests/test_torch_config.py: TEXTS share one bucket,
# so the rows beside the one run again go through the native copy.
ONE_BUCKET = {"U": 16, "R": 8, "FD": 4, "WREG": 32768, "SMAX": 65536,
              "CONTW": 16384, "WIN": 2048, "CFMAX": 1024}


def _python_drain(trimmed, spans):
    """The drain as a plain loop: each row's samples sliced out of its
    shard's host buffer, or the output of its run again, and each text
    its rows joined."""
    n_rows, per_bucket = trimmed
    rows = [None] * n_rows
    for idxs, (shards, wide) in per_bucket:
        slot = 0
        for host, _, _, ends in shards:
            start = 0
            for end in ends.tolist():
                rows[idxs[slot]] = (wide[slot] if slot in wide
                                    else host[start:end])
                start = end
                slot += 1
    return [np.concatenate(rows[s:e]) for s, e in spans]


def test_serving_without_codec_equals_python_copy_and_oracle(db,
                                                            monkeypatch):
    from ctts_tpu_torch.config import config_defaults
    from ctts_tpu_torch.parallel.batch import BatchSynthesizer
    from ctts_tpu_torch.plan.compiler import compile_plan
    from ctts_tpu_torch.synth.oracle import execute_plan_oracle

    drained = []
    drain, widen = BatchSynthesizer._drain, BatchSynthesizer._widen

    def record(self, trimmed, spans=None):
        outs = drain(self, trimmed, spans)
        drained.append((trimmed, spans, outs))
        return outs

    def widen_first(self, handle, slots):
        # Slot 0 of every bucket runs again, as an overflowing row would.
        return widen(self, handle, sorted(set(slots) | {0}))

    monkeypatch.setattr(BatchSynthesizer, "_drain", record)
    monkeypatch.setattr(BatchSynthesizer, "_widen", widen_first)
    cfg = config_defaults()
    bs = BatchSynthesizer(db, cfg, wire=False, device=CPU,
                          dims_floor=ONE_BUCKET)
    timing.disable()
    timing.reset()
    timing.enable()
    try:
        got = bs.synthesize(TEXTS)
    finally:
        timing.disable()
    snap = timing.snapshot()
    timing.reset()
    (trimmed, spans, outs), = drained
    assert outs is got
    assert len(trimmed[1]) == 1                      # one bucket
    assert max(e - s for s, e in spans) > 1          # a text of rows
    wide = [src for _, (_, w) in trimmed[1] for src in w.values()]
    assert wide
    for t, g, w in zip(TEXTS, got, _python_drain(trimmed, spans)):
        assert g.dtype == np.int16 and g.flags.owndata, t
        assert np.array_equal(g, w), t
        ref = execute_plan_oracle(compile_plan(db, t, cfg, None, 1.0), db)
        assert g.shape == ref.shape, t
        assert int(np.abs(g.astype(np.int32) - ref).max()) <= 2, t
    assert {"drain.raw", "drain.rows"} <= {s.name for s in snap["spans"]}
    marks = {}
    for m in snap["marks"]:
        marks[m.name] = marks.get(m.name, 0) + m.n
    assert marks["raw.samples"] == sum(len(g) for g in got)
    assert marks["raw.native"] == marks["raw.samples"] - sum(
        len(w) for w in wide) > 0
    assert "decode.samples" not in marks
