"""The host lowering's native fill (ctts_tpu_torch/plan/fill_rows.cpp,
NativeLowerer.fill_bucket) on the CPU.

(a) BatchSynthesizer._prepare_native gives, key by key and bit for bit,
    pad rows included, the (n, stacked, shared) and the row ids in slot
    order of the per-row composition it replaced: fill_into a row, the
    three scalars, then _order_and_pad and shared_plan_values. Corpus
    texts at speed 1.0 and 1.5, split on and off, one shard and the
    padding multiples of two and three, without a floor (buckets of one
    row) and at the serving floor; repeated texts give tied lengths, so
    the order's stability is held too;
(b) a row that does not fit its bucket raises the RuntimeError that
    fill_into raises, naming the row;
(c) the recorder: one batch through the native path records one
    `lower.fill` span and fill.native == fill.rows == the rows lowered;
    the Python path counts fill.rows and no fill.native.
"""

from collections import defaultdict

import numpy as np
import pytest
import torch

from ctts_tpu_torch.config import config_defaults
from ctts_tpu_torch.synth.plan_arrays import bucket_dims, shared_plan_values
from ctts_tpu_torch.testing.corpus import CORPUS
from ctts_tpu_torch.utils import timing

CPU = torch.device("cpu")
# tests/test_device_executor.py::test_corpus_shares_one_bucket's floor
# and texts.
FLOOR = {"U": 32, "R": 16, "FD": 8, "WREG": 32768, "SMAX": 131072,
         "CONTW": 32768, "WIN": 2048, "CFMAX": 1024}
TEXTS = ["oi", "a", "como vai", "que legal!", "como se chama?",
         "hoje de manhã eu acordei cedo e fui trabalhar",
         "o rato roeu a roupa do rei de roma"]
# Every corpus text once, then repeats: equal lengths in one bucket.
BATCH = [t for _, t, _ in CORPUS] + TEXTS + ["como vai"] * 3 + ["oi"] * 2


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def db(voice_db):
    from ctts_tpu_torch.db.reader import VoiceDatabase

    d = VoiceDatabase(voice_db)
    yield d
    d.close()


@pytest.fixture(scope="module")
def synths(db):
    """A native BatchSynthesizer per (shards, floor)."""
    from ctts_tpu_torch.parallel import BatchSynthesizer, make_mesh

    made = {}

    def get(shards, floor):
        if (shards, floor) not in made:
            kw = (dict(mesh=make_mesh([CPU] * shards)) if shards > 1
                  else dict(device=CPU))
            made[shards, floor] = BatchSynthesizer(
                db, config_defaults(), dims_floor=FLOOR if floor else None,
                wire=False, **kw)
        return made[shards, floor]

    return get


def _composed(bs, texts, speed, split):
    """_prepare_native as it was: one fill_into a row, then the scalars,
    _order_and_pad and shared_plan_values a bucket."""
    from ctts_tpu_torch.parallel.batch import _next_batch_size

    nl = bs._nl
    spans, dims_list, trips = nl.lower(texts, speed, split)
    buckets = defaultdict(list)
    for i, d in enumerate(dims_list):
        buckets[bucket_dims(d, bs.dims_floor)].append(i)
    per_bucket = []
    for bd, idxs in buckets.items():
        n = len(idxs)
        stacked = nl.alloc_stacked(bd, _next_batch_size(n, len(bs.shards)))
        for slot, ri in enumerate(idxs):
            nl.fill_into(ri, bd, stacked, slot)
        stacked["threshold"][:] = np.float32(bs.config.silence_threshold)
        stacked["speed"][:] = np.float32(speed)
        stacked["refine_trips"][:n] = [trips[ri] for ri in idxs]
        idxs = bs._order_and_pad(stacked, n, idxs)
        shared = shared_plan_values(stacked, bs.voice.lengths_np, bd)
        per_bucket.append((bd, idxs, (n, stacked, shared)))
    return (len(dims_list), per_bucket), spans


def _same_bits(a, b, where):
    a, b = np.asarray(a), np.asarray(b)
    assert (a.dtype, a.shape) == (b.dtype, b.shape), where
    assert a.tobytes() == b.tobytes(), where


@pytest.mark.parametrize("floor", [False, True], ids=["nofloor", "floor"])
@pytest.mark.parametrize("shards", [1, 2, 3])
@pytest.mark.parametrize("split", [True, False], ids=["split", "whole"])
@pytest.mark.parametrize("speed", [1.0, 1.5])
def test_bucket_fill_equals_row_fill(synths, speed, split, shards, floor):
    bs = synths(shards, floor)
    (n_got, got), spans_got = bs._prepare_native(BATCH, speed, split)
    (n_want, want), spans_want = _composed(bs, BATCH, speed, split)
    assert (n_got, spans_got) == (n_want, spans_want)
    assert [b[0] for b in got] == [b[0] for b in want]
    if not floor:
        assert min(b[2][0] for b in got) == 1      # a bucket of one row
    ties = 0
    for (bd, idxs, (n, stacked, shared)), (_, w_idxs, (w_n, w_st, w_sh)) \
            in zip(got, want):
        assert (n, idxs) == (w_n, w_idxs), bd
        assert stacked.keys() == w_st.keys()
        for k in w_st:
            _same_bits(stacked[k], w_st[k], (bd, k))
        assert shared.keys() == w_sh.keys()
        for k in w_sh:
            _same_bits(shared[k], w_sh[k], (bd, "shared", k))
        key = (stacked["region_len"][:n].sum(axis=1)
               + stacked["region_pause"][:n].sum(axis=1))
        ties += int(np.sum(key[1:] == key[:-1]))
    assert ties > 0


def test_row_wider_than_its_bucket_raises(synths):
    bs = synths(1, False)
    nl = bs._nl
    _, dims_list, trips = nl.lower(["oi", TEXTS[5]], 1.0, True)
    small = dims_list[0]
    assert dims_list[1].U > small.U
    with pytest.raises(RuntimeError, match=r"ctl_fill_row failed: -2 "
                       r"\(row 1\)"):
        nl.fill_bucket([0, 1], small, 8, np.array(trips), 0.01, 1.0)
    with pytest.raises(RuntimeError, match=r"ctl_fill_row failed: -2 "
                       r"\(row 1\)"):
        nl.fill_into(1, small, nl.alloc_stacked(small, 8), 1)


def _recorded(bs, texts):
    timing.disable()
    timing.reset()
    timing.enable()
    try:
        bs.synthesize(texts)
    finally:
        timing.disable()
    snap = timing.snapshot()
    timing.reset()
    totals: dict = {}
    for m in snap["marks"]:
        totals[m.name] = totals.get(m.name, 0) + m.n
    return [s for s in snap["spans"] if s.name == "lower.fill"], totals


def test_native_fill_is_recorded(synths):
    bs = synths(1, False)
    texts = ["como vai", "bom dia. tudo bem.", "oi"]
    fills, totals = _recorded(bs, texts)
    rows = len(bs._nl.lower(texts, 1.0, True)[1])
    assert len(fills) == 1
    assert totals["fill.native"] == totals["fill.rows"] == rows \
        == totals["rows.real"]
    assert fills[0].req is not None


def test_python_fill_counts_rows_only(db):
    from ctts_tpu_torch.parallel import BatchSynthesizer

    bs = BatchSynthesizer(db, config_defaults(), device=CPU, wire=False,
                          native_plans=False)
    fills, totals = _recorded(bs, ["como vai", "oi"])
    assert fills == []
    assert totals["fill.rows"] == totals["rows.real"] == 2
    assert "fill.native" not in totals
