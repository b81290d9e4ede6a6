"""The host half of ctts_tpu_torch against ctts_tpu's.

The port carries jax-free copies of the plan lowering
(synth/plan_arrays.py), of the libctts.so binding
(plan/native_lower.py, over its own copy of the native runtime) and of
the voice-bank upload (DeviceVoice). On bench.py's 16 texts every
walked record, dimension and array must equal the JAX package's, array
for array.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import ctts_tpu_torch
from bench import TEXTS
from ctts_tpu.config import config_defaults
from ctts_tpu.db.reader import VoiceDatabase
from ctts_tpu.plan.compiler import compile_plan
from ctts_tpu.synth import device as jdev
from ctts_tpu_torch.synth import plan_arrays as tpa

CPU = torch.device("cpu")
# bench.py's serving floor (one bucket for the corpus).
FLOOR = {"U": 32, "R": 16, "FD": 8, "WREG": 32768, "SMAX": 114688,
         "CONTW": 28672, "WIN": 2048, "CFMAX": 1024}


@pytest.fixture(scope="module")
def db(voice_db):
    return VoiceDatabase(voice_db)


def _same_arrays(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert np.array_equal(x, y), k


@pytest.mark.parametrize("text", TEXTS)
def test_lowering_equal(db, text):
    plan = compile_plan(db, text, config_defaults(), None, 1.0)
    jw, tw = jdev.walk_plan(plan, db), tpa.walk_plan(plan, db)
    for f in dataclasses.fields(jw):
        assert getattr(jw, f.name) == getattr(tw, f.name), f.name
    jd, td = jdev.derive_dims(jw, db), tpa.derive_dims(tw, db)
    assert dataclasses.asdict(jd) == dataclasses.asdict(td)
    lens = db.index["sample_count"].astype(np.int32)
    for floor in (None, FLOOR):
        jb, tb = jdev.bucket_dims(jd, floor), tpa.bucket_dims(td, floor)
        assert dataclasses.asdict(jb) == dataclasses.asdict(tb)
        jp, tp = jdev.fill_device_plan(jw, db, jb), tpa.fill_device_plan(
            tw, db, tb)
        _same_arrays(jp.arrays, tp.arrays)
        _same_arrays(jdev.shared_plan_values(jp.arrays, lens, jb),
                     tpa.shared_plan_values(tp.arrays, lens, tb))


def test_native_lowerer_equal(db):
    """The port's libctts.so, built from its own copy of the runtime
    (ctts_tpu_torch/runtime), lowers like ctts_tpu's, at speed 1.0 and
    in the stretch buckets of speed 1.5."""
    from ctts_tpu.plan.native_lower import NativeLowerer as JNL
    from ctts_tpu_torch.plan import native_lower as tnl_mod
    from ctts_tpu_torch.plan.native_lower import NativeLowerer as TNL

    cfg = config_defaults()
    jnl, tnl = JNL(db.path, cfg), TNL(db.path, cfg)
    assert tnl_mod._SO == os.path.join(
        os.path.dirname(ctts_tpu_torch.__file__), "runtime", "libctts.so")
    for speed in (1.0, 1.5):
        js, jdims, jtrips = jnl.lower(TEXTS, speed, True)
        ts, tdims, ttrips = tnl.lower(TEXTS, speed, True)
        assert js == ts and jtrips == ttrips
        assert [dataclasses.asdict(d) for d in jdims] == \
            [dataclasses.asdict(d) for d in tdims]
        for r, (jd, td) in enumerate(zip(jdims, tdims)):
            jb, tb = jdev.bucket_dims(jd, FLOOR), tpa.bucket_dims(td, FLOOR)
            ja, ta = jnl.alloc_stacked(jb, 1), tnl.alloc_stacked(tb, 1)
            jnl.fill_into(r, jb, ja, 0)
            tnl.fill_into(r, tb, ta, 0)
            for k in ("threshold", "speed", "refine_trips"):
                del ja[k], ta[k]      # filled by the caller, not the lib
            _same_arrays(ja, ta)
    tnl.close()


def test_native_and_python_lowering_agree(db):
    """The port's two host lowerings stack the same batch."""
    from ctts_tpu_torch.parallel.batch import BatchSynthesizer

    texts = TEXTS[:6] + ["bom dia. tudo bem. como vai."]
    cfg = config_defaults()
    outs = []
    for native in (True, False):
        bs = BatchSynthesizer(db, cfg, device=CPU, native_plans=native,
                              dims_floor=FLOOR)
        outs.append(bs._lower_batch(texts, 1.0, True))
    (nn, nb), nspans = outs[0]
    (pn, pb), pspans = outs[1]
    assert nn == pn and nspans == pspans and len(nb) == len(pb) == 1
    assert nb[0][0] == pb[0][0] and nb[0][1] == pb[0][1]
    _same_arrays(nb[0][2][1], pb[0][2][1])
    _same_arrays(nb[0][2][2], pb[0][2][2])


def test_device_voice_routes_equal(db):
    """DeviceVoice from the db equals DeviceVoice.from_numpy of the JAX
    DeviceVoice's arrays, bit for bit."""
    from ctts_tpu_torch.synth.device import DeviceVoice

    jv = jdev.DeviceVoice(db)
    own = DeviceVoice(db, device=CPU)
    carried = DeviceVoice.from_numpy(np.asarray(jv.bank),
                                     np.asarray(jv.lengths),
                                     np.asarray(jv.gains), CPU)
    for name in ("bank", "lengths", "gains"):
        a, b = getattr(own, name), getattr(carried, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name
        assert np.array_equal(a.numpy(), np.asarray(getattr(jv, name)))
    assert own.ubuf == carried.ubuf == jv.ubuf
