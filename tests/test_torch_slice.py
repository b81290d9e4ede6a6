"""The speed-1.0 serving slice of ctts_tpu_torch against ctts_tpu and
the NumPy oracle, on the CPU.

(a) execute_plan_torch vs execute_plan_jax and execute_plan_oracle on
    the speed-1.0 texts of tests/test_device_executor.py::CASES: equal
    lengths, int16 samples within 2 LSB of both (the bound
    test_device_executor.py holds the JAX path to).
(b) the port's BatchSynthesizer.stream over the batches of
    test_stream_matches_synthesize equals its own synthesize exactly and
    ctts_tpu's BatchSynthesizer.synthesize within 2 LSB.
(c) what the slice does not serve raises NotImplementedError.
"""

import numpy as np
import pytest
import torch

from ctts_tpu.config import config_defaults
from ctts_tpu.db.reader import VoiceDatabase
from ctts_tpu.plan.compiler import compile_plan
from ctts_tpu.synth.oracle import execute_plan_oracle

CPU = torch.device("cpu")
TEXTS = ["como vai", "que legal!", "como se chama?", "bom dia. tudo bem.",
         "oi xz oi"]
BATCHES = [["como vai", "bom dia. tudo bem."],
           ["que legal", "a rosa"],
           ["vamos", "oi"]]


@pytest.fixture(scope="module")
def db(voice_db):
    return VoiceDatabase(voice_db)


@pytest.fixture(scope="module")
def voices(db):
    from ctts_tpu.synth.device import DeviceVoice as JVoice
    from ctts_tpu_torch.synth.device import DeviceVoice

    jv = JVoice(db)
    tv = DeviceVoice.from_numpy(np.asarray(jv.bank), np.asarray(jv.lengths),
                                np.asarray(jv.gains), CPU)
    return jv, tv


def _max_diff(a, b):
    assert a.shape == b.shape
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max(initial=0))


@pytest.mark.parametrize("text", TEXTS)
def test_execute_plan_matches_jax_and_oracle(db, voices, text):
    from ctts_tpu.synth.device import execute_plan_jax
    from ctts_tpu_torch.synth.device import execute_plan_torch

    plan = compile_plan(db, text, config_defaults(), None, 1.0)
    got = execute_plan_torch(plan, db, voices[1])
    assert got.dtype == np.int16
    assert _max_diff(got, execute_plan_oracle(plan, db)) <= 2
    assert _max_diff(got, execute_plan_jax(plan, db, voices[0])) <= 2


def test_stream_matches_synthesize_and_jax(db):
    from ctts_tpu.parallel.batch import BatchSynthesizer as JBatch
    from ctts_tpu_torch.parallel.batch import BatchSynthesizer

    bs = BatchSynthesizer(db, config_defaults(), device=CPU)
    got = list(bs.stream(iter(BATCHES)))
    assert len(got) == len(BATCHES)
    jbs = JBatch(db, config_defaults())
    for texts, outs in zip(BATCHES, got):
        own = bs.synthesize(texts)
        ref = jbs.synthesize(texts)
        assert len(outs) == len(own) == len(texts)
        for t, o, w, j in zip(texts, outs, own, ref):
            assert o.dtype == np.int16 and np.array_equal(o, w), t
            assert _max_diff(o, j) <= 2, t


def test_unserved_arguments_raise(db):
    from ctts_tpu_torch.parallel.batch import BatchSynthesizer

    cfg = config_defaults()
    with pytest.raises(NotImplementedError):
        BatchSynthesizer(db, cfg, device=CPU, mesh=object())
    with pytest.raises(NotImplementedError):
        BatchSynthesizer(db, cfg, device=CPU, wire=True)
    bs = BatchSynthesizer(db, cfg, device=CPU)
    with pytest.raises(NotImplementedError):
        bs.synthesize(["como vai"], speed=1.2)
    with pytest.raises(NotImplementedError):
        list(bs.stream([["como vai"]], speed=1.2))
