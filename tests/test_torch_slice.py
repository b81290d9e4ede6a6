"""The serving path of ctts_tpu_torch against ctts_tpu and the NumPy
oracle, on the CPU.

(a) execute_plan_torch vs execute_plan_jax and execute_plan_oracle on
    tests/test_device_executor.py::CASES (speed 1.0, and WSOLA at 0.5,
    1.2 and 1.5): equal lengths, int16 samples within 2 LSB of both
    (the bound test_device_executor.py holds the JAX path to).
(b) the port's BatchSynthesizer.stream over the batches of
    test_stream_matches_synthesize, at speed 1.0 and 1.5, equals its
    own synthesize exactly and ctts_tpu's BatchSynthesizer.synthesize
    within 2 LSB.
(c) a mesh that is not a parallel.mesh.Mesh raises TypeError (the
    split itself: tests/test_torch_mesh.py); the wire codec and every
    speed are served.
"""

import jax
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


@pytest.fixture(autouse=True)
def _drop_jax_executables():
    """XLA:CPU segfaults once enough large cores stay resident in one
    process (conftest.py releases them per module); release them after
    every test here."""
    yield
    from ctts_tpu.parallel.batch import release_compiled

    release_compiled()
    jax.clear_caches()


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


# test_device_executor.py's WSOLA cases: the same plans and buckets, so
# the JAX cores come from the persistent compile cache.
STRETCH = [("a rosa azul", s) for s in (1.5, 0.5, 1.2)]


@pytest.mark.parametrize("text,speed", [
    pytest.param(t, 1.0, id=t) for t in TEXTS] + [
    pytest.param(t, s, id=f"{t}-{s}") for t, s in STRETCH])
def test_execute_plan_matches_jax_and_oracle(db, voices, text, speed):
    from ctts_tpu.synth.device import execute_plan_jax
    from ctts_tpu_torch.synth.device import execute_plan_torch

    plan = compile_plan(db, text, config_defaults(), None, speed)
    got = execute_plan_torch(plan, db, voices[1])
    assert got.dtype == np.int16
    assert _max_diff(got, execute_plan_oracle(plan, db)) <= 2
    assert _max_diff(got, execute_plan_jax(plan, db, voices[0])) <= 2


@pytest.mark.parametrize("speed", [
    pytest.param(1.0, id="1.0"), pytest.param(1.5, id="1.5")])
def test_stream_matches_synthesize_and_jax(db, speed):
    from ctts_tpu.parallel.batch import BatchSynthesizer as JBatch
    from ctts_tpu_torch.parallel.batch import BatchSynthesizer

    bs = BatchSynthesizer(db, config_defaults(), device=CPU)
    got = list(bs.stream(iter(BATCHES), speed=speed))
    assert len(got) == len(BATCHES)
    jbs = JBatch(db, config_defaults())
    for texts, outs in zip(BATCHES, got):
        own = bs.synthesize(texts, speed=speed)
        ref = jbs.synthesize(texts, speed=speed)
        assert len(outs) == len(own) == len(texts)
        for t, o, w, j in zip(texts, outs, own, ref):
            assert o.dtype == np.int16 and np.array_equal(o, w), t
            assert _max_diff(o, j) <= 2, t


def test_unserved_arguments_raise(db):
    from ctts_tpu_torch.parallel.batch import BatchSynthesizer

    cfg = config_defaults()
    with pytest.raises(TypeError):
        BatchSynthesizer(db, cfg, mesh=object())
    assert BatchSynthesizer(db, cfg, device=CPU, wire=True).wire
    bs = BatchSynthesizer(db, cfg, device=CPU)
    plan = compile_plan(db, "a rosa azul", cfg, None, 1.2)
    want = execute_plan_oracle(plan, db)
    (got,) = bs.synthesize(["a rosa azul"], speed=1.2)
    assert np.array_equal(got, list(bs.stream([["a rosa azul"]],
                                              speed=1.2))[0][0])
    assert _max_diff(got, want) <= 2
