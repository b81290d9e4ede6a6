"""The device voice bundle of ctts_tpu_torch (db/bundle.py) on the CPU,
analogs of tests/test_bundle.py.

(a) the round trip: a saved bundle loads with the voice's arrays, gains
    and lengths equal to DeviceVoice's;
(b) execute_plan_torch with the bundle equals the run with DeviceVoice
    bit for bit;
(c) a bundle written by ctts_tpu.db.bundle.save_voice_bundle loads in
    the port with equal arrays, and the reverse; the two files hold the
    same arrays; save_voice_bundle is the JAX package's code;
(d) a bundle of another version or format raises, and with no device
    given the bundle goes to the card (raising without one).
"""

import inspect

import numpy as np
import pytest
import torch

from ctts_tpu_torch.config import config_defaults
from ctts_tpu_torch.db.bundle import VoiceBundle, save_voice_bundle
from ctts_tpu_torch.db.reader import VoiceDatabase
from ctts_tpu_torch.plan.compiler import compile_plan
from ctts_tpu_torch.synth.device import DeviceVoice, execute_plan_torch

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The suite runs in six workers on a few cores: a small intra-op
    pool keeps torch's many small CPU ops from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def db(voice_db):
    return VoiceDatabase(voice_db)


@pytest.fixture(scope="module")
def bundle_path(db, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bundle") / "voice_bundle.npz")
    save_voice_bundle(db, path)
    return path


@pytest.fixture(scope="module")
def voice(db):
    return DeviceVoice(db, device=CPU)


def test_bundle_roundtrip(db, bundle_path, voice):
    b = VoiceBundle(bundle_path, CPU)
    assert b.device == CPU and b.sample_rate == 22050
    assert b.target_rms == 3000.0
    assert b.bank.shape[0] == db.unit_count and b.ubuf % 128 == 0
    assert b.texts[0] == db.unit_text(0)
    assert b.max_unit_chars == db.max_unit_chars
    for name in ("bank", "lengths", "gains"):
        got, want = getattr(b, name), getattr(voice, name)
        assert got.dtype == want.dtype and torch.equal(got, want), name
    assert np.array_equal(b.lengths_np, voice.lengths_np)
    assert b.lengths_np.dtype == np.int32 and b.ubuf == voice.ubuf


@pytest.mark.parametrize("text,speed", [("como vai", 1.0),
                                        ("que legal!", 1.0),
                                        ("a rosa azul", 1.5)])
def test_bundle_executes_bit_equal(db, bundle_path, voice, text, speed):
    plan = compile_plan(db, text, config_defaults(), None, speed)
    got = execute_plan_torch(plan, db, VoiceBundle(bundle_path, CPU))
    want = execute_plan_torch(plan, db, voice)
    assert got.dtype == np.int16 and np.array_equal(got, want)


def test_bundles_load_across_packages(voice_db, bundle_path, tmp_path):
    from ctts_tpu.db import bundle as jax_bundle
    from ctts_tpu.db.reader import VoiceDatabase as JDB

    jpath = str(tmp_path / "jax_bundle.npz")
    jax_bundle.save_voice_bundle(JDB(voice_db), jpath)
    with np.load(jpath, allow_pickle=True) as a, \
            np.load(bundle_path, allow_pickle=True) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            assert np.array_equal(a[k], b[k]), k

    port = VoiceBundle(jpath, CPU)
    jax = jax_bundle.VoiceBundle(bundle_path)
    for name in ("bank", "lengths", "gains"):
        assert np.array_equal(getattr(port, name).numpy(),
                              np.asarray(getattr(jax, name))), name
    assert port.texts == jax.texts and port.ubuf == jax.ubuf
    assert inspect.getsource(save_voice_bundle) == \
        inspect.getsource(jax_bundle.save_voice_bundle)


def test_bundle_refusals(bundle_path, tmp_path):
    with np.load(bundle_path, allow_pickle=True) as z:
        fields = {k: z[k] for k in z.files}
    for key, value in (("bundle_version", 2), ("magic", 0),
                       ("db_version", 99)):
        path = str(tmp_path / f"bad_{key}.npz")
        np.savez(path, **dict(fields, **{key: value}))
        with pytest.raises(ValueError, match="mismatch"):
            VoiceBundle(path, CPU)
    if torch.cuda.is_available():
        assert VoiceBundle(bundle_path).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            VoiceBundle(bundle_path)
