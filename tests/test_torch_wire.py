"""The port's wire codec (ctts_tpu_torch/ops/wire.py) and the wire
branch of its BatchSynthesizer against ctts_tpu, on the CPU.

(a) encode on the same int16 buffers as ctts_tpu.ops.wire.encode_device
    (tests/test_wire.py's signal families, a buffer at the int16
    extremes whose words have byte 3 both at 255 and at 0, and a
    length that is padded to the block): equal classes and an equal
    valid word prefix for several valid lengths; decode_np and
    decode_host give the input back; wire_valid_words equals JAX's.
(b) decode_host raises on a class outside 1..5 and on too few words;
    it never falls back to another decoder.
(c) BatchSynthesizer(wire=True) equals wire=False bit for bit through
    synthesize and a 2-batch stream, also when the packed buffer needs
    the pad; the default is off on the CPU and wire=True turns it on.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctts_tpu.ops import wire as jwire
from ctts_tpu_torch.ops import wire as twire
from test_wire import _signals

CPU = torch.device("cpu")
K = twire.WIRE_BLOCK
TEXTS = ["como vai", "que legal!", "bom dia. tudo bem.", "a rosa"]


def _extremes():
    """Random int16 extremes (5-plane blocks) beside a block of zeros and
    one of -1, 0, 1 (1-plane blocks)."""
    rng = np.random.default_rng(11)
    x = rng.choice(np.array([-32768, 32767, -1, 0, 1], np.int16), 6 * K)
    x[2 * K:3 * K] = 0
    x[4 * K:5 * K] = rng.integers(-1, 2, K)
    return x


def _buffers():
    bufs = dict(_signals())
    bufs["extremes"] = _extremes()
    # 1000 samples: padded to 1024 before encoding.
    bufs["padded"] = np.cumsum(np.random.default_rng(5).integers(
        -300, 301, 1000)).astype(np.int16)
    return bufs


def _pad(x):
    out = np.zeros(-(-len(x) // K) * K, np.int16)
    out[:len(x)] = x
    return out


@pytest.mark.parametrize("name", list(_buffers().keys()))
def test_encode_matches_jax(name):
    x = _buffers()[name]
    xp = _pad(x)
    jw, jc = map(np.asarray, jwire.encode_device(jnp.asarray(xp)))
    tw, tc = twire.encode(torch.from_numpy(xp))
    assert tw.dtype == tc.dtype == torch.int32
    tw, tc = tw.numpy(), tc.numpy()
    assert np.array_equal(tc, jc)
    assert tc.min() >= 1 and tc.max() <= 5
    for n in sorted({0, 1, K - 1, K, len(x) // 2, len(x) - 1, len(x),
                     len(xp)}):
        need = twire.wire_valid_words(tc, n)
        assert need == jwire.wire_valid_words(jc, n)
        assert np.array_equal(tw[:need], jw[:need]), n
        for dec in (twire.decode_np, twire.decode_host):
            got = dec(tw[:need].copy(), tc, n)
            assert got.dtype == np.int16
            assert np.array_equal(got, xp[:n]), (n, dec.__name__)
    if name == "extremes":
        byte3 = tw[:twire.wire_valid_words(tc, len(x))].view(np.uint32) >> 24
        assert (byte3 == 255).any() and (byte3 == 0).any()
        assert set(tc.tolist()) >= {1, 5}


def test_encode_rejects_unpadded_length():
    with pytest.raises(ValueError):
        twire.encode(torch.zeros(K + 3, dtype=torch.int16))
    with pytest.raises(ValueError):
        twire.encode(torch.zeros(K, dtype=torch.int32))


def test_wire_valid_words_matches_jax():
    rng = np.random.default_rng(2)
    classes = rng.integers(1, 6, 40).astype(np.int32)
    for n in (0, 1, K, K + 1, 17 * K - 5, 40 * K):
        assert twire.wire_valid_words(classes, n) == \
            jwire.wire_valid_words(classes, n)


def test_decode_host_raises():
    wire = np.zeros(twire.WIRE_CHUNK_W * 7, np.int32)
    with pytest.raises(ValueError, match="outside 1..5"):
        twire.decode_host(wire, np.array([7], np.int32), K)
    with pytest.raises(ValueError, match="outside 1..5"):
        twire.decode_host(wire, np.array([0, 1], np.int32), K + 1)
    with pytest.raises(ValueError, match="words"):
        twire.decode_host(wire[:10], np.array([1], np.int32), K)


@pytest.fixture(scope="module")
def pair(voice_db):
    from ctts_tpu_torch.config import config_defaults
    from ctts_tpu_torch.db.reader import VoiceDatabase
    from ctts_tpu_torch.parallel.batch import BatchSynthesizer

    db = VoiceDatabase(voice_db)
    plain = BatchSynthesizer(db, config_defaults(), device=CPU, wire=False)
    wired = BatchSynthesizer(db, config_defaults(), device=CPU, wire=True)
    assert wired.wire and not plain.wire
    return plain, wired, plain.synthesize(TEXTS)


def test_wire_serving_matches_plain(pair):
    plain, wired, want = pair
    got = wired.synthesize(TEXTS)
    for t, w, g in zip(TEXTS, want, got):
        assert g.dtype == np.int16 and np.array_equal(w, g), t
    outs = list(wired.stream(iter([TEXTS[:2], TEXTS[2:]])))
    assert len(outs) == 2
    for w, g in zip(want, outs[0] + outs[1]):
        assert np.array_equal(w, g)


def test_wire_serving_pads_packed_buffer(pair, monkeypatch):
    """A packed buffer whose length is not a multiple of the block is
    padded before encoding; the samples stay equal. The serving path
    packs inside the compiled batch core (synth/compiled.py), on the
    CPU through pack_encode's plain version (ops/hopper/pack_encode.py),
    which calls pack_rows."""
    from ctts_tpu_torch.ops.hopper import pack_encode as batch

    plain, wired, want = pair
    lengths = []
    pack = batch.pack_rows

    def short(out, out_lens):
        p = pack(out, out_lens)[:-100]
        lengths.append(p.shape[0])
        return p

    monkeypatch.setattr(batch, "pack_rows", short)
    got = wired.synthesize(TEXTS[:2])
    assert lengths and all(n % K for n in lengths)
    for t, w, g in zip(TEXTS, want, got):
        assert np.array_equal(w, g), t


def test_wire_default_and_override(voice_db):
    from ctts_tpu_torch.config import config_defaults
    from ctts_tpu_torch.db.reader import VoiceDatabase
    from ctts_tpu_torch.parallel.batch import BatchSynthesizer

    db = VoiceDatabase(voice_db)
    cfg = config_defaults()
    kw = dict(device=CPU, native_plans=False)
    assert not BatchSynthesizer(db, cfg, **kw).wire
    assert BatchSynthesizer(db, cfg, wire=True, **kw).wire
