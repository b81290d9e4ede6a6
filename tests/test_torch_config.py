"""The port held to the C reference across its configuration keys, on
the CPU.

Every case sets one config.yaml key (key: value) and synthesizes the
speed-1.0 texts of tests/test_device_executor.py::CASES at speeds 1.0
and 1.5 through the one-sentence path (execute_plan_torch) and the
serving path (BatchSynthesizer.synthesize, natively lowered at 1.0 and
lowered in Python at 1.5); each output is held to the port's NumPy
oracle (equal lengths, within 2 LSB, the bound test_device_executor.py
holds the JAX path to). The first five keys are the settings where the
JAX package departs from the C (ROADMAP Queue C): the port follows the
C there, or refuses the value at lowering with a ValueError that names
the key and its supported range (min_silence_ms under 10 samples). The
rest are settings both packages hold. Besides:
(a) the CLI with --config=config.yaml (remove_dc_offset: 0) against the
    same CLI's --executor=oracle;
(b) three holding settings against ctts_tpu's execute_plan_jax at 1.0
    (their buckets equal the default's, which test_device_executor.py
    compiles);
(c) fades that reach back over several regions, where the core runs its
    fade and silence-table stages more than once;
(d) crossfades longer than the unit bank is wide (the JAX package
    fails on the shapes there);
(e) the default configuration keeps every fade in its window on the
    bench texts (the default path runs no extra stage), and a sentence
    split is kept only where the fades stay inside its rows;
(f) settings that leave more than 32 kept segments in a region (a
    high silence_threshold with a short min_silence_ms): the rows whose
    silence tables overflow run again at a wider table, on every path
    (one sentence, the CLI, the served batch, execute, stream, a mesh
    split and synthesize_across_hosts), also where the fades reach over
    regions;
    a run that still overflows raises;
(g) the default configuration never overflows the 32-slot table on the
    bench texts and the corpus, so its batches never run again.
"""

import numpy as np
import pytest
import torch

from ctts_tpu_torch.config import config_defaults
from ctts_tpu_torch.db.reader import VoiceDatabase
from ctts_tpu_torch.plan.compiler import compile_plan
from ctts_tpu_torch.synth.oracle import execute_plan_oracle

CPU = torch.device("cpu")
TEXTS = ["como vai", "que legal!", "como se chama?", "bom dia. tudo bem.",
         "oi xz oi"]
# One bucket for the batch of TEXTS under every setting below.
FLOOR = {"U": 16, "R": 8, "FD": 4, "WREG": 32768, "SMAX": 65536,
         "CONTW": 16384, "WIN": 2048, "CFMAX": 1024}
FAULTS = [("remove_dc_offset", False), ("min_silence_ms", 0.0),
          ("fade_in_ms", 300.0), ("fade_out_ms", 400.0),
          ("word_pause_ms", 0.0)]
HOLDS = [("silence_threshold", 0.5), ("min_silence_ms", 2.0),
         ("crossfade_ms", 0.0), ("crossfade_vowel_ms", 120.0),
         ("vowel_to_consonant_factor", 0.0), ("unknown_silence_ms", 300.0),
         ("max_pitch_change", 0.5), ("remove_word_silence", False)]
REFUSED = {("min_silence_ms", 0.0)}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The suite runs in six workers on a few cores: a small intra-op
    pool keeps torch's many small CPU ops from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _drop_jax_executables():
    """The JAX references of test_holding_key_matches_jax share their
    compiled cores; drop them when the module is done (XLA:CPU crashes
    once many large cores stay resident in one process)."""
    yield
    import jax

    jax.clear_caches()


@pytest.fixture(scope="module")
def db(voice_db):
    return VoiceDatabase(voice_db)


@pytest.fixture(scope="module")
def voice(db):
    from ctts_tpu_torch.synth.device import DeviceVoice

    return DeviceVoice(db, device=CPU)


def _config(**keys):
    cfg = config_defaults()
    for k, v in keys.items():
        setattr(cfg, k, v)
    return cfg


def _held(got, ref, what):
    assert got.dtype == np.int16 and got.shape == ref.shape, \
        f"{what}: length {got.shape} vs oracle {ref.shape}"
    d = int(np.abs(got.astype(np.int32) - ref.astype(np.int32)).max(
        initial=0))
    assert d <= 2, f"{what}: max |diff| {d} LSB vs the oracle"


def _case_id(kv):
    return f"{kv[0]}={kv[1]}"


@pytest.mark.parametrize("speed", [1.0, 1.5])
@pytest.mark.parametrize("kv", FAULTS + HOLDS, ids=_case_id)
def test_config_key_held_to_oracle(db, voice, kv, speed):
    from ctts_tpu_torch.parallel.batch import BatchSynthesizer
    from ctts_tpu_torch.synth.device import execute_plan_torch

    key, value = kv
    cfg = _config(**{key: value})
    plans = [compile_plan(db, t, cfg, None, speed) for t in TEXTS]
    native = speed == 1.0
    if kv in REFUSED:
        for call in (lambda: execute_plan_torch(plans[0], db, voice),
                     lambda: BatchSynthesizer(db, cfg, device=CPU,
                                              native_plans=native)):
            with pytest.raises(ValueError, match=rf"{key}: {value} .*"
                               r"min_silence_ms >= 0\.4536"):
                call()
        return
    refs = [execute_plan_oracle(p, db) for p in plans]
    for text, plan, ref in zip(TEXTS, plans, refs):
        _held(execute_plan_torch(plan, db, voice), ref,
              f"{key}={value} {text!r} at {speed}, one sentence")
    bs = BatchSynthesizer(db, cfg, device=CPU, dims_floor=FLOOR,
                          native_plans=native)
    for text, got, ref in zip(TEXTS, bs.synthesize(TEXTS, speed), refs):
        _held(got, ref, f"{key}={value} {text!r} at {speed}, batch")


def test_min_silence_unused_without_silence_removal(db, voice):
    """min_silence_ms 0 is refused only where silence removal reads it."""
    from ctts_tpu_torch.synth.device import execute_plan_torch

    cfg = _config(min_silence_ms=0.0, remove_word_silence=False)
    for text in TEXTS[:2]:
        plan = compile_plan(db, text, cfg, None, 1.0)
        _held(execute_plan_torch(plan, db, voice),
              execute_plan_oracle(plan, db), text)


def test_refused_value_on_every_entry_point(voice_db, tmp_path, monkeypatch,
                                            capsys):
    """min_silence_ms: 0 is refused by the CLI's torch and native
    executors (a message, exit 1), CTTSEngine's two paths, NativeLowerer
    and NativeEngine; the oracle executor computes its own result."""
    from ctts_tpu_torch.cli import main
    from ctts_tpu_torch.models.engine import CTTSEngine
    from ctts_tpu_torch.plan.native_lower import NativeLowerer
    from ctts_tpu_torch.runtime import NativeEngine

    monkeypatch.chdir(tmp_path)
    (tmp_path / "config.yaml").write_text("min_silence_ms: 0\n")
    for executor in ("torch", "native"):
        assert main(["ctts", "synth", voice_db, "como vai", "out.wav",
                     "--config=config.yaml", f"--executor={executor}",
                     "--device=cpu"]) == 1
        assert "Config refused: min_silence_ms: 0.0" in \
            capsys.readouterr().err
    assert main(["ctts", "synth", voice_db, "como vai", "out.wav",
                 "--config=config.yaml", "--executor=oracle"]) == 0
    cfg = _config(min_silence_ms=0.0)
    eng = CTTSEngine(voice_db, config=cfg, device=CPU)
    plan = eng.compile("como vai")
    engine = NativeEngine(voice_db)
    try:
        for call in (lambda: eng.synthesize("como vai"),
                     lambda: eng.synthesize_batch(["como vai"]),
                     lambda: NativeLowerer(voice_db, cfg),
                     lambda: engine.execute(plan)):
            with pytest.raises(ValueError, match="min_silence_ms: 0.0"):
                call()
    finally:
        engine.close()
        eng.close()


@pytest.mark.parametrize("key,refused,held", [
    ("word_pause_ms", -50.0, -0.01), ("fade_in_ms", -10.0, -0.01),
    ("crossfade_ms", -10.0, -0.01),
    # crossfade_ms (20) times the factor: -0.02 ms truncates to 0 samples.
    ("vowel_to_consonant_factor", -1.0, -0.001)])
def test_negative_durations_refused(db, voice, key, refused, held):
    """A duration below 0 samples is undefined in the C (a negative float
    converted to size_t) and breaks the oracle: refused, naming the key.
    One that truncates to 0 samples is held."""
    from ctts_tpu_torch.synth.device import execute_plan_torch

    plan = compile_plan(db, "como vai", _config(**{key: refused}), None, 1.0)
    with pytest.raises(ValueError, match=rf"{key}: .* >= 0"):
        execute_plan_torch(plan, db, voice)
    plan = compile_plan(db, "como vai", _config(**{key: held}), None, 1.0)
    _held(execute_plan_torch(plan, db, voice),
          execute_plan_oracle(plan, db), f"{key}={held}")


def test_cli_config_file(voice_db, tmp_path, monkeypatch):
    from ctts_tpu_torch.cli import main
    from ctts_tpu_torch.utils.wav import read_wav

    monkeypatch.chdir(tmp_path)
    (tmp_path / "config.yaml").write_text(
        "audio:\n  remove_dc_offset: 0\n")
    for wav, executor in (("out.wav", ["--executor=torch", "--device=cpu"]),
                          ("ref.wav", ["--executor=oracle"])):
        assert main(["ctts", "synth", voice_db, "que legal!", wav,
                     "--config=config.yaml", *executor]) == 0
    got, ref = read_wav("out.wav"), read_wav("ref.wav")
    _held(got, ref, "cli")
    plan = compile_plan(VoiceDatabase(voice_db), "que legal!", _config(),
                        None, 1.0)
    default = execute_plan_oracle(plan, VoiceDatabase(voice_db))
    assert not np.array_equal(ref, default)    # the key was read


@pytest.mark.parametrize("kv", [("silence_threshold", 0.2),
                                ("silence_threshold", 0.5),
                                ("remove_word_silence", False)],
                         ids=_case_id)
def test_holding_key_matches_jax(db, voice, kv):
    from ctts_tpu.config import config_defaults as j_config
    from ctts_tpu.plan.compiler import compile_plan as j_compile
    from ctts_tpu.synth.device import DeviceVoice as JVoice
    from ctts_tpu.synth.device import execute_plan_jax
    from ctts_tpu_torch.synth.device import execute_plan_torch

    jv = JVoice(db)
    jcfg = j_config()
    setattr(jcfg, *kv)
    for text in TEXTS[:2]:
        want = execute_plan_jax(j_compile(db, text, jcfg, None, 1.0), db, jv)
        plan = compile_plan(db, text, _config(**dict([kv])), None, 1.0)
        _held(execute_plan_torch(plan, db, voice), want,
              f"{kv} {text!r} vs execute_plan_jax")


@pytest.mark.parametrize("fade_out_ms,word_pause_ms",
                         [(3000.0, 5.0), (1000.0, 0.0)])
def test_fades_reaching_over_regions(db, voice, fade_out_ms, word_pause_ms):
    """Fades longer than the audio before them, through several regions
    and punctuation pauses; some rows need more than one pass."""
    from ctts_tpu_torch.synth import plan_arrays
    from ctts_tpu_torch.synth.device import execute_plan_torch, lower_sentence

    cfg = _config(fade_out_ms=fade_out_ms, word_pause_ms=word_pause_ms)
    passes = []
    for text in ["e, a; o: u!", "oi, tudo bem? sim!", "a ,b", "!oi",
                 "a. b. c."]:
        plan = compile_plan(db, text, cfg, None, 1.0)
        dims, arrays, _ = lower_sentence(plan, db, voice)
        passes.append(plan_arrays.fade_passes(dims, arrays))
        _held(execute_plan_torch(plan, db, voice),
              execute_plan_oracle(plan, db), f"{text!r} {fade_out_ms}")
    assert max(passes) >= 2, passes


@pytest.mark.parametrize("kv", [("crossfade_ms", 200.0),
                                ("crossfade_vowel_ms", 400.0)],
                         ids=_case_id)
def test_crossfade_wider_than_the_bank(db, voice, kv):
    """A crossfade over ~186 ms rounds CFMAX up past the bank's 7168
    columns; the core pads the bank (a crossfade is cut to its unit)."""
    from ctts_tpu_torch.parallel.batch import BatchSynthesizer
    from ctts_tpu_torch.synth.device import execute_plan_torch, lower_sentence

    cfg = _config(**dict([kv]))
    texts = ["como vai", "que legal!"]
    plans = [compile_plan(db, t, cfg, None, 1.0) for t in texts]
    refs = [execute_plan_oracle(p, db) for p in plans]
    assert lower_sentence(plans[0], db, voice)[0].CFMAX > voice.ubuf
    for text, plan, ref in zip(texts, plans, refs):
        _held(execute_plan_torch(plan, db, voice), ref, f"{kv} {text!r}")
    bs = BatchSynthesizer(db, cfg, device=CPU)
    for text, got, ref in zip(texts, bs.synthesize(texts), refs):
        _held(got, ref, f"{kv} {text!r}, batch")


def test_default_fades_stay_in_their_windows(db, voice):
    from bench import TEXTS as BENCH_TEXTS
    from ctts_tpu_torch.synth import plan_arrays
    from ctts_tpu_torch.synth.device import lower_sentence

    cfg = config_defaults()
    for text in BENCH_TEXTS + TEXTS:
        dims, arrays, _ = lower_sentence(
            compile_plan(db, text, cfg, None, 1.0), db, voice)
        assert plan_arrays.fade_passes(dims, arrays) == 0, text
    assert plan_arrays.split_keeps_fades(cfg)
    assert not plan_arrays.split_keeps_fades(_config(word_pause_ms=0.0))
    assert not plan_arrays.split_keeps_fades(_config(fade_out_ms=400.0))
    assert plan_arrays.split_keeps_fades(_config(fade_out_ms=300.0))


# (silence_threshold, min_silence_ms): regions with more kept segments
# than the 32-slot silence table on TEXTS.
OVERFLOWS = [(0.5, 1.0), (0.5, 2.0), (0.3, 1.0)]


def _overflow_id(tm):
    return f"silence_threshold={tm[0]},min_silence_ms={tm[1]}"


def _widened():
    from ctts_tpu_torch.synth import compiled

    return sum(compiled.widened.values())


@pytest.mark.parametrize("speed", [1.0, 1.5])
@pytest.mark.parametrize("tm", OVERFLOWS, ids=_overflow_id)
def test_overflowing_tables_held_to_oracle(db, voice, tm, speed):
    """The one-sentence path and the served batch (natively lowered at
    1.0, in Python at 1.5) with regions past 32 kept segments: the
    oracle's lengths and samples, with rows run again on both paths."""
    from ctts_tpu_torch.parallel.batch import BatchSynthesizer
    from ctts_tpu_torch.synth.device import execute_plan_torch

    cfg = _config(silence_threshold=tm[0], min_silence_ms=tm[1])
    plans = [compile_plan(db, t, cfg, None, speed) for t in TEXTS]
    refs = [execute_plan_oracle(p, db) for p in plans]
    before = _widened()
    for text, plan, ref in zip(TEXTS, plans, refs):
        _held(execute_plan_torch(plan, db, voice), ref,
              f"{tm} {text!r} at {speed}, one sentence")
    mid = _widened()
    assert mid > before
    bs = BatchSynthesizer(db, cfg, device=CPU, dims_floor=FLOOR,
                          native_plans=speed == 1.0)
    for text, got, ref in zip(TEXTS, bs.synthesize(TEXTS, speed), refs):
        _held(got, ref, f"{tm} {text!r} at {speed}, batch")
    assert _widened() > mid


def test_known_overflow_lengths(db, voice):
    """The lengths the 32-slot table missed: 'a ,b' and 'como vai' at
    silence_threshold 0.5, min_silence_ms 1 (10213 and 15555 samples
    before the repair)."""
    from ctts_tpu_torch.synth.device import execute_plan_torch

    cfg = _config(silence_threshold=0.5, min_silence_ms=1.0)
    for text, n in (("a ,b", 9669), ("como vai", 8526)):
        plan = compile_plan(db, text, cfg, None, 1.0)
        ref = execute_plan_oracle(plan, db)
        assert ref.shape == (n,)
        _held(execute_plan_torch(plan, db, voice), ref, text)


def test_overflow_with_reaching_fades(db, voice):
    """Fades that reach back over regions (fade_passes >= 1) and silence
    tables that overflow: the core's repeated fade and table passes all
    run at the wider table."""
    from ctts_tpu_torch.parallel.batch import BatchSynthesizer
    from ctts_tpu_torch.synth import plan_arrays
    from ctts_tpu_torch.synth.device import execute_plan_torch, lower_sentence

    cfg = _config(silence_threshold=0.5, min_silence_ms=1.0,
                  fade_out_ms=1000.0, word_pause_ms=0.0)
    texts = ["a ,b", "como vai", "bom dia. tudo bem."]
    plans = [compile_plan(db, t, cfg, None, 1.0) for t in texts]
    refs = [execute_plan_oracle(p, db) for p in plans]
    passes = []
    before = _widened()
    for text, plan, ref in zip(texts, plans, refs):
        dims, arrays, _ = lower_sentence(plan, db, voice)
        passes.append(plan_arrays.fade_passes(dims, arrays))
        assert plan_arrays.seg_width(dims, arrays) > 32, text
        _held(execute_plan_torch(plan, db, voice), ref, f"{text!r}")
    assert min(passes) >= 1 and max(passes) >= 2, passes
    mid = _widened()
    assert mid >= before + len(texts)
    bs = BatchSynthesizer(db, cfg, device=CPU)
    for text, got, ref in zip(texts, bs.synthesize(texts), refs):
        _held(got, ref, f"{text!r}, batch")
    assert _widened() > mid


def test_overflow_on_every_batch_path(db, voice_db):
    """execute, stream (rows re-run in the trim, outputs yielded in
    order), a split over a mesh of two CPU shards, and
    synthesize_across_hosts in a one-process gloo group."""
    import socket

    import torch.distributed as dist

    from ctts_tpu_torch.parallel import make_mesh
    from ctts_tpu_torch.parallel.batch import BatchSynthesizer
    from ctts_tpu_torch.parallel.multihost import (
        initialize,
        synthesize_across_hosts,
    )

    cfg = _config(silence_threshold=0.5, min_silence_ms=1.0)
    plans = [compile_plan(db, t, cfg, None, 1.0) for t in TEXTS]
    refs = [execute_plan_oracle(p, db) for p in plans]
    bs = BatchSynthesizer(db, cfg, device=CPU, dims_floor=FLOOR)
    for text, got, ref in zip(TEXTS, bs.execute(plans), refs):
        _held(got, ref, f"{text!r}, execute")
    batches = [TEXTS[:3], TEXTS[3:], TEXTS[1:4]]
    for texts, outs in zip(batches, bs.stream(iter(batches))):
        for text, got in zip(texts, outs):
            _held(got, refs[TEXTS.index(text)], f"{text!r}, stream")
    split = BatchSynthesizer(db, cfg, mesh=make_mesh([CPU] * 2),
                             dims_floor=FLOOR)
    before = _widened()
    for text, got, ref in zip(TEXTS, split.synthesize(TEXTS), refs):
        _held(got, ref, f"{text!r}, split")
    assert _widened() > before
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    initialize(f"127.0.0.1:{port}", 1, 0, timeout_s=60.0)
    try:
        outs = synthesize_across_hosts(bs, TEXTS)
    finally:
        dist.destroy_process_group()
    for text, got, ref in zip(TEXTS, outs, refs):
        _held(got, ref, f"{text!r}, across hosts")


def test_cli_overflowing_config(voice_db, tmp_path, monkeypatch):
    """The CLI's one synth with a config.yaml whose regions overflow the
    32-slot table, against the same CLI's --executor=oracle."""
    from ctts_tpu_torch.cli import main
    from ctts_tpu_torch.utils.wav import read_wav

    monkeypatch.chdir(tmp_path)
    (tmp_path / "config.yaml").write_text(
        "silence_threshold: 0.5\nmin_silence_ms: 1\n")
    for wav, executor in (("out.wav", ["--executor=torch", "--device=cpu"]),
                          ("ref.wav", ["--executor=oracle"])):
        assert main(["ctts", "synth", voice_db, "como vai", wav,
                     "--config=config.yaml", *executor]) == 0
    ref = read_wav("ref.wav")
    assert ref.shape == (8526,)
    _held(read_wav("out.wav"), ref, "cli")


def test_a_rerun_that_overflows_raises(db, voice, monkeypatch):
    """Where the wider table still overflows (here: seg_width held at
    32), both paths raise; no path returns uncompacted audio."""
    from ctts_tpu_torch.parallel.batch import BatchSynthesizer
    from ctts_tpu_torch.synth import compiled
    from ctts_tpu_torch.synth.device import execute_plan_torch

    monkeypatch.setattr(compiled, "seg_width", lambda dims, arrays: 32)
    cfg = _config(silence_threshold=0.5, min_silence_ms=1.0)
    plan = compile_plan(db, "como vai", cfg, None, 1.0)
    with pytest.raises(RuntimeError, match="silence tables of 32 slots"):
        execute_plan_torch(plan, db, voice)
    bs = BatchSynthesizer(db, cfg, device=CPU)
    with pytest.raises(RuntimeError, match="silence tables of 32 slots"):
        bs.synthesize(["como vai", "que legal!"])


def test_default_config_never_widens(db, voice):
    """On the bench texts and the corpus at the default configuration,
    every region's kept segments fit the 32-slot table, so no row runs
    again. Checked without the core: silence_segments at its default
    width on the oracle's word buffers (the audio the core's tables
    read; the core equals the oracle there). The bound from the
    lowered region lengths alone (seg_width) passes 32 on some of these
    texts, which is why the first run does not take its width from it.
    Then one served batch of the texts with the highest bounds runs no
    row again."""
    from bench import TEXTS as BENCH_TEXTS
    from ctts_tpu_torch.ops import device_ops as tdops
    from ctts_tpu_torch.parallel.batch import BatchSynthesizer
    from ctts_tpu_torch.synth import dsp_np, oracle, plan_arrays
    from ctts_tpu_torch.synth.device import lower_sentence
    from ctts_tpu_torch.testing.corpus import CORPUS

    cfg = config_defaults()
    texts = list(BENCH_TEXTS) + [text for _, text, _ in CORPUS]
    found = []
    remove = dsp_np.remove_silence_regions

    def counted(samples, threshold, min_silence):
        _, seg_len, _, ovf = tdops.silence_segments(
            torch.as_tensor(samples.astype(np.float32))[None],
            torch.tensor([samples.shape[0]]), torch.tensor([threshold]),
            min_silence)
        found.append((int((seg_len > 0).sum()), bool(ovf[0])))
        return remove(samples, threshold, min_silence)

    widths = []
    for text in texts:
        plan = compile_plan(db, text, cfg, None, 1.0)
        dims, arrays, _ = lower_sentence(plan, db, voice)
        assert dims.min_silence_samples == 330
        widths.append(plan_arrays.seg_width(dims, arrays))
        dsp_np.remove_silence_regions = counted
        try:
            oracle.execute_plan_oracle(plan, db)
        finally:
            dsp_np.remove_silence_regions = remove
    assert len(found) > 500
    assert not any(ovf for _, ovf in found)
    assert max(n for n, _ in found) <= tdops.NBLK
    assert max(widths) > tdops.NBLK
    highest = [t for _, t in sorted(zip(widths, texts), reverse=True)[:6]]
    before = _widened()
    BatchSynthesizer(db, cfg, device=CPU).synthesize(highest)
    assert _widened() == before
