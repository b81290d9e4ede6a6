"""The port's entry points on the CPU: ctts_tpu_torch.cli (analogs of
tests/test_cli.py, run in-process through main), CTTSEngine, the native
runtime binding and the stage timer.

(a) build, then synth with --executor=torch --device=cpu: the WAV is
    within 2 LSB of `python -m ctts_tpu.cli ... --executor=oracle`,
    lengths equal; speed clamps, the config's default_speed, a missing
    db and the usage text as in the JAX CLI;
(b) with no --device the torch executor runs on the card: without one
    it raises, it never runs on the CPU instead;
(c) --executor=native gives the oracle's samples within 2 LSB, and
    raises with make's output when the runtime cannot be built (no
    fall-through to the oracle); the port's NativeEngine is bit-equal
    to ctts_tpu's on tests/test_native.py's CASES;
(d) CTTSEngine(executor="torch", device=cpu): synthesize and
    synthesize_batch within 2 LSB of the oracle;
(e) StageTimer's report, and a profiler's Chrome trace holding its
    stages as ctts:: spans (utils/timing.py; its device_trace went: a
    profiler records the port's spans).
"""

import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ctts_tpu_torch.cli import main
from ctts_tpu_torch.config import config_defaults
from ctts_tpu_torch.db.reader import VoiceDatabase
from ctts_tpu_torch.plan.compiler import compile_plan
from ctts_tpu_torch.synth.oracle import execute_plan_oracle
from ctts_tpu_torch.utils.wav import read_wav
from test_native import CASES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
TORCH_CPU = ["--executor=torch", "--device=cpu"]


def _max_diff(a, b):
    assert a.shape == b.shape
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max(initial=0))


def _jax_cli(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, "-m", "ctts_tpu.cli"] + args,
                          capture_output=True, cwd=cwd, env=env, text=True)


def _synth(db, text, wav, *extra):
    return main(["ctts", "synth", db, text, wav, *extra])


@pytest.mark.parametrize("text,speed", [("olá mundo", "1.0"),
                                        ("o brasil é bonito", "0.5")])
def test_cli_build_and_synth_match_jax_cli(dataset_dir, tmp_path,
                                           monkeypatch, capsys, text,
                                           speed):
    monkeypatch.chdir(tmp_path)
    assert main(["ctts", "build", dataset_dir, "voice.db"]) == 0
    assert "Database written" in capsys.readouterr().out

    assert _synth("voice.db", text, "out.wav", speed, *TORCH_CPU) == 0
    assert "Units found:" in capsys.readouterr().out
    r = _jax_cli(["synth", "voice.db", text, "ref.wav", speed,
                  "--executor=oracle"], tmp_path)
    assert r.returncode == 0, r.stderr
    got = read_wav(str(tmp_path / "out.wav"))
    assert got.shape[0] > 22050 // 2
    assert _max_diff(got, read_wav(str(tmp_path / "ref.wav"))) <= 2


def test_cli_speed_clamps(voice_db, tmp_path, monkeypatch):
    # Beyond the limits the speed clamps (ctts.c:3979-3981); garbage
    # parses as 0.0 and clamps to 0.5.
    monkeypatch.chdir(tmp_path)
    assert _synth(voice_db, "oi", "a.wav", "9.0", *TORCH_CPU) == 0
    assert _synth(voice_db, "oi", "b.wav", "abc", *TORCH_CPU) == 0
    a = read_wav(str(tmp_path / "a.wav"))   # 2.0x
    b = read_wav(str(tmp_path / "b.wav"))   # 0.5x
    assert b.shape[0] > 2.5 * a.shape[0]


def test_cli_default_speed_and_timing_from_config(voice_db, tmp_path,
                                                  monkeypatch):
    from ctts_tpu_torch.utils.timing import StageTimer

    monkeypatch.chdir(tmp_path)
    # report() binds sys.stderr when its module is imported.
    report = io.StringIO()
    monkeypatch.setattr(StageTimer.report, "__defaults__", (report,))
    (tmp_path / "config.yaml").write_text(
        "default_speed: 2.0\nprint_timing: true\n")
    assert _synth(voice_db, "como vai", "c.wav", *TORCH_CPU) == 0
    assert "Timing:" in report.getvalue()
    assert "execute (torch)" in report.getvalue()
    # A CLI speed overrides the config default (ctts.c:3993-3995).
    assert _synth(voice_db, "como vai", "d.wav", "1.0", *TORCH_CPU) == 0
    c = read_wav(str(tmp_path / "c.wav"))
    d = read_wav(str(tmp_path / "d.wav"))
    assert d.shape[0] > 1.5 * c.shape[0]


def test_cli_missing_db(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert _synth("missing.db", "oi", "x.wav", *TORCH_CPU) == 1
    assert "Failed to load database" in capsys.readouterr().err


def test_cli_usage(capsys):
    assert main(["ctts"]) == 1
    assert "Usage" in capsys.readouterr().err
    assert main(["ctts", "synth", "a.db", "oi", "x.wav",
                 "--executor=jax"]) == 1
    assert "Unknown --executor" in capsys.readouterr().err


def test_cli_runs_on_the_card_by_default(voice_db, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    if torch.cuda.is_available():
        assert _synth(voice_db, "oi", "x.wav") == 0
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _synth(voice_db, "oi", "x.wav")
        assert not (tmp_path / "x.wav").exists()


def test_cli_native_matches_oracle(voice_db, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    text = "bom dia. como vai. tudo bem."
    assert _synth(voice_db, text, "n.wav", "--executor=native") == 0
    db = VoiceDatabase(voice_db)
    ref = execute_plan_oracle(
        compile_plan(db, text, config_defaults(), None, 1.0), db)
    assert _max_diff(read_wav(str(tmp_path / "n.wav")), ref) <= 2


def test_cli_native_fails_loudly(voice_db, tmp_path, monkeypatch):
    """A runtime that cannot be built raises with make's output; the
    CLI writes nothing and never runs the oracle instead."""
    from ctts_tpu_torch.runtime import native

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_BUILD_ATTEMPTS", 1)
    monkeypatch.setattr(native, "_SO",
                        str(tmp_path / "empty" / "libctts_native.so"))
    (tmp_path / "empty").mkdir()
    with pytest.raises(RuntimeError, match="make libctts_native.so: rc"):
        _synth(voice_db, "oi", "n.wav", "--executor=native")
    assert not (tmp_path / "n.wav").exists()


@pytest.mark.parametrize("text,speed", CASES)
def test_native_engine_equals_jax(voice_db, text, speed):
    from ctts_tpu.config import config_defaults as j_config
    from ctts_tpu.db.reader import VoiceDatabase as JDB
    from ctts_tpu.plan.compiler import compile_plan as j_compile
    from ctts_tpu.runtime.native import NativeEngine as JNative
    from ctts_tpu_torch.runtime.native import NativeEngine

    jdb = JDB(voice_db)
    tdb = VoiceDatabase(voice_db)
    eng, jeng = NativeEngine(voice_db), JNative(voice_db)
    try:
        assert eng.unit_count == jeng.unit_count == tdb.unit_count
        got = eng.execute(compile_plan(tdb, text, config_defaults(), None,
                                       speed))
        want = jeng.execute(j_compile(jdb, text, j_config(), None, speed))
        assert got.dtype == want.dtype == np.int16
        assert np.array_equal(got, want)
    finally:
        eng.close()
        jeng.close()


def test_engine_torch_matches_oracle(voice_db):
    from ctts_tpu_torch.models.engine import CTTSEngine

    eng = CTTSEngine(voice_db, executor="torch", device=CPU)
    texts = ["como vai", "que legal!", "bom dia. tudo bem."]
    try:
        refs = {s: [execute_plan_oracle(
                    compile_plan(eng.db, t, eng.config, None, s), eng.db)
                    for t in texts] for s in (1.0, 1.5)}
        got = eng.synthesize(texts[0])
        assert got.dtype == np.int16
        assert _max_diff(got, refs[1.0][0]) <= 2
        assert eng.units_found > 0 and eng.units_missing == 0
        for s in (1.0, 1.5):
            outs = eng.synthesize_batch(texts, speed=s)
            assert len(outs) == len(texts)
            for t, o, w in zip(texts, outs, refs[s]):
                assert _max_diff(o, w) <= 2, (t, s)
        assert eng._batcher.device == CPU and not eng._batcher.wire
    finally:
        eng.close()


def test_engine_oracle_setters_and_rejects(voice_db):
    from ctts_tpu_torch.models.engine import CTTSEngine
    from ctts_tpu_torch.parallel.mesh import make_mesh

    with pytest.raises(TypeError):
        CTTSEngine(voice_db, mesh=object())
    with pytest.raises(ValueError, match="not both"):
        CTTSEngine(voice_db, device=CPU, mesh=make_mesh([CPU]))
    with pytest.raises(ValueError):
        CTTSEngine(voice_db, executor="jax")
    eng = CTTSEngine(voice_db, executor="oracle")
    try:
        eng.set_word_pause(60.0)
        eng.set_crossfade(10.0)
        eng.set_unknown_silence(50.0)
        eng.set_fades(5.0, 8.0)
        cfg = eng.config
        assert (cfg.word_pause_ms, cfg.crossfade_ms, cfg.unknown_silence_ms,
                cfg.fade_in_ms, cfg.fade_out_ms) == (60.0, 10.0, 50.0,
                                                     5.0, 8.0)
        text = "eu quero café, pão"
        want = execute_plan_oracle(
            compile_plan(eng.db, text, cfg, None, 1.0), eng.db)
        assert np.array_equal(eng.synthesize(text), want)
    finally:
        eng.close()


def test_stage_timer_and_device_trace(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    from ctts_tpu_torch.utils import timing
    from ctts_tpu_torch.utils.timing import StageTimer

    timer = StageTimer()
    with timer.stage("one"):
        pass
    out = io.StringIO()
    timer.report(file=out)
    assert "one" in out.getvalue() and "total" in out.getvalue()
    off = StageTimer(enabled=False)
    with off.stage("x"):
        pass
    assert off.stages == []

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timer.stage("two"):
            torch.ones(64).sum()
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    assert os.path.getsize(tmp_path / "trace.json") > 0
    assert "ctts::cli.stage" in (tmp_path / "trace.json").read_text()
    assert not timing.recording()
    timing.reset()
