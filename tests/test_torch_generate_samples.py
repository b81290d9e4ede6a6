"""tools/torch_generate_samples.py, the port's demo-page generator, on
the CPU: four corpus entries (one of them stretched) through its torch
executor (--device=cpu) and its oracle executor, each WAV within 2 LSB
of execute_plan_oracle with the oracle's length and listed on the page;
an executor that fails makes the tool fail, with no fallback."""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ctts_tpu_torch.config import config_defaults
from ctts_tpu_torch.db.reader import VoiceDatabase
from ctts_tpu_torch.plan.compiler import compile_plan
from ctts_tpu_torch.synth.oracle import execute_plan_oracle
from ctts_tpu_torch.utils.wav import read_wav

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(REPO, "tools", "torch_generate_samples.py")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tool(monkeypatch, tmp_path):
    """The tool's module, its CORPUS cut to four entries (two at speed
    1.0, one stretched, one at another section's start), run in an
    empty directory (defaults for config.yaml and normalization.csv)."""
    spec = importlib.util.spec_from_file_location("torch_generate_samples",
                                                  TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    picked = [mod.CORPUS[i] for i in (0, 10, 20, 97)]
    assert any(speed != 1.0 for _, _, speed in picked)
    monkeypatch.setattr(mod, "CORPUS", picked)
    monkeypatch.chdir(tmp_path)
    return mod


@pytest.mark.parametrize("flags", [["--executor=torch", "--device=cpu"],
                                   ["--executor=oracle"]],
                         ids=["torch-cpu", "oracle"])
def test_wavs_held_to_oracle(tool, voice_db, tmp_path, flags):
    out = tmp_path / "samples"
    assert tool.main(["torch_generate_samples.py", voice_db, str(out)]
                     + flags) == 0
    db = VoiceDatabase(voice_db)
    page = (out / "index.html").read_text(encoding="utf-8")
    assert "ctts_tpu_torch" in page
    for fname, text, speed in tool.CORPUS:
        got = read_wav(str(out / "audio" / fname))
        ref = execute_plan_oracle(compile_plan(
            db, text, config_defaults(), None, tool.corpus_speed(speed)), db)
        assert got.shape == ref.shape, fname
        assert np.abs(got.astype(np.int32)
                      - ref.astype(np.int32)).max(initial=0) <= 2, fname
        assert f'src="audio/{fname}"' in page
    assert page.count("<audio") == len(tool.CORPUS)


def test_failed_native_engine_raises(tool, voice_db, tmp_path, monkeypatch):
    """A native engine that cannot start fails the tool; no WAV, no page
    and no other executor's output."""
    from ctts_tpu_torch.runtime import native

    def broken(path):
        raise OSError(f"make failed for {path}")

    monkeypatch.setattr(native, "NativeEngine", broken)
    out = tmp_path / "samples"
    with pytest.raises(OSError, match="make failed"):
        tool.main(["torch_generate_samples.py", voice_db, str(out),
                   "--executor=native"])
    assert not out.exists()


def test_bad_voice_path_exits_nonzero(tmp_path):
    out = tmp_path / "samples"
    r = subprocess.run(
        [sys.executable, TOOL, str(tmp_path / "missing.db"), str(out),
         "--executor=native"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode != 0
    assert not (out / "index.html").exists()
    assert "oracle" not in r.stdout


def test_unknown_flag_value_exits_nonzero(tool, voice_db, capsys):
    assert tool.main(["torch_generate_samples.py", voice_db,
                      "--executor=jax"]) == 1
    assert "--executor=torch|native|oracle" in capsys.readouterr().err
