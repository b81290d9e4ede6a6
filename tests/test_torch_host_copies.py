"""The port's copies of ctts_tpu's host modules against their originals.

ctts_tpu_torch keeps its own copies of the numpy-only host layers (text,
plan compiler and splitter, db format/reader/builder/dataset, the NumPy
oracle, the native runtime) so that it imports nothing of ctts_tpu.
Each copy is the original with only the package name changed; here
they are held to the originals on the CPU:
(a) the source of every copy is the original's, up to the package name,
    the docstring line that names the original, and the C reference,
    which the copies cite by its relative path (reference/...);
(b) compile_plan gives field-equal plans on bench.py's texts and the
    texts of tests/test_device_executor.py, at speeds 1.0 and 1.5;
(c) generate_dataset writes the same files, and build_database builds a
    byte-equal voice.db from them;
(d) execute_plan_oracle gives equal int16 audio at 1.0, 0.5 and 1.5.
(The native runtime copy is held to ctts_tpu's library by
tests/test_torch_plan_arrays.py::test_native_lowerer_equal.)
"""

import dataclasses
import filecmp
import os
import re

import numpy as np
import pytest

from bench import TEXTS as BENCH_TEXTS
from ctts_tpu.config import config_defaults as j_config
from ctts_tpu.db.reader import VoiceDatabase as JDB
from ctts_tpu.plan.compiler import compile_plan as j_compile
from ctts_tpu.synth.oracle import execute_plan_oracle as j_oracle
from ctts_tpu_torch.config import config_defaults as t_config
from ctts_tpu_torch.db.reader import VoiceDatabase as TDB
from ctts_tpu_torch.plan.compiler import compile_plan as t_compile
from ctts_tpu_torch.synth.oracle import execute_plan_oracle as t_oracle

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COPIES = """constants.py config.py utils/textutil.py utils/wav.py
db/format.py db/reader.py db/builder.py db/dataset.py
text/numbers.py text/rules.py text/normalize.py text/phonology.py
text/prosody.py plan/select.py plan/compiler.py plan/split.py
synth/dsp_np.py synth/oracle.py utils/errors.py text/duration_rules.py
testing/corpus.py""".split()
RUNTIME = ["Makefile", "csrc/ctts_native.cpp", "csrc/ctts_capi.cpp",
           "csrc/ctn_api.h", "include/ctts.h"]
# tests/test_device_executor.py::CASES texts.
CASE_TEXTS = ["como vai", "que legal!", "como se chama?",
              "bom dia. tudo bem.", "oi xz oi", "a rosa azul"]


@pytest.fixture(scope="module")
def dbs(voice_db):
    return JDB(voice_db), TDB(voice_db)


def _same(a, b, path="plan"):
    """Field-by-field equality of two plans from the two packages."""
    if dataclasses.is_dataclass(a):
        assert dataclasses.is_dataclass(b), path
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b), path
    else:
        assert type(a).__name__ == type(b).__name__ and a == b, path


def _relative_reference(text: str) -> str:
    """The originals cite the C reference by an absolute directory
    ending in /reference; the copies by the relative reference/."""
    return re.sub(r"(?<![\w/])/[\w/]*/reference\b", "reference", text)


def _read(*parts) -> str:
    with open(os.path.join(REPO, *parts)) as f:
        return f.read()


@pytest.mark.parametrize("rel", COPIES)
def test_copy_is_verbatim(rel):
    orig, copy = _read("ctts_tpu", rel), _read("ctts_tpu_torch", rel)
    note = (f"\nCopy of ctts_tpu/{rel} for the PyTorch port: only the "
            "package\nname in its imports and module references differs, "
            "and the C\nreference is cited by its relative path.\n")
    assert note in copy
    assert "ctts_tpu." not in copy.replace("ctts_tpu_torch.", "")
    want = re.sub(r"\bctts_tpu\.(?=[a-z_])", "ctts_tpu_torch.",
                  _relative_reference(orig))
    assert copy.replace(note, "", 1) == want


@pytest.mark.parametrize("rel", RUNTIME)
def test_runtime_copy_is_verbatim(rel):
    assert _read("ctts_tpu_torch", "runtime", rel) == \
        _relative_reference(_read("ctts_tpu", "runtime", rel))


@pytest.mark.parametrize("speed", [1.0, 1.5])
def test_compile_plan_equal(dbs, speed):
    jdb, tdb = dbs
    for text in BENCH_TEXTS + CASE_TEXTS:
        _same(j_compile(jdb, text, j_config(), None, speed),
              t_compile(tdb, text, t_config(), None, speed), text)


def test_dataset_and_database_byte_equal(tmp_path, dataset_dir, voice_db):
    from ctts_tpu_torch.db.builder import build_database
    from ctts_tpu_torch.db.dataset import generate_dataset

    root = tmp_path / "dataset"
    generate_dataset(str(root))
    n = 0
    for dirpath, _, files in os.walk(dataset_dir):
        rel = os.path.relpath(dirpath, dataset_dir)
        for name in files:
            assert filecmp.cmp(os.path.join(dirpath, name),
                               os.path.join(root, rel, name),
                               shallow=False), os.path.join(rel, name)
            n += 1
    assert n > 100
    out = tmp_path / "voice.db"
    build_database(str(root / "letters" / "wavs"),
                   str(root / "letters" / "letters.txt"),
                   str(root / "syllables" / "wavs"),
                   str(root / "syllables" / "sillabes.txt"),
                   str(out), verbose=False)
    assert filecmp.cmp(str(out), voice_db, shallow=False)


@pytest.mark.parametrize("speed", [1.0, 0.5, 1.5])
def test_oracle_equal(dbs, speed):
    jdb, tdb = dbs
    for text in CASE_TEXTS:
        want = j_oracle(j_compile(jdb, text, j_config(), None, speed), jdb)
        got = t_oracle(t_compile(tdb, text, t_config(), None, speed), tdb)
        assert got.dtype == want.dtype == np.int16, text
        assert np.array_equal(got, want), text
