"""ctypes bindings for the C++ native runtime (libctts_native.so).

Counterpart of ctts_tpu/runtime/native.py: the native engine executes
SynthesisPlans with exact reference semantics at C speed (the CLI's
`native` executor), and the same library holds the wire codec's host
decoder (`ctn_wire_decode`, used by ops/wire.py). Built by `make` from
this package's own copy of the runtime at first use. Unlike the JAX
package's loader, a failed `make` or a missing or unloadable library
raises with make's output: no caller falls back to another executor.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import time

import numpy as np

from ctts_tpu_torch.plan.compiler import OpKind, SynthesisPlan

_SO = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "libctts_native.so")
_BUILD_ATTEMPTS = 3

_lib = None


def make_and_open(path: str) -> ctypes.CDLL:
    """make the library at `path` in its directory (dependency-checked:
    a no-op when current), then dlopen it. Another process may be
    writing the library at the same moment (a second test worker runs
    the same make), which shows as a failed make or an unloadable file;
    that is retried a few times, then raised with make's output."""
    where, target = os.path.split(path)
    for attempt in range(_BUILD_ATTEMPTS):
        r = subprocess.run(["make", "-C", where, target],
                           capture_output=True, text=True)
        err = f"make {target}: rc {r.returncode}\n{r.stdout}{r.stderr}"
        if r.returncode == 0:
            try:
                return ctypes.CDLL(path)
            except OSError as e:
                err += f"\nloading {path}: {e}"
        if attempt == _BUILD_ATTEMPTS - 1:
            raise RuntimeError(err)
        time.sleep(2.0)


class _CtnPlan(ctypes.Structure):
    _fields_ = [
        ("n_ops", ctypes.c_int32),
        ("kind", ctypes.POINTER(ctypes.c_int32)),
        ("arg0", ctypes.POINTER(ctypes.c_int32)),
        ("arg1", ctypes.POINTER(ctypes.c_int32)),
        ("flags", ctypes.POINTER(ctypes.c_int32)),
        ("speed", ctypes.c_float),
        ("target_rms", ctypes.c_float),
        ("silence_threshold", ctypes.c_float),
        ("max_pitch_change", ctypes.c_float),
        ("min_silence_samples", ctypes.c_int32),
        ("fade_in_samples", ctypes.c_int32),
        ("remove_dc_offset", ctypes.c_int32),
        ("remove_word_silence", ctypes.c_int32),
        ("word_count", ctypes.c_int32),
        ("phrase_type", ctypes.c_int32),
        ("pitch_start", ctypes.c_float),
        ("pitch_end", ctypes.c_float),
        ("pitch_peak", ctypes.c_float),
        ("peak_position", ctypes.c_float),
        ("energy_factor", ctypes.c_float),
    ]


def _load() -> ctypes.CDLL:
    """Build and load libctts_native.so once; raises on any failure."""
    global _lib
    if _lib is not None:
        return _lib
    lib = make_and_open(_SO)
    lib.ctn_db_open.restype = ctypes.c_void_p
    lib.ctn_db_open.argtypes = [ctypes.c_char_p]
    lib.ctn_db_close.restype = None
    lib.ctn_db_close.argtypes = [ctypes.c_void_p]
    lib.ctn_db_unit_count.restype = ctypes.c_uint32
    lib.ctn_db_unit_count.argtypes = [ctypes.c_void_p]
    lib.ctn_db_max_unit_chars.restype = ctypes.c_uint32
    lib.ctn_db_max_unit_chars.argtypes = [ctypes.c_void_p]
    lib.ctn_db_find_unit.restype = ctypes.c_int32
    lib.ctn_db_find_unit.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t
    ]
    lib.ctn_execute_plan.restype = ctypes.c_int64
    lib.ctn_execute_plan.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(_CtnPlan),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int16)),
    ]
    lib.ctn_free.restype = None
    lib.ctn_free.argtypes = [ctypes.POINTER(ctypes.c_int16)]
    # runtime/csrc/ctts_native.cpp: (wire words, classes, nblk, nsamples,
    # out) -> samples written, or -1 on a class outside 1..5.
    lib.ctn_wire_decode.restype = ctypes.c_int64
    lib.ctn_wire_decode.argtypes = [
        ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int16),
    ]
    _lib = lib
    return lib


def native_available() -> bool:
    """True once the library is built and loaded; raises when it cannot
    be (the JAX package's version returns False instead)."""
    return _load() is not None


def pack_plan(plan: SynthesisPlan) -> tuple:
    """Pack a SynthesisPlan into the flat arrays the C ABI consumes."""
    n = len(plan.ops)
    kind = np.zeros(n, np.int32)
    arg0 = np.zeros(n, np.int32)
    arg1 = np.zeros(n, np.int32)
    flags = np.zeros(n, np.int32)
    for i, op in enumerate(plan.ops):
        kind[i] = int(op.kind)
        if op.kind == OpKind.UNIT:
            arg0[i] = op.unit_idx
            arg1[i] = op.crossfade_samples
            flags[i] = (1 if op.after_word_boundary else 0) | (
                2 if op.smooth_boundary else 0
            )
        elif op.kind == OpKind.SILENCE:
            arg0[i] = op.n_samples
        elif op.kind == OpKind.WORD_DSP:
            arg0[i] = op.word_index
        elif op.kind == OpKind.FADE_TAIL:
            arg0[i] = op.fade_samples
    return kind, arg0, arg1, flags


class NativeEngine:
    """Native database handle + plan executor."""

    def __init__(self, database_file: str):
        self._db = None
        lib = _load()
        self._lib = lib
        self._db = lib.ctn_db_open(database_file.encode())
        if not self._db:
            raise RuntimeError(f"failed to open database {database_file}")

    @property
    def unit_count(self) -> int:
        return self._lib.ctn_db_unit_count(self._db)

    def find_unit(self, text: bytes) -> int:
        return self._lib.ctn_db_find_unit(self._db, text, len(text))

    def execute(self, plan: SynthesisPlan) -> np.ndarray:
        """The plan's samples; raises ValueError on a configuration the
        port refuses (synth/plan_arrays.check_config: there the engine's
        in-place silence removal writes past the word it reads)."""
        from ctts_tpu_torch.synth.plan_arrays import check_config

        check_config(plan.config)
        kind, arg0, arg1, flags = pack_plan(plan)
        cfg = plan.config
        inton = plan.prosody.intonation
        cplan = _CtnPlan(
            n_ops=len(plan.ops),
            kind=kind.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            arg0=arg0.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            arg1=arg1.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            flags=flags.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            speed=np.float32(plan.speed),
            target_rms=np.float32(plan.target_rms),
            silence_threshold=np.float32(cfg.silence_threshold),
            max_pitch_change=np.float32(cfg.max_pitch_change),
            min_silence_samples=plan.min_silence_samples,
            fade_in_samples=plan.fade_in_samples,
            remove_dc_offset=1 if cfg.remove_dc_offset else 0,
            remove_word_silence=1 if cfg.remove_word_silence else 0,
            word_count=plan.prosody.word_count,
            phrase_type=int(inton.type),
            pitch_start=np.float32(inton.pitch_start),
            pitch_end=np.float32(inton.pitch_end),
            pitch_peak=np.float32(inton.pitch_peak),
            peak_position=np.float32(inton.peak_position),
            energy_factor=np.float32(inton.energy_factor),
        )
        out = ctypes.POINTER(ctypes.c_int16)()
        count = self._lib.ctn_execute_plan(self._db, ctypes.byref(cplan),
                                           ctypes.byref(out))
        if count < 0:
            raise RuntimeError("native synthesis failed")
        result = np.ctypeslib.as_array(out, shape=(count,)).copy()
        self._lib.ctn_free(out)
        return result.astype(np.int16)

    def close(self) -> None:
        if self._db:
            self._lib.ctn_db_close(self._db)
            self._db = None

    def __del__(self):
        self.close()
