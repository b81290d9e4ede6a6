"""Native (C++) batch plan lowering: text -> device-plan arrays.

The same ctypes binding as ctts_tpu/plan/native_lower.py to the
`ctl_*` entry points of libctts.so (the C++ twin of compile_plan ->
split_plan -> walk_plan -> derive_dims -> fill_device_plan), built by
`make` from this package's own copy of the native runtime
(ctts_tpu_torch/runtime) and constructing this package's PlanDims.
Unlike the JAX package's loader, a failed `make` or a missing or
unloadable library raises (after a few retries that cover a concurrent
build): a stale library would be wrong and no parity test would see
it. The library refuses a fade longer than the bucket's margin, which
the port's core no longer needs (synth/plan_arrays.py fade_widths): the
binding lowers with fade_out_ms 0 and writes the configuration's fade
length into the slots the walk recorded, and refuses what
plan_arrays.check_config refuses.

A bucket's rows are filled by one call of fill_rows.cpp (beside this
module; built with g++ at first use into ctts_tpu_torch/_build/, a
failed build raises): ctl_fill_row a row, the fade lengths, the
scalars, the length order and the pad rows, with the GIL released
(`fill_bucket`). `fill_into` fills one row from Python and is the
reference that tests/test_torch_fill_rows.py holds it to.
"""

from __future__ import annotations

import ctypes
import functools
import os
from pathlib import Path
from typing import Sequence

import numpy as np

from ctts_tpu_torch.config import CTTSConfig
from ctts_tpu_torch.ops.hopper.build import BUILD_DIR, gxx_build
from ctts_tpu_torch.plan.compiler import ms_to_samples
from ctts_tpu_torch.runtime.native import make_and_open
from ctts_tpu_torch.synth.plan_arrays import (
    PlanDims,
    check_config,
    fade_widths,
)

_SO = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "runtime", "libctts.so")
_FILL_SRC = Path(__file__).resolve().with_name("fill_rows.cpp")
_FILL_SO = BUILD_DIR / "libctts_fill_rows.so"


class _CConfig(ctypes.Structure):
    """Mirror of CTTSConfig (runtime/include/ctts.h; field order is ABI)."""

    _fields_ = [
        ("crossfade_ms", ctypes.c_float),
        ("crossfade_vowel_ms", ctypes.c_float),
        ("crossfade_s_ending_ms", ctypes.c_float),
        ("crossfade_r_ending_ms", ctypes.c_float),
        ("vowel_to_consonant_factor", ctypes.c_float),
        ("word_pause_ms", ctypes.c_float),
        ("unknown_silence_ms", ctypes.c_float),
        ("fade_in_ms", ctypes.c_float),
        ("fade_out_ms", ctypes.c_float),
        ("remove_word_silence", ctypes.c_int),
        ("silence_threshold", ctypes.c_float),
        ("min_silence_ms", ctypes.c_float),
        ("remove_dc_offset", ctypes.c_int),
        ("normalize_level", ctypes.c_float),
        ("compression", ctypes.c_float),
        ("default_speed", ctypes.c_float),
        ("min_speed", ctypes.c_float),
        ("max_speed", ctypes.c_float),
        ("max_pitch_change", ctypes.c_float),
        ("print_units", ctypes.c_int),
        ("print_timing", ctypes.c_int),
    ]


# Field manifest, in the exact pointer order ctl_fill_row consumes.
# shape key: "U" | "R" | "R5" | "FD" | "NSHIFT".
_MANIFEST = [
    ("unit_id", "U", np.int32),
    ("unit_region", "U", np.int32),
    ("unit_off", "U", np.int32),
    ("unit_boundary", "U", np.int32),
    ("unit_cf_in", "U", np.int32),
    ("unit_fade_in", "U", np.bool_),
    ("unit_smooth", "U", np.bool_),
    ("unit_analysis", "U", np.int32),
    ("unit_boundary_len", "U", np.int32),
    ("unit_shift_region", "U", np.int32),
    ("unit_prev_ok", "U", np.bool_),
    ("region_len", "R", np.int32),
    ("region_do_dsp", "R", np.bool_),
    ("region_remove", "R", np.bool_),
    ("region_pause", "R", np.int32),
    ("region_fade_after", "R", np.int32),
    ("region_contour", "R5", np.float32),
    ("region_qfinal", "R", np.bool_),
    ("region_energy", "R", np.bool_),
    ("region_active", "R", np.bool_),
    ("fade_region", "FD", np.int32),
    ("fade_pos", "FD", np.int32),
    ("fade_len", "FD", np.int32),
    ("shift_slots", "NSHIFT", np.int32),
]


def _shape_of(key: str, dims: PlanDims) -> tuple:
    if key == "U":
        return (dims.U,)
    if key == "R":
        return (dims.R,)
    if key == "R5":
        return (dims.R, 5)
    if key == "FD":
        return (dims.FD,)
    return (dims.NSHIFT,)


# The fields fill_rows.cpp finds by role (its enum Role, in order).
_ROLES = ["region_len", "region_pause", "region_do_dsp",
          "region_fade_after", "fade_pos", "fade_len", "threshold",
          "speed", "refine_trips"]
_SCALARS = [("threshold", np.float32), ("speed", np.float32),
            ("refine_trips", np.int32)]
_FIELDS = [name for name, _, _ in _MANIFEST] + [n for n, _ in _SCALARS]
_ROLE_IDS = np.array([_FIELDS.index(name) for name in _ROLES], np.int32)
_ROLE_ADDR = _ROLE_IDS.ctypes.data

_ALIGN = 64   # each field's offset in a bucket's buffer


@functools.lru_cache(maxsize=256)
def _bucket_args(dims: PlanDims):
    """The 8 bucket dims ctl_fill_row takes (int32) and the bytes a slot
    of every field of _FIELDS (int64), and the addresses of both."""
    bd = np.array([dims.U, dims.R, dims.FD, dims.NSHIFT, dims.MARGIN,
                   dims.UBUF, dims.CONTW, min(dims.FADEW, dims.MARGIN)],
                  np.int32)
    row_bytes = np.array([
        int(np.prod(shape, dtype=np.int64)) * np.dtype(dt).itemsize
        for _, shape, dt in _layout(dims)], np.int64)
    return bd, row_bytes, bd.ctypes.data, row_bytes.ctypes.data


@functools.lru_cache(maxsize=256)
def _layout(dims: PlanDims) -> tuple:
    """(name, shape of a slot, dtype) of every field of _FIELDS."""
    return tuple([(name, _shape_of(key, dims), dt)
                  for name, key, dt in _MANIFEST]
                 + [(name, (), dt) for name, dt in _SCALARS])


@functools.lru_cache(maxsize=256)
def _offsets(dims: PlanDims, bsz: int):
    """A bucket buffer's bytes, each field's (name, shape, dtype, offset)
    at an _ALIGN-aligned offset, and the offsets as uint64."""
    fields, off = [], 0
    for (name, shape, dt), rb in zip(_layout(dims),
                                     _bucket_args(dims)[1].tolist()):
        fields.append((name, (bsz,) + shape, dt, off))
        off += -(-rb * bsz // _ALIGN) * _ALIGN
    offs = np.array([f[3] for f in fields], np.uint64)
    return max(off, _ALIGN), tuple(fields), offs


def _alloc(dims: PlanDims, bsz: int):
    """The stacked arrays of `bsz` slots, each a view of one byte buffer,
    and their addresses (uint64, in _FIELDS order): one allocation, and
    one address read, a bucket."""
    nbytes, fields, offs = _offsets(dims, bsz)
    buf = np.empty(nbytes, np.uint8)
    stacked = {name: np.ndarray(shape, dt, buf, off)
               for name, shape, dt, off in fields}
    return stacked, offs + np.uint64(buf.ctypes.data)


_lib = None
_fill = None


def _load_fill():
    """Build and load fill_rows.cpp's library once; raises on failure."""
    global _fill
    if _fill is None:
        lib = ctypes.CDLL(str(gxx_build(_FILL_SRC, _FILL_SO)))
        P, I32 = ctypes.c_void_p, ctypes.c_int32
        lib.ctf_fill_bucket.restype = I32
        lib.ctf_fill_bucket.argtypes = [P, P, P, I32, I32, P, P, P, P, I32,
                                        I32, P, I32, ctypes.c_float,
                                        ctypes.c_float, P, P]
        _fill = lib
    return _fill


def _load():
    """Build and load libctts.so once; raises on any failure."""
    global _lib
    if _lib is not None:
        return _lib
    lib = make_and_open(_SO)
    lib.ctl_open.restype = ctypes.c_void_p
    lib.ctl_open.argtypes = [ctypes.c_char_p, ctypes.POINTER(_CConfig)]
    lib.ctl_close.restype = None
    lib.ctl_close.argtypes = [ctypes.c_void_p]
    lib.ctl_begin.restype = None
    lib.ctl_begin.argtypes = [ctypes.c_void_p]
    lib.ctl_add_text.restype = ctypes.c_int32
    lib.ctl_add_text.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
        ctypes.c_float, ctypes.c_int32,
    ]
    lib.ctl_row_count.restype = ctypes.c_int32
    lib.ctl_row_count.argtypes = [ctypes.c_void_p]
    lib.ctl_row_dims.restype = ctypes.c_int32
    lib.ctl_row_dims.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.POINTER(ctypes.c_int32),
    ]
    lib.ctl_fill_row.restype = ctypes.c_int32
    lib.ctl_fill_row.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_void_p),
    ]
    lib.ctl_set_rules.restype = ctypes.c_int32
    lib.ctl_set_rules.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_char_p),
    ]
    _lib = lib
    return _lib


class NativeLowerer:
    """One native lowering handle per synthesizer (not thread-safe)."""

    def __init__(self, db_path: str, config: CTTSConfig, rules=None):
        check_config(config)
        lib = _load()
        self._lib = lib
        # Every FADE_TAIL is fade_out_ms long: the walk runs with 0 and
        # fill_into writes the length back (the module docstring).
        self._fade = ms_to_samples(config.fade_out_ms)
        cc = _CConfig()
        for name, ctype in _CConfig._fields_:
            v = 0.0 if name == "fade_out_ms" else getattr(config, name)
            setattr(cc, name, int(v) if ctype is ctypes.c_int else float(v))
        self._fill_row = ctypes.cast(lib.ctl_fill_row, ctypes.c_void_p)
        self._h = lib.ctl_open(db_path.encode(), ctypes.byref(cc))
        if not self._h:
            raise RuntimeError(f"ctl_open failed for {db_path}")
        if rules is not None and rules.rules:
            pats = [r.posix for r in rules.rules]
            reps = [r.replace for r in rules.rules]
            if any(p is None for p in pats):
                raise RuntimeError(
                    "rules lack POSIX patterns (hand-built NormRule?)")
            rc = lib.ctl_set_rules(
                self._h, len(pats),
                (ctypes.c_char_p * len(pats))(*pats),
                (ctypes.c_char_p * len(reps))(*reps),
            )
            if rc != 0:
                raise RuntimeError(
                    f"ctl_set_rules failed (rc {rc}): a pattern was "
                    "rejected by host regcomp")

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.ctl_close(self._h)
            self._h = None

    def __del__(self):
        self.close()

    def lower(self, texts: Sequence[str | bytes], speed: float,
              split: bool):
        """Compile + split + walk a text batch.

        Returns (spans, dims_list, refine_trips) where spans[i] is the
        [start, end) row range of input i, dims_list[r] the per-row
        derived PlanDims (pre-bucket), refine_trips[r] the per-row
        fixed-point trip count. Rows stay resident in the handle until
        the next lower() call; fill_bucket() and fill_into() read them
        by index.
        """
        lib = self._lib
        lib.ctl_begin(self._h)
        spans = []
        start = 0
        for t in texts:
            b = t.encode("utf-8") if isinstance(t, str) else bytes(t)
            n = lib.ctl_add_text(self._h, b, len(b),
                                 ctypes.c_float(speed),
                                 1 if split else 0)
            if n < 0:
                raise RuntimeError(f"ctl_add_text failed: {n}")
            spans.append((start, start + n))
            start += n
        out = (ctypes.c_int32 * 21)()
        dims_list, trips = [], []
        for r in range(start):
            if lib.ctl_row_dims(self._h, r, out) != 0:
                raise RuntimeError("ctl_row_dims failed")
            o = list(out)
            dims_list.append(PlanDims(
                U=o[0], R=o[1], FD=o[2], NSHIFT=o[3], WREG=o[4],
                MARGIN=o[5], UBUF=o[6], WIN=o[7], CFMAX=o[8], SMAX=o[9],
                OMAX=o[10], CONTW=o[11], **fade_widths(self._fade),
                fade_in_samples=o[14], min_silence_samples=o[15],
                remove_dc=bool(o[16]), stretch=bool(o[17]),
                synth_hop=o[18], contour_drift=o[19],
            ))
            trips.append(o[20])
        return spans, dims_list, trips

    def alloc_stacked(self, dims: PlanDims, bsz: int) -> dict:
        """Batch-stacked arrays in the manifest layout plus the three
        scalar fields, uninitialized where every slot is written."""
        return _alloc(dims, bsz)[0]

    def fill_bucket(self, rows: Sequence[int], dims: PlanDims, bsz: int,
                    trips: np.ndarray, threshold: float, speed: float):
        """Fill the lowered rows `rows` (their ids, in arrival order) of
        one bucket (bucketed dims) into new stacked arrays of `bsz`
        slots, in one native call: what fill_into a row, the scalars
        (`trips` every row's refine trips, by id, int32) and the length
        order and pad rows of BatchSynthesizer._order_and_pad give, bit
        for bit. Returns (stacked, the row ids in slot order)."""
        n = len(rows)
        stacked, bases = _alloc(dims, bsz)
        *_, bd, row_bytes = _bucket_args(dims)
        ids = np.array(rows, np.int32)
        trips = np.ascontiguousarray(trips, np.int32)
        slot_rows = np.empty(n, np.int32)
        bad = ctypes.c_int32(-1)
        rc = _load_fill().ctf_fill_bucket(
            self._fill_row, self._h, bd, len(_FIELDS), len(_MANIFEST),
            bases.ctypes.data, row_bytes, _ROLE_ADDR, ids.ctypes.data, n,
            bsz, trips.ctypes.data, self._fade, threshold, speed,
            slot_rows.ctypes.data, ctypes.byref(bad))
        if rc != 0:
            raise RuntimeError(f"ctl_fill_row failed: {rc} (row {bad.value})")
        return stacked, slot_rows.tolist()

    def fill_into(self, row: int, dims: PlanDims, stacked: dict,
                  slot: int) -> None:
        """Fill one lowered row into batch slot `slot` (bucketed dims):
        the library's arrays, with the fade length in every fade slot
        the walk recorded (fade_pos >= 0) and in every region that runs
        its word DSP (a FADE_TAIL follows each WORD_DSP)."""
        bd = (ctypes.c_int32 * 8)(dims.U, dims.R, dims.FD, dims.NSHIFT,
                                  dims.MARGIN, dims.UBUF, dims.CONTW,
                                  min(dims.FADEW, dims.MARGIN))
        ptrs = (ctypes.c_void_p * len(_MANIFEST))(*[
            stacked[name].ctypes.data + slot * stacked[name].strides[0]
            for name, _, _ in _MANIFEST
        ])
        rc = self._lib.ctl_fill_row(self._h, row, bd, ptrs)
        if rc != 0:
            raise RuntimeError(f"ctl_fill_row failed: {rc} (row {row})")
        stacked["fade_len"][slot] = np.where(
            stacked["fade_pos"][slot] >= 0, self._fade, 0)
        stacked["region_fade_after"][slot] = np.where(
            stacked["region_do_dsp"][slot], self._fade, 0)
