"""The serving drain's wire decode: every wired shard of a batch decoded
in one native pass, straight into the rows' own arrays.

`wire_rows.cpp` (beside this module) decodes the format of ops/wire.py
block by block, each block straight into the row that holds it, or
through a stage in L1 where rows share it, on the calling thread with
the GIL released (ctypes). Its two paths, AVX2 and scalar, are one
algorithm; the library takes the AVX2 path where the CPU has it
(`path()`), and each path is also exported by name. The library is built with g++ on first
use into ctts_tpu_torch/_build/ and rebuilt when the source is newer; a
failed build raises, and nothing falls back to another decoder.

The bits are `decode_np`'s (and `decode_host`'s): tests/
test_torch_wire_rows.py holds both paths to them. The serving drain
(parallel/batch.py `_drain`) gives each row the address of its place in
its text's array. Without the codec the drain's shards hold the rows'
int16 samples back to back, and `copy_rows` copies every shard's rows
to their addresses in one native call over the same tables.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np

from ctts_tpu_torch.ops.hopper.build import BUILD_DIR, gxx_build
from ctts_tpu_torch.ops.wire import WIRE_BLOCK, wire_valid_words

SRC = Path(__file__).resolve().with_name("wire_rows.cpp")
LIB_PATH = BUILD_DIR / "libctts_wire_rows.so"
PATHS = ("avx2", "scalar")

_P = ctypes.c_void_p
_ARGS = [ctypes.c_int64, _P, _P, _P, _P, _P, _P, _P]
_COPY_ARGS = [ctypes.c_int64, _P, _P, _P, _P, _P]
_ERRORS = {-1: "a class outside 1..5",
           -2: "too few words or classes for the rows",
           -3: "row ends negative or decreasing",
           -4: "the CPU lacks the path's instructions",
           -5: "too few samples for the rows"}

_lock = threading.Lock()
_lib = None


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(gxx_build(SRC, LIB_PATH)))
            for name in ("ctw_decode_rows", "ctw_decode_rows_avx2",
                         "ctw_decode_rows_scalar"):
                fn = getattr(lib, name)
                fn.argtypes = _ARGS
                fn.restype = ctypes.c_int64
            lib.ctw_copy_rows.argtypes = _COPY_ARGS
            lib.ctw_copy_rows.restype = ctypes.c_int64
            lib.ctw_path.argtypes = []
            lib.ctw_path.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def path() -> str:
    """The path that `decode_rows` takes on this CPU: "avx2" or
    "scalar"."""
    return _load().ctw_path().decode()


def decode_rows(shards, which: str | None = None) -> int:
    """Decode every shard of `shards` into its rows in one native call;
    returns the samples written.

    A shard is (words int32, classes int32, ends int64 [rows], addresses
    [rows]): `ends` each row's end in the shard's samples (rows back to
    back from 0), `addresses` where each row's int16 samples go, or 0 to
    skip the row. The caller owns the memory at each address, room for
    its row's samples, and keeps it alive through the call. `which`
    names a path ("avx2" or "scalar"); None takes `path()`. Raises
    ValueError, as ops/wire.py's decode_host does, on too few classes or
    words for the rows' samples and on a class outside 1..5."""
    lib = _load()
    fn = (lib.ctw_decode_rows if which is None
          else getattr(lib, f"ctw_decode_rows_{which}"))
    words, classes, ends, addrs, row_off = [], [], [], [], [0]
    for w, cls, e, a in shards:
        e = np.ascontiguousarray(e, np.int64)
        a = np.ascontiguousarray(a, np.uint64)
        if a.shape != e.shape:
            raise ValueError(f"decode_rows: {a.shape[0]} addresses for "
                             f"{e.shape[0]} row ends")
        total = int(e[-1]) if e.shape[0] else 0
        nblk = -(-total // WIRE_BLOCK)
        cls = np.ascontiguousarray(cls, np.int32)
        need = wire_valid_words(cls[:nblk], total)
        w = np.ascontiguousarray(w, np.int32)
        if cls.shape[0] < nblk or w.shape[0] < need:
            raise ValueError(f"decode_rows: {cls.shape[0]} classes and "
                             f"{w.shape[0]} words for {total} samples "
                             f"({nblk} blocks, {need} words)")
        words.append(w)
        classes.append(cls)
        ends.append(e)
        addrs.append(a)
        row_off.append(row_off[-1] + e.shape[0])
    cat = (lambda xs, t: np.concatenate(xs) if xs else np.zeros(0, t))
    args = [np.array([w.ctypes.data for w in words], np.uint64),
            np.array([w.shape[0] for w in words], np.int64),
            np.array([c.ctypes.data for c in classes], np.uint64),
            np.array([c.shape[0] for c in classes], np.int64),
            np.array(row_off, np.int64), cat(ends, np.int64),
            cat(addrs, np.uint64)]
    got = fn(len(words), *(a.ctypes.data for a in args))
    if got < 0:
        raise ValueError(f"ctw_decode_rows: {_ERRORS.get(got, got)}")
    return int(got)


def copy_rows(shards) -> int:
    """Copy every codec-off shard of `shards` into its rows in one native
    call; returns the samples written.

    A shard is (samples int16, ends int64 [rows], addresses [rows]): the
    shard's rows back to back from 0 in `samples`, `ends` and
    `addresses` as in `decode_rows` (0 skips a row). Raises ValueError,
    as `decode_rows` does, on addresses that do not match the ends, on
    too few samples for the row ends and on row ends negative or
    decreasing."""
    samples, ends, addrs, row_off = [], [], [], [0]
    for x, e, a in shards:
        e = np.ascontiguousarray(e, np.int64)
        a = np.ascontiguousarray(a, np.uint64)
        if a.shape != e.shape:
            raise ValueError(f"copy_rows: {a.shape[0]} addresses for "
                             f"{e.shape[0]} row ends")
        total = int(e[-1]) if e.shape[0] else 0
        x = np.ascontiguousarray(x, np.int16)
        if x.shape[0] < total:
            raise ValueError(f"copy_rows: {x.shape[0]} samples for row "
                             f"ends up to {total}")
        samples.append(x)
        ends.append(e)
        addrs.append(a)
        row_off.append(row_off[-1] + e.shape[0])
    cat = (lambda xs, t: np.concatenate(xs) if xs else np.zeros(0, t))
    args = [np.array([x.ctypes.data for x in samples], np.uint64),
            np.array([x.shape[0] for x in samples], np.int64),
            np.array(row_off, np.int64), cat(ends, np.int64),
            cat(addrs, np.uint64)]
    got = _load().ctw_copy_rows(len(samples),
                                *(a.ctypes.data for a in args))
    if got < 0:
        raise ValueError(f"ctw_copy_rows: {_ERRORS.get(got, got)}")
    return int(got)
