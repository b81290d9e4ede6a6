"""Runtime voice-database reader: mmap + zero-copy views + hash lookup.

Mirrors ctts_init / find_unit (ctts.c:1117-1184, 1337-1387). The audio
pool is exposed as a NumPy int16 view over the mapping; `to_device_arrays`
produces the padded unit tensor used by the TPU executor.

Copy of ctts_tpu/db/reader.py for the PyTorch port: only the package
name in its imports and module references differs, and the C
reference is cited by its relative path.
"""

from __future__ import annotations

import mmap

import numpy as np

from ctts_tpu_torch.constants import MAGIC, VERSION
from ctts_tpu_torch.db.format import EMPTY, HEADER_SIZE, INDEX_DTYPE, Header
from ctts_tpu_torch.utils.textutil import fnv1a_hash


class DatabaseError(ValueError):
    pass


class VoiceDatabase:
    """Read-only view of a compiled voice.db."""

    def __init__(self, path: str):
        self.path = str(path)
        self._file = open(path, "rb")
        self._map = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        buf = memoryview(self._map)

        self.header = Header.unpack(bytes(buf[:HEADER_SIZE]))
        if self.header.magic != MAGIC:
            raise DatabaseError(f"{path}: bad magic")
        if self.header.version != VERSION:
            raise DatabaseError(f"{path}: version mismatch")

        h = self.header
        self.index = np.frombuffer(
            buf, dtype=INDEX_DTYPE, count=h.unit_count, offset=h.index_offset
        )
        self.hash_table = np.frombuffer(
            buf, dtype="<u4", count=h.hash_table_size, offset=h.hash_table_offset
        )
        self.strings = bytes(
            buf[h.strings_offset : h.strings_offset + (h.audio_offset - h.strings_offset)]
        )
        self.audio = np.frombuffer(
            buf, dtype="<i2", count=h.total_samples, offset=h.audio_offset
        )

        # Hot-path lookup: a plain dict beats re-walking the chained table
        # in Python. The on-disk table is still validated by tests.
        self._lookup: dict[bytes, int] = {}
        for i in range(h.unit_count):
            e = self.index[i]
            text = self.strings[
                int(e["string_offset"]) : int(e["string_offset"]) + int(e["string_len"])
            ]
            # First writer wins, matching chain-order probe semantics.
            self._lookup.setdefault(text, i)

    # -- lookup ---------------------------------------------------------

    def find_unit(self, text: bytes) -> int:
        """Index of the unit whose text equals `text`, or -1
        (find_unit, ctts.c:1337-1354)."""
        return self._lookup.get(text, -1)

    def find_unit_via_table(self, text: bytes) -> int:
        """Reference-faithful chained-hash probe, used by parity tests."""
        h = fnv1a_hash(text)
        idx = int(self.hash_table[h % self.header.hash_table_size])
        while idx != EMPTY:
            e = self.index[idx]
            if int(e["hash"]) == h and int(e["string_len"]) == len(text):
                off = int(e["string_offset"])
                if self.strings[off : off + len(text)] == text:
                    return idx
            idx = int(e["next_hash"])
        return -1

    def unit_text(self, idx: int) -> bytes:
        e = self.index[idx]
        off = int(e["string_offset"])
        return self.strings[off : off + int(e["string_len"])]

    def unit_samples(self, idx: int) -> np.ndarray:
        """Zero-copy int16 view of a unit's audio (ctts.c:1557-1561)."""
        e = self.index[idx]
        off = int(e["audio_offset"])
        return self.audio[off : off + int(e["sample_count"])]

    @property
    def max_unit_chars(self) -> int:
        return self.header.max_unit_chars

    @property
    def unit_count(self) -> int:
        return self.header.unit_count

    # -- device upload ----------------------------------------------------

    def to_device_arrays(self, pad_multiple: int = 1024):
        """Padded unit tensor for the TPU executor.

        Returns (units_padded [N, U_max] int16, lengths [N] int32) where
        U_max is the longest unit rounded up to `pad_multiple` for lane
        alignment. The audio pool of a voice is small (tens of MB), so it
        is replicated per chip (SURVEY.md §5.8).
        """
        n = self.unit_count
        lengths = self.index["sample_count"].astype(np.int32)
        u_max = int(lengths.max()) if n else pad_multiple
        u_max = -(-u_max // pad_multiple) * pad_multiple
        units = np.zeros((n, u_max), dtype=np.int16)
        for i in range(n):
            s = self.unit_samples(i)
            units[i, : s.shape[0]] = s
        return units, lengths

    def close(self) -> None:
        # Views into the mmap must be dropped before closing.
        self.index = None
        self.hash_table = None
        self.audio = None
        self._map.close()
        self._file.close()
