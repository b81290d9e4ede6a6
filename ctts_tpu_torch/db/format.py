"""On-disk `voice.db` format, bit-compatible with the C reference.

Layout (ctts.h:84-111, architecture.txt:115-170):

    [CTTSHeader 64 B][index: 32 B × unit_count][hash table: u32 × size]
    [string pool (NUL-terminated)][audio pool: int16 samples]

All integers little-endian. The hash table stores unit indices with
0xFFFFFFFF as the empty/end-of-chain sentinel; collisions chain through
CTTSIndexEntry.next_hash (ctts.c:1034-1062).

Copy of ctts_tpu/db/format.py for the PyTorch port: only the package
name in its imports and module references differs, and the C
reference is cited by its relative path.
"""

from __future__ import annotations

import dataclasses
import struct

HEADER_FMT = "<12I16x"
HEADER_SIZE = struct.calcsize(HEADER_FMT)  # 64
assert HEADER_SIZE == 64

INDEX_FMT = "<IIHHIIIII"
INDEX_SIZE = struct.calcsize(INDEX_FMT)  # 32
assert INDEX_SIZE == 32

EMPTY = 0xFFFFFFFF

# numpy structured dtype mirroring CTTSIndexEntry (ctts.h:101-111)
import numpy as np

INDEX_DTYPE = np.dtype(
    [
        ("hash", "<u4"),
        ("string_offset", "<u4"),
        ("string_len", "<u2"),
        ("char_count", "<u2"),
        ("audio_offset", "<u4"),
        ("sample_count", "<u4"),
        ("flags", "<u4"),
        ("next_hash", "<u4"),
        ("reserved", "<u4"),
    ]
)
assert INDEX_DTYPE.itemsize == 32


@dataclasses.dataclass
class Header:
    magic: int
    version: int
    unit_count: int
    sample_rate: int
    bits_per_sample: int
    index_offset: int
    strings_offset: int
    audio_offset: int
    total_samples: int
    max_unit_chars: int
    hash_table_size: int
    hash_table_offset: int

    def pack(self) -> bytes:
        return struct.pack(
            HEADER_FMT,
            self.magic,
            self.version,
            self.unit_count,
            self.sample_rate,
            self.bits_per_sample,
            self.index_offset,
            self.strings_offset,
            self.audio_offset,
            self.total_samples,
            self.max_unit_chars,
            self.hash_table_size,
            self.hash_table_offset,
        )

    @classmethod
    def unpack(cls, data: bytes) -> "Header":
        return cls(*struct.unpack_from(HEADER_FMT, data, 0))
