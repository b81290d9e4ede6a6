"""Offline voice-database builder, byte-identical to the C reference
(ctts.c:855-1111).

Reads `filename|text|display` index files, loads the referenced WAVs,
normalizes texts, sorts by character count (desc) then byte order, and
lays out header / index / chained hash table / string pool / audio pool.

Copy of ctts_tpu/db/builder.py for the PyTorch port: only the package
name in its imports and module references differs, and the C
reference is cited by its relative path.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass

import numpy as np

from ctts_tpu_torch.constants import (
    BITS_PER_SAMPLE,
    HASH_TABLE_LOAD,
    MAGIC,
    SAMPLE_RATE,
    VERSION,
)
from ctts_tpu_torch.db.format import EMPTY, HEADER_SIZE, INDEX_DTYPE, Header
from ctts_tpu_torch.utils.textutil import fnv1a_hash, normalize_lowercase, utf8_strlen
from ctts_tpu_torch.utils.wav import WavError, read_wav


@dataclass
class BuildUnit:
    text: bytes
    char_count: int
    samples: np.ndarray
    hash: int


def load_units_from_index(wav_dir: str, index_file: str,
                          verbose: bool = True) -> list[BuildUnit]:
    """Parse one `filename|text|display` index (ctts.c:855-928).
    Unloadable WAVs are warned about and skipped."""
    units: list[BuildUnit] = []
    with open(index_file, "rb") as f:
        for raw in f:
            line = raw.rstrip(b"\r\n")
            if not line:
                continue
            parts = line.split(b"|")
            if len(parts) < 2 or not parts[0]:
                continue
            filename, text = parts[0], parts[1]
            path = os.path.join(wav_dir, filename.decode("utf-8") + ".wav")
            try:
                samples = read_wav(path)
            except (OSError, WavError) as e:
                if verbose:
                    print(f"Warning: Could not load {path}: {e}", file=sys.stderr)
                continue
            normalized = normalize_lowercase(text)
            units.append(
                BuildUnit(
                    text=normalized,
                    char_count=utf8_strlen(normalized),
                    samples=samples,
                    hash=fnv1a_hash(normalized),
                )
            )
    return units


def _sort_units(units: list[BuildUnit]) -> list[BuildUnit]:
    """char_count descending, then byte-order ascending (compare_units,
    ctts.c:931-937)."""
    return sorted(units, key=lambda u: (-u.char_count, u.text))


def build_database_from_units(units: list[BuildUnit], output_file: str,
                              verbose: bool = True) -> None:
    """Lay out and write the .db (ctts.c:964-1089)."""
    units = _sort_units(units)
    total_count = len(units)

    strings_size = sum(len(u.text) + 1 for u in units)
    audio_samples = sum(int(u.samples.shape[0]) for u in units)
    max_chars = max((u.char_count for u in units), default=0)

    # Next power of two ≥ count / 0.7 (float compare; ctts.c:989-991).
    hash_table_size = 1
    while hash_table_size < total_count / HASH_TABLE_LOAD:
        hash_table_size *= 2

    index_offset = HEADER_SIZE
    hash_table_offset = index_offset + total_count * INDEX_DTYPE.itemsize
    strings_offset = hash_table_offset + hash_table_size * 4
    audio_offset = strings_offset + strings_size

    header = Header(
        magic=MAGIC,
        version=VERSION,
        unit_count=total_count,
        sample_rate=SAMPLE_RATE,
        bits_per_sample=BITS_PER_SAMPLE,
        index_offset=index_offset,
        strings_offset=strings_offset,
        audio_offset=audio_offset,
        total_samples=audio_samples,
        max_unit_chars=max_chars,
        hash_table_size=hash_table_size,
        hash_table_offset=hash_table_offset,
    )

    index = np.zeros(total_count, dtype=INDEX_DTYPE)
    hash_table = np.full(hash_table_size, EMPTY, dtype=np.uint32)

    string_pos = 0
    audio_pos = 0
    # Chain inserts: head in the table, later entries appended at chain end
    # (ctts.c:1052-1062).
    chain_tail: dict[int, int] = {}
    for i, u in enumerate(units):
        index[i]["hash"] = u.hash
        index[i]["string_offset"] = string_pos
        index[i]["string_len"] = len(u.text)
        index[i]["char_count"] = u.char_count
        index[i]["audio_offset"] = audio_pos
        index[i]["sample_count"] = u.samples.shape[0]
        index[i]["next_hash"] = EMPTY

        slot = u.hash % hash_table_size
        if hash_table[slot] == EMPTY:
            hash_table[slot] = i
        else:
            prev = chain_tail.get(slot, int(hash_table[slot]))
            # Walk in case chain_tail is stale (it never is, but keep the
            # C semantics literal).
            while index[prev]["next_hash"] != EMPTY:
                prev = int(index[prev]["next_hash"])
            index[prev]["next_hash"] = i
        chain_tail[slot] = i

        string_pos += len(u.text) + 1
        audio_pos += int(u.samples.shape[0])

    with open(output_file, "wb") as out:
        out.write(header.pack())
        out.write(index.tobytes())
        out.write(hash_table.tobytes())
        for u in units:
            out.write(u.text)
            out.write(b"\x00")
        for u in units:
            out.write(np.ascontiguousarray(u.samples, dtype="<i2").tobytes())

    if verbose:
        print(f"Database written to {output_file}")
        print(f"  Units: {total_count}")
        print(f"  Max unit length: {max_chars} characters")
        print(f"  Total audio samples: {audio_samples}")


def build_database(letters_dir: str, letters_index: str, syllables_dir: str,
                   syllables_index: str, output_file: str,
                   verbose: bool = True) -> None:
    """Full build: letters + syllables merged (ctts.c:939-1111). A missing
    syllables index degrades to letters-only, like the reference."""
    letters = load_units_from_index(letters_dir, letters_index, verbose)
    if verbose:
        print(f"Loaded {len(letters)} letters")
    try:
        syllables = load_units_from_index(syllables_dir, syllables_index, verbose)
        if verbose:
            print(f"Loaded {len(syllables)} syllables")
    except OSError:
        print("Failed to load syllables: File not found", file=sys.stderr)
        syllables = []
    build_database_from_units(letters + syllables, output_file, verbose)
