"""Byte-level text utilities with exact parity to the C reference.

The reference operates on UTF-8 *bytes* throughout (hashing, unit matching,
string lengths), so the canonical representation here is `bytes`. Python
`str` is used only at the API boundary.

Parity sources (file:line into reference):
- FNV-1a hash:           ctts.c:224-231
- UTF-8 strlen:          ctts.c:174-181
- UTF-8 decode iterator: ctts.c:183-208
- utf8_char_len:         ctts.c:211-218
- unicode_tolower:       ctts.c:238-246 (ASCII + only É/Ó/Ô/Ç!)
- ctts_normalize:        ctts.c:271-287

Frozen copy of ctts_tpu_torch/utils/textutil.py for the benchmark's reference
(benchmark/reference/): only the imports differ, so that a later
change to the port cannot move what the benchmark compares with.
"""

from __future__ import annotations

from benchmark.reference.constants import FNV_OFFSET_BASIS, FNV_PRIME

_U32 = 0xFFFFFFFF


def fnv1a_hash(data: bytes) -> int:
    """32-bit FNV-1a over raw bytes (ctts.c:224-231)."""
    h = FNV_OFFSET_BASIS
    for b in data:
        h ^= b
        h = (h * FNV_PRIME) & _U32
    return h


def utf8_strlen(data: bytes) -> int:
    """Count UTF-8 characters: bytes that are not continuation bytes
    (ctts.c:174-181)."""
    return sum(1 for b in data if (b & 0xC0) != 0x80)


def utf8_char_len(data: bytes, pos: int = 0) -> int:
    """Byte length of the UTF-8 character starting at `pos` (ctts.c:211-218)."""
    c = data[pos]
    if c < 0x80:
        return 1
    if (c & 0xE0) == 0xC0:
        return 2
    if (c & 0xF0) == 0xE0:
        return 3
    if (c & 0xF8) == 0xF0:
        return 4
    return 1


def utf8_next(data: bytes, pos: int) -> tuple[int, int]:
    """Decode the codepoint at `pos`; return (codepoint, next_pos).

    Mirrors ctts_utf8_next (ctts.c:183-208) including its tolerance of
    truncated sequences (missing continuation bytes simply stop early) and
    its '?' substitution for invalid lead bytes.
    """
    n = len(data)
    s = data[pos]
    if s < 0x80:
        return s, pos + 1
    if (s & 0xE0) == 0xC0:
        cp = (s & 0x1F) << 6
        pos += 1
        if pos < n and (data[pos] & 0xC0) == 0x80:
            cp |= data[pos] & 0x3F
            pos += 1
        return cp, pos
    if (s & 0xF0) == 0xE0:
        cp = (s & 0x0F) << 12
        pos += 1
        if pos < n and (data[pos] & 0xC0) == 0x80:
            cp |= (data[pos] & 0x3F) << 6
            pos += 1
            if pos < n and (data[pos] & 0xC0) == 0x80:
                cp |= data[pos] & 0x3F
                pos += 1
        return cp, pos
    if (s & 0xF8) == 0xF0:
        cp = (s & 0x07) << 18
        pos += 1
        for shift in (12, 6, 0):
            if pos < n and (data[pos] & 0xC0) == 0x80:
                cp |= (data[pos] & 0x3F) << shift
                pos += 1
            else:
                break
        return cp, pos
    return ord("?"), pos + 1


def utf8_chars(data: bytes) -> list[tuple[int, int, int]]:
    """Decode all characters; returns [(codepoint, byte_start, byte_len)]."""
    out = []
    pos = 0
    n = len(data)
    while pos < n:
        cp, nxt = utf8_next(data, pos)
        out.append((cp, pos, nxt - pos))
        pos = nxt
    return out


def utf8_encode(cp: int) -> bytes:
    """Encode a codepoint to UTF-8 (ctts.c:249-269)."""
    if cp < 0x80:
        return bytes((cp,))
    if cp < 0x800:
        return bytes((0xC0 | (cp >> 6), 0x80 | (cp & 0x3F)))
    if cp < 0x10000:
        return bytes((0xE0 | (cp >> 12), 0x80 | ((cp >> 6) & 0x3F), 0x80 | (cp & 0x3F)))
    return bytes((
        0xF0 | (cp >> 18),
        0x80 | ((cp >> 12) & 0x3F),
        0x80 | ((cp >> 6) & 0x3F),
        0x80 | (cp & 0x3F),
    ))


def unicode_tolower(cp: int) -> int:
    """Reference lowercase map: ASCII A-Z plus only É/Ó/Ô/Ç (ctts.c:238-246).

    Deliberately NOT full Unicode lowercasing — e.g. Á stays Á, exactly as
    the reference behaves.
    """
    if 0x41 <= cp <= 0x5A:  # 'A'..'Z'
        return cp + 32
    if cp == 0xC9:  # É -> é
        return 0xE9
    if cp == 0xD3:  # Ó -> ó
        return 0xF3
    if cp == 0xD4:  # Ô -> ô
        return 0xF4
    if cp == 0xC7:  # Ç -> ç
        return 0xE7
    return cp


def normalize_lowercase(text: bytes) -> bytes:
    """ctts_normalize: decode, selective-lowercase, re-encode (ctts.c:271-287)."""
    out = bytearray()
    pos = 0
    n = len(text)
    while pos < n:
        cp, pos = utf8_next(text, pos)
        out += utf8_encode(unicode_tolower(cp))
    return bytes(out)
