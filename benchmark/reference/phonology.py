"""Portuguese phonotactics: vowel sets, digraphs, onset clusters, syllable
scoring, and phoneme classification for adaptive crossfades.

Parity sources: is_vowel ctts.c:3042-3064; digraphs ctts.c:3146-3164;
clusters ctts.c:3167-3190; single-consonant rejection ctts.c:3193-3217;
syllable score ctts.c:3220-3268; phoneme classes ctts.c:1765-1854;
adaptive crossfade ctts.c:1857-1892; S/R suffix tests ctts.c:3084-3115.

Frozen copy of ctts_tpu_torch/text/phonology.py for the benchmark's reference
(benchmark/reference/): only the imports differ, so that a later
change to the port cannot move what the benchmark compares with.
"""

from __future__ import annotations

import enum

from benchmark.reference.textutil import utf8_char_len, utf8_next

# Portuguese vowels incl. accented forms (ctts.c:3042-3064)
_VOWEL_CPS = frozenset(
    [ord(c) for c in "aeiouAEIOU"]
    + [
        0xE1, 0xC1,  # á Á
        0xE0, 0xC0,  # à À
        0xE2, 0xC2,  # â Â
        0xE3, 0xC3,  # ã Ã
        0xE9, 0xC9,  # é É
        0xEA, 0xCA,  # ê Ê
        0xED, 0xCD,  # í Í
        0xF3, 0xD3,  # ó Ó
        0xF4, 0xD4,  # ô Ô
        0xF5, 0xD5,  # õ Õ
        0xFA, 0xDA,  # ú Ú
        0xFC, 0xDC,  # ü Ü
    ]
)


def is_vowel(cp: int) -> bool:
    return cp in _VOWEL_CPS


def is_pt_consonant(cp: int) -> bool:
    """Lowercased letter that is not a vowel, or ç (ctts.c:3138-3143)."""
    if ord("A") <= cp <= ord("Z"):
        cp += 32
    if cp == 0xC7:
        cp = 0xE7
    return (ord("a") <= cp <= ord("z") and not is_vowel(cp)) or cp == 0xE7


def _lower_ascii(b: int) -> int:
    if ord("A") <= b <= ord("Z"):
        return b + 32
    return b


def is_pt_digraph(text: bytes) -> bool:
    """ch/lh/nh/qu/gu on the first two *bytes* (ctts.c:3146-3164)."""
    if len(text) < 2:
        return False
    c1 = _lower_ascii(text[0])
    c2 = _lower_ascii(text[1])
    return (c1, c2) in (
        (ord("c"), ord("h")),
        (ord("l"), ord("h")),
        (ord("n"), ord("h")),
        (ord("q"), ord("u")),
        (ord("g"), ord("u")),
    )


def is_pt_valid_cluster(text: bytes) -> bool:
    """Obstruent+liquid onsets: pr/br/tr/dr/cr/gr/fr/vr, pl/bl/cl/gl/fl
    (ctts.c:3167-3190)."""
    if len(text) < 2:
        return False
    c1 = _lower_ascii(text[0])
    c2 = _lower_ascii(text[1])
    if c2 == ord("r"):
        return c1 in (ord("p"), ord("b"), ord("t"), ord("d"),
                      ord("c"), ord("g"), ord("f"), ord("v"))
    if c2 == ord("l"):
        return c1 in (ord("p"), ord("b"), ord("c"), ord("g"), ord("f"))
    return False


def pt_reject_single_consonant(text: bytes, pos: int, match_char_count: int,
                               at_word_start: bool) -> bool:
    """Reject invalid single-consonant matches (ctts.c:3193-3217)."""
    if match_char_count != 1:
        return False
    cp, nxt = utf8_next(text, pos)
    if is_vowel(cp):
        return False
    if at_word_start:
        return True
    # Mid-word: reject if this consonant starts a digraph with the next byte.
    # The C truncates the codepoint to a char when building the test pair
    # (ctts.c:3209-3213); replicate with & 0xFF.
    if nxt < len(text) and text[nxt] != 0:
        c0 = (cp + 32 if ord("A") <= cp <= ord("Z") else cp) & 0xFF
        pair = bytes((c0, _lower_ascii(text[nxt])))
        if is_pt_digraph(pair):
            return True
    return False


def pt_syllable_score(chunk: bytes, char_count: int, at_word_start: bool) -> int:
    """Syllable quality score (ctts.c:3220-3268): 10/char, +20 digraph,
    +15 valid cluster, +25 CV at word start, −100 lone consonant at word
    start, +10 open syllable."""
    score = char_count * 10
    if char_count == 0:
        return -1000

    first_cp, p = utf8_next(chunk, 0)
    first_is_consonant = is_pt_consonant(first_cp)

    if char_count >= 2:
        if is_pt_digraph(chunk):
            score += 20
        if first_is_consonant and is_pt_valid_cluster(chunk):
            score += 15

    if at_word_start and first_is_consonant:
        if char_count == 1:
            score -= 100
        elif p < len(chunk):
            second_cp, _ = utf8_next(chunk, p)
            if is_vowel(second_cp):
                score += 25

    # Last character → open-syllable bonus.
    last_cp = 0
    q = 0
    while q < len(chunk):
        last_cp, q = utf8_next(chunk, q)
    if is_vowel(last_cp):
        score += 10

    return score


class PhonemeType(enum.IntEnum):
    """ctts.c:1765-1772."""
    VOWEL = 0
    PLOSIVE = 1
    FRICATIVE = 2
    NASAL = 3
    LIQUID = 4
    OTHER = 5


def classify_first_phoneme(text: bytes) -> PhonemeType:
    """ctts.c:1775-1814."""
    if len(text) == 0:
        return PhonemeType.OTHER
    c = _lower_ascii(text[0])
    cp, _ = utf8_next(text, 0)
    if is_vowel(cp):
        return PhonemeType.VOWEL
    if c in (ord("p"), ord("t"), ord("k"), ord("b"), ord("d"), ord("g")):
        return PhonemeType.PLOSIVE
    if c in (ord("f"), ord("v"), ord("s"), ord("z"), ord("x"), ord("j")):
        return PhonemeType.FRICATIVE
    if len(text) >= 2 and c == ord("c") and text[1] in (ord("h"), ord("H")):
        return PhonemeType.FRICATIVE
    if c in (ord("m"), ord("n")):
        return PhonemeType.NASAL
    if c in (ord("l"), ord("r")):
        return PhonemeType.LIQUID
    return PhonemeType.OTHER


def classify_last_phoneme(text: bytes) -> PhonemeType:
    """ctts.c:1817-1854."""
    if len(text) == 0:
        return PhonemeType.OTHER

    # Find the last UTF-8 character start.
    p = 0
    last = 0
    while p < len(text):
        last = p
        p += utf8_char_len(text, p)
    cp, _ = utf8_next(text, last)
    if is_vowel(cp):
        return PhonemeType.VOWEL

    c = _lower_ascii(text[-1])
    if len(text) >= 2:
        c2 = _lower_ascii(text[-2])
        if c2 == ord("l") and c == ord("h"):
            return PhonemeType.LIQUID
        if c2 == ord("n") and c == ord("h"):
            return PhonemeType.NASAL
        if c2 == ord("c") and c == ord("h"):
            return PhonemeType.FRICATIVE

    if c in (ord("p"), ord("t"), ord("k"), ord("b"), ord("d"), ord("g")):
        return PhonemeType.PLOSIVE
    if c in (ord("f"), ord("v"), ord("s"), ord("z"), ord("x"), ord("j")):
        return PhonemeType.FRICATIVE
    if c in (ord("m"), ord("n")):
        return PhonemeType.NASAL
    if c in (ord("l"), ord("r")):
        return PhonemeType.LIQUID
    return PhonemeType.OTHER


def get_adaptive_crossfade(prev_end: PhonemeType, next_start: PhonemeType,
                           config) -> float:
    """Phoneme-aware crossfade duration in ms (ctts.c:1857-1892).
    float32 arithmetic, matching the C expressions."""
    import numpy as np

    base = np.float32(config.crossfade_ms)
    if next_start == PhonemeType.PLOSIVE:
        return float(base * np.float32(0.2))
    if prev_end == PhonemeType.PLOSIVE:
        return float(base * np.float32(0.3))
    if next_start == PhonemeType.FRICATIVE or prev_end == PhonemeType.FRICATIVE:
        return float(base * np.float32(0.4))
    if prev_end == PhonemeType.VOWEL and next_start == PhonemeType.VOWEL:
        return float(np.float32(config.crossfade_vowel_ms))
    if prev_end == PhonemeType.VOWEL and next_start != PhonemeType.VOWEL:
        return float(base * np.float32(config.vowel_to_consonant_factor))
    if prev_end in (PhonemeType.NASAL, PhonemeType.LIQUID) or next_start in (
        PhonemeType.NASAL,
        PhonemeType.LIQUID,
    ):
        return float(base * np.float32(0.7))
    return float(base)


def _last_cp(text: bytes) -> int:
    p = 0
    last = 0
    while p < len(text):
        last = p
        p += utf8_char_len(text, p)
    if not text:
        return 0
    cp, _ = utf8_next(text, last)
    return cp


def ends_with_s(text: bytes) -> bool:
    """ctts.c:3084-3098."""
    return len(text) > 0 and _last_cp(text) in (ord("s"), ord("S"))


def ends_with_r(text: bytes) -> bool:
    """ctts.c:3101-3115."""
    return len(text) > 0 and _last_cp(text) in (ord("r"), ord("R"))
