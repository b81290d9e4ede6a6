"""Phrase-level prosody: phrase-type detection and intonation contours.

Parity sources: PhraseType ctts.c:2526-2532; clamp ctts.c:2589-2595;
scale-to-limit ctts.c:2611-2635; contour tables ctts.c:2638-2721;
analyze_prosody ctts.c:2883-2933; punctuation pauses ctts.c:690-714.

All pitch/energy math is done in float32 downstream; this module computes
only scalar parameters, which feed the device-side intonation kernel.

Frozen copy of ctts_tpu_torch/text/prosody.py for the benchmark's reference
(benchmark/reference/): only the imports differ, so that a later
change to the port cannot move what the benchmark compares with.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np


class PhraseType(enum.IntEnum):
    DECLARATIVE = 0
    INTERROGATIVE = 1
    EXCLAMATORY = 2
    CONTINUATION = 3
    LISTING = 4


def clamp_pitch(pitch: float, max_change: float) -> float:
    """Clamp a pitch factor into [1-max, 1+max] (ctts.c:2589-2595).
    Computed in float32 to match the C arithmetic."""
    lo = np.float32(1.0) - np.float32(max_change)
    hi = np.float32(1.0) + np.float32(max_change)
    p = np.float32(pitch)
    if p < lo:
        return float(lo)
    if p > hi:
        return float(hi)
    return float(p)


@dataclasses.dataclass
class PhraseIntonation:
    type: PhraseType
    pitch_start: float
    pitch_end: float
    pitch_peak: float
    peak_position: float
    energy_factor: float
    final_lengthening: float


_TABLES = {
    PhraseType.INTERROGATIVE: (0.98, 1.08, 1.18, 0.75, 1.05, 1.25),
    PhraseType.EXCLAMATORY: (1.18, 0.88, 1.22, 0.15, 1.25, 1.15),
    PhraseType.CONTINUATION: (1.0, 1.12, 1.08, 0.7, 0.95, 1.20),
    PhraseType.LISTING: (1.0, 1.06, 1.12, 0.55, 1.0, 1.10),
    PhraseType.DECLARATIVE: (1.04, 0.88, 1.04, 0.08, 1.0, 1.18),
}


def get_phrase_intonation(ptype: PhraseType) -> PhraseIntonation:
    """Contour parameter table (ctts.c:2638-2721)."""
    row = _TABLES.get(ptype, _TABLES[PhraseType.DECLARATIVE])
    return PhraseIntonation(ptype, *row)


def scale_intonation_to_limit(inton: PhraseIntonation, max_change: float) -> None:
    """Scale the contour toward 1.0 so the largest deviation fits the limit
    (ctts.c:2611-2635). float32 arithmetic."""
    if max_change <= 0.0:
        return
    mc = np.float32(max_change)
    one = np.float32(1.0)
    ps = np.float32(inton.pitch_start)
    pe = np.float32(inton.pitch_end)
    pp = np.float32(inton.pitch_peak)
    max_dev = max(abs(ps - one), abs(pe - one), abs(pp - one))
    if max_dev <= mc:
        return
    scale = mc / np.float32(max_dev)
    inton.pitch_start = float(one + (ps - one) * scale)
    inton.pitch_end = float(one + (pe - one) * scale)
    inton.pitch_peak = float(one + (pp - one) * scale)


def get_phrase_intonation_limited(
    ptype: PhraseType, max_pitch_change: float
) -> PhraseIntonation:
    inton = get_phrase_intonation(ptype)
    scale_intonation_to_limit(inton, max_pitch_change)
    return inton


@dataclasses.dataclass
class ProsodyContext:
    is_question: bool
    is_exclamation: bool
    word_count: int
    pitch_modifier: float
    duration_modifier: float
    phrase_type: PhraseType
    intonation: PhraseIntonation


def analyze_prosody(text: bytes, max_pitch_change: float) -> ProsodyContext:
    """Word count + phrase type from the *raw* input text (ctts.c:2883-2933).

    Note the reference scans backward for the first non-space byte; only
    that byte decides the phrase type for the entire utterance, even for
    multi-sentence inputs.
    """
    ctx = ProsodyContext(
        is_question=False,
        is_exclamation=False,
        word_count=0,
        pitch_modifier=1.0,
        duration_modifier=1.0,
        phrase_type=PhraseType.DECLARATIVE,
        intonation=None,  # type: ignore[arg-type]
    )

    if len(text) == 0:
        ctx.intonation = get_phrase_intonation_limited(
            ctx.phrase_type, max_pitch_change
        )
        return ctx

    in_word = False
    for b in text:
        if b in (0x20, 0x09, 0x0A):  # space, tab, newline
            in_word = False
        elif not in_word:
            in_word = True
            ctx.word_count += 1

    for i in range(len(text), 0, -1):
        c = text[i - 1]
        if c == ord("?"):
            ctx.is_question = True
            ctx.phrase_type = PhraseType.INTERROGATIVE
            ctx.pitch_modifier = clamp_pitch(1.05, max_pitch_change)
            break
        if c == ord("!"):
            ctx.is_exclamation = True
            ctx.phrase_type = PhraseType.EXCLAMATORY
            ctx.pitch_modifier = clamp_pitch(1.08, max_pitch_change)
            break
        if c in (ord(","), ord(";")):
            ctx.phrase_type = PhraseType.CONTINUATION
            break
        if c not in (0x20, 0x09, 0x0A):
            ctx.phrase_type = PhraseType.DECLARATIVE
            break

    ctx.intonation = get_phrase_intonation_limited(ctx.phrase_type, max_pitch_change)
    return ctx


def get_punctuation_pause_ms(punct: int, word_pause_ms: float) -> float:
    """Per-punctuation pause as a multiplier of word_pause_ms
    (ctts.c:690-709)."""
    table = {
        ord(","): 1.8,
        ord(";"): 2.2,
        ord(":"): 2.0,
        ord("."): 3.0,
        ord("!"): 3.2,
        ord("?"): 3.0,
        ord("-"): 0.0,
    }
    mult = table.get(punct, 1.0)
    return float(np.float32(word_pause_ms) * np.float32(mult))


def is_sentence_end(c: int) -> bool:
    """ctts.c:712-714."""
    return c in (ord("."), ord("!"), ord("?"))
