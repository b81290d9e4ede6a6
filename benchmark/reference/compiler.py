"""Synthesis-plan compiler: text → ordered numeric op list.

This is the host-side half of the TPU split (SURVEY.md §7): it walks the
normalized text exactly like the reference's synthesis main loop
(ctts.c:3689-3871) but performs *no* DSP — it only decides, statically,
which units are appended with which crossfades, where pauses and word/DSP
boundaries fall, and which prosody parameters apply. Executors (the NumPy
oracle, the C++ native engine, and the JAX device path) then run the plan.

All ms→samples conversions reproduce the reference's float32 arithmetic
with C truncation.

Frozen copy of ctts_tpu_torch/plan/compiler.py for the benchmark's reference
(benchmark/reference/): only the imports differ and the rules argument
is gone (no benchmark configuration has a rule file), so that a later
change to the port cannot move what the benchmark compares with.
"""

from __future__ import annotations

import dataclasses
import enum
import sys
from typing import Optional

import numpy as np

from benchmark.reference.config import CTTSConfig
from benchmark.reference.constants import SAMPLE_RATE, TARGET_RMS
from benchmark.reference.units import UnitTable as VoiceDatabase
from benchmark.reference.select import find_best_match_with_lookahead
from benchmark.reference.normalize import normalize_pipeline
from benchmark.reference.phonology import (
    PhonemeType,
    classify_first_phoneme,
    classify_last_phoneme,
    ends_with_r,
    ends_with_s,
    get_adaptive_crossfade,
)
from benchmark.reference.prosody import (
    ProsodyContext,
    analyze_prosody,
    get_punctuation_pause_ms,
    is_sentence_end,
)
from benchmark.reference.textutil import utf8_char_len

F32 = np.float32


def ms_to_samples(ms: float) -> int:
    """(size_t)(ms * CTTS_SAMPLE_RATE / 1000.0f) with f32 order
    (e.g. ctts.c:3666-3667)."""
    return int(np.trunc(F32(ms) * F32(SAMPLE_RATE) / F32(1000.0)))


class OpKind(enum.IntEnum):
    UNIT = 0        # append unit with crossfade
    SILENCE = 1     # append zeros
    WORD_DSP = 2    # silence removal + intonation over the open word region
    FADE_TAIL = 3   # fade out the buffer tail
    MARK_WORD = 4   # word_start = current buffer count


@dataclasses.dataclass
class PlanOp:
    kind: OpKind
    # UNIT
    unit_idx: int = -1
    crossfade_samples: int = 0
    after_word_boundary: bool = False
    smooth_boundary: bool = False
    # SILENCE
    n_samples: int = 0
    # WORD_DSP
    word_index: int = 0
    # FADE_TAIL
    fade_samples: int = 0
    # MARK_WORD: emitted by sentence-end punctuation (vs whitespace) —
    # the legal split point for host-side sentence splitting (plan.split).
    sentence_end: bool = False


@dataclasses.dataclass
class SynthesisPlan:
    ops: list[PlanOp]
    prosody: ProsodyContext
    config: CTTSConfig
    speed: float
    normalized_text: bytes
    units_found: int
    units_missing: int
    unit_texts: list[bytes]
    # Precomputed sample counts (f32 semantics)
    word_pause_samples: int
    unknown_silence_samples: int
    min_silence_samples: int
    fade_in_samples: int
    fade_out_samples: int
    target_rms: float = TARGET_RMS
    # Pre-removal running sentence length at the start of this plan's ops.
    # 0 for a whole utterance; sentence splitting (plan.split) sets it so
    # each row's baked analysis/boundary caps match the unsplit walk.
    buf_total0: int = 0


_WHITESPACE = (0x20, 0x09, 0x0A, 0x0D)
_PUNCT = tuple(ord(c) for c in ",;:.!?")
_SKIP = tuple(ord(c) for c in "()[]\"'`")


def compile_plan(
    db: VoiceDatabase,
    text: bytes | str,
    config: CTTSConfig,
    speed: float = 1.0,
    print_units: Optional[bool] = None,
) -> SynthesisPlan:
    """Compile one utterance into a synthesis plan (mirror of
    ctts_synthesize's control flow, ctts.c:3623-3898)."""
    if isinstance(text, str):
        text = text.encode("utf-8")

    prosody = analyze_prosody(text, config.max_pitch_change)
    normalized = normalize_pipeline(text)

    word_pause_samples = ms_to_samples(config.word_pause_ms)
    unknown_silence = ms_to_samples(config.unknown_silence_ms)
    min_silence_samples = ms_to_samples(config.min_silence_ms)
    fade_in_samples = ms_to_samples(config.fade_in_ms)
    fade_out_samples = ms_to_samples(config.fade_out_ms)

    ops: list[PlanOp] = []
    unit_texts: list[bytes] = []
    units_found = 0
    units_missing = 0

    pos = 0
    n = len(normalized)
    prev_unit_text: Optional[bytes] = None
    prev_was_word_boundary = True
    prev_end_phoneme = PhonemeType.OTHER
    current_word_index = 0
    do_print = config.print_units if print_units is None else print_units

    while pos < n:
        c = normalized[pos]

        if c in _WHITESPACE:
            ops.append(PlanOp(OpKind.WORD_DSP, word_index=current_word_index))
            ops.append(PlanOp(OpKind.FADE_TAIL, fade_samples=fade_out_samples))
            ops.append(PlanOp(OpKind.SILENCE, n_samples=word_pause_samples))
            ops.append(PlanOp(OpKind.MARK_WORD))
            current_word_index += 1
            pos += 1
            prev_was_word_boundary = True
            prev_unit_text = None
            prev_end_phoneme = PhonemeType.OTHER
            continue

        if c == ord("-"):
            # Soft separator: no pause, crossfade continuity preserved
            # (ctts.c:3736-3741).
            pos += 1
            continue

        if c in _PUNCT:
            pause_ms = get_punctuation_pause_ms(c, config.word_pause_ms)
            pause_samples = ms_to_samples(pause_ms)
            ops.append(PlanOp(OpKind.FADE_TAIL, fade_samples=fade_out_samples))
            if pause_samples > 0:
                ops.append(PlanOp(OpKind.SILENCE, n_samples=pause_samples))
            if is_sentence_end(c):
                current_word_index = 0
                ops.append(PlanOp(OpKind.MARK_WORD, sentence_end=True))
            pos += 1
            prev_was_word_boundary = True
            continue

        if c in _SKIP:
            pos += 1
            continue

        match_len, unit_idx = find_best_match_with_lookahead(
            db, normalized, pos, db.max_unit_chars, prev_was_word_boundary
        )

        if match_len > 0 and unit_idx >= 0:
            unit_text = db.unit_text(unit_idx)
            if do_print:
                print(f"  [{unit_text.decode('utf-8', 'replace')}] ",
                      end="", file=sys.stderr)

            curr_start = classify_first_phoneme(unit_text)
            curr_end = classify_last_phoneme(unit_text)

            if not prev_was_word_boundary and prev_unit_text is not None:
                crossfade_ms = get_adaptive_crossfade(
                    prev_end_phoneme, curr_start, config
                )
                if ends_with_s(prev_unit_text) and F32(crossfade_ms) > F32(
                    config.crossfade_s_ending_ms
                ):
                    crossfade_ms = config.crossfade_s_ending_ms
                elif ends_with_r(prev_unit_text) and F32(crossfade_ms) > F32(
                    config.crossfade_r_ending_ms
                ):
                    crossfade_ms = config.crossfade_r_ending_ms
            else:
                crossfade_ms = config.crossfade_ms

            ops.append(
                PlanOp(
                    OpKind.UNIT,
                    unit_idx=unit_idx,
                    crossfade_samples=ms_to_samples(crossfade_ms),
                    after_word_boundary=prev_was_word_boundary,
                    smooth_boundary=not prev_was_word_boundary,
                )
            )
            unit_texts.append(unit_text)

            prev_unit_text = unit_text
            prev_end_phoneme = curr_end
            prev_was_word_boundary = False
            pos += match_len
            units_found += 1
        else:
            ops.append(PlanOp(OpKind.SILENCE, n_samples=unknown_silence))
            pos += utf8_char_len(normalized, pos)
            units_missing += 1
            prev_unit_text = None
            prev_end_phoneme = PhonemeType.OTHER

    if do_print:
        print(file=sys.stderr)

    # Trailing word: silence removal + intonation + final fade
    # (ctts.c:3877-3904).
    ops.append(PlanOp(OpKind.WORD_DSP, word_index=current_word_index))
    ops.append(PlanOp(OpKind.FADE_TAIL, fade_samples=fade_out_samples))

    return SynthesisPlan(
        ops=ops,
        prosody=prosody,
        config=config,
        speed=speed,
        normalized_text=normalized,
        units_found=units_found,
        units_missing=units_missing,
        unit_texts=unit_texts,
        word_pause_samples=word_pause_samples,
        unknown_silence_samples=unknown_silence,
        min_silence_samples=min_silence_samples,
        fade_in_samples=fade_in_samples,
        fade_out_samples=fade_out_samples,
    )
