"""Configuration system with exact parity to the C reference.

Parity sources: CTTSConfig ctts.h:44-77; defaults ctts.c:1190-1212.
The benchmark builds it from a configuration file's "config" keys, so the
port's config-file parser (ctts.c:1215-1311) is not copied.

Frozen copy of ctts_tpu_torch/config.py for the benchmark's reference
(benchmark/reference/): only the imports differ, so that a later
change to the port cannot move what the benchmark compares with.
"""

from __future__ import annotations

import dataclasses

from benchmark.reference.constants import (
    DEFAULT_CROSSFADE_MS,
    DEFAULT_FADE_IN_MS,
    DEFAULT_FADE_OUT_MS,
    DEFAULT_SPEED,
    DEFAULT_UNKNOWN_SILENCE_MS,
    DEFAULT_WORD_PAUSE_MS,
    MAX_SPEED,
    MIN_SPEED,
)


@dataclasses.dataclass
class CTTSConfig:
    """All runtime configuration (ctts.h:44-77). Field order mirrors the C
    struct; float fields are stored as Python floats but consumed as f32."""

    # Audio concatenation
    crossfade_ms: float = DEFAULT_CROSSFADE_MS
    crossfade_vowel_ms: float = 45.0
    crossfade_s_ending_ms: float = 30.0
    crossfade_r_ending_ms: float = 30.0
    vowel_to_consonant_factor: float = 0.5
    word_pause_ms: float = DEFAULT_WORD_PAUSE_MS
    unknown_silence_ms: float = DEFAULT_UNKNOWN_SILENCE_MS
    fade_in_ms: float = DEFAULT_FADE_IN_MS
    fade_out_ms: float = DEFAULT_FADE_OUT_MS

    # Silence removal within words
    remove_word_silence: bool = True
    silence_threshold: float = 0.02
    min_silence_ms: float = 15.0

    # Processing
    remove_dc_offset: bool = True
    normalize_level: float = 0.0
    compression: float = 0.0

    # Synthesis
    default_speed: float = DEFAULT_SPEED
    min_speed: float = MIN_SPEED
    max_speed: float = MAX_SPEED

    # Prosody limits
    max_pitch_change: float = 0.10

    # Debug
    print_units: bool = False
    print_timing: bool = False


def config_defaults() -> CTTSConfig:
    """Compiled defaults (ctts.c:1190-1212)."""
    return CTTSConfig()

