"""Configuration system with exact parity to the C reference.

The reference parses `config.yaml` as a *flat* key:value file — section
headers ("audio:", "prosody:") are read like any other line but match no
known key, so nesting is effectively ignored (ctts.c:1215-1292). Precedence
is defaults < config.yaml < CLI (ctts.c:3976-3995).

Parity sources: CTTSConfig ctts.h:44-77; defaults ctts.c:1190-1212;
parser ctts.c:1215-1311.

Copy of ctts_tpu/config.py for the PyTorch port: only the package
name in its imports and module references differs, and the C
reference is cited by its relative path.
"""

from __future__ import annotations

import dataclasses
import os
import re

from ctts_tpu_torch.constants import (
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


_FLOAT_KEYS = {
    "crossfade_ms",
    "crossfade_vowel_ms",
    "crossfade_s_ending_ms",
    "crossfade_r_ending_ms",
    "vowel_to_consonant_factor",
    "word_pause_ms",
    "unknown_silence_ms",
    "fade_in_ms",
    "fade_out_ms",
    "silence_threshold",
    "min_silence_ms",
    "normalize_level",
    "compression",
    "default_speed",
    "min_speed",
    "max_speed",
    "max_pitch_change",
}

_BOOL_KEYS = {
    "remove_word_silence",
    "remove_dc_offset",
    "print_units",
    "print_timing",
}


_STRTOF_RE = re.compile(r"^[ \t]*[+-]?(\d+(\.\d*)?|\.\d+)([eE][+-]?\d+)?")


def _strtof(value: str) -> float:
    """C strtof: parse the longest valid float prefix, else 0.0
    (ctts.c:1250 et al.)."""
    m = _STRTOF_RE.match(value)
    if not m:
        return 0.0
    return float(m.group(0))


def parse_config_line(config: CTTSConfig, line: str) -> None:
    """Parse one `key: value` line (ctts.c:1215-1292).

    Comments, blank lines, and lines without ':' are ignored. Booleans are
    true iff the value is exactly "true" or "1"."""
    s = line.lstrip(" \t")
    if not s or s[0] in "#\n":
        return
    colon = s.find(":")
    if colon < 0:
        return
    # C copies at most 63 chars of key and value (ctts.c:1221-1246).
    key = s[:colon][:63].strip(" \t")
    value = s[colon + 1 :].lstrip(" \t")[:63].rstrip(" \t\n\r")

    if key in _FLOAT_KEYS:
        setattr(config, key, _strtof(value))
    elif key in _BOOL_KEYS:
        setattr(config, key, value in ("true", "1"))


def load_config(config_file: str | os.PathLike) -> CTTSConfig:
    """Defaults overlaid with the flat key:value file; a missing file means
    pure defaults (ctts.c:1294-1311)."""
    config = config_defaults()
    try:
        f = open(config_file, "r", encoding="utf-8", errors="surrogateescape")
    except OSError:
        return config
    with f:
        for line in f:
            # C reads 255-char lines; longer lines get split mid-way. The
            # split fragments parse as garbage keys and are ignored, so
            # truncating to the same window is behaviorally equivalent.
            parse_config_line(config, line)
    return config
