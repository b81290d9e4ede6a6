"""Deterministic synthetic voice-unit dataset.

The reference repo does not ship its recorded voice dataset (SURVEY.md:
file inventory note; .gitignore excludes /dataset/). Tests and benchmarks
therefore synthesize a deterministic dataset with the documented layout
(README.md:104-113):

    dataset/letters/wavs/*.wav   + dataset/letters/letters.txt
    dataset/syllables/wavs/*.wav + dataset/syllables/sillabes.txt

Each unit's waveform is a voiced harmonic tone (hash-seeded f0/duration)
with an optional consonant prefix (noise burst for plosives/fricatives),
at 22050 Hz int16 mono — enough structure for pitch estimation, silence
removal, and crossfading to exercise the full DSP path.

Copy of ctts_tpu/db/dataset.py for the PyTorch port: only the package
name in its imports and module references differs, and the C
reference is cited by its relative path.
"""

from __future__ import annotations

import os

import numpy as np

from ctts_tpu_torch.constants import SAMPLE_RATE
from ctts_tpu_torch.utils.textutil import fnv1a_hash
from ctts_tpu_torch.utils.wav import write_wav

LETTERS = list("abcdefghijklmnopqrstuvwxyz") + list("áàâãéêíóôõúç")

_CONSONANTS = list("bcdfgjklmnpqrstvxz")
_DIGRAPHS = ["ch", "lh", "nh", "qu", "gu", "rr", "ss"]
_CLUSTERS = ["pr", "br", "tr", "dr", "cr", "gr", "fr", "pl", "bl", "cl", "fl", "gl"]
_VOWELS = list("aeiou")
_ACCENT_VOWELS = list("áéíóúâêôãõ")

_PLOSIVES = set("ptkbdgcq")
_FRICATIVES = set("fvszxj")


def syllable_inventory() -> list[str]:
    """CV syllables over consonants/digraphs/clusters × vowels, plus
    accented-vowel combos and common codas."""
    syls: list[str] = []
    for c in _CONSONANTS + _DIGRAPHS + _CLUSTERS:
        for v in _VOWELS:
            syls.append(c + v)
    # Accented nuclei for the most common onsets.
    for c in "bcdfgjlmnprstvz":
        for v in _ACCENT_VOWELS:
            syls.append(c + v)
    # Common closed syllables / codas.
    for c in _CONSONANTS:
        for v in _VOWELS:
            for coda in "mnsrl":
                syls.append(c + v + coda)
    # Frequent standalone pieces.
    syls += ["ão", "ões", "em", "am", "um", "im", "om", "os", "as", "es", "ei",
             "ou", "ai", "au", "ão", "eu", "oi", "ui"]
    # Dedup preserving order.
    seen = set()
    out = []
    for s in syls:
        if s not in seen:
            seen.add(s)
            out.append(s)
    return out


def unit_waveform(text: str) -> np.ndarray:
    """Deterministic voiced waveform for a unit text.

    f0 and duration derive from the FNV hash of the text; consonant onsets
    get a short noise/attack prefix. Peak amplitude ~9000 so RMS
    normalization (target 3000, gain clamp 0.1-3.0) operates in-range.
    """
    h = fnv1a_hash(text.encode("utf-8"))
    rng = np.random.RandomState(h & 0x7FFFFFFF)

    f0 = 105.0 + (h % 97)  # 105..201 Hz
    dur_ms = 120 + (h >> 8) % 140  # 120..259 ms
    n = int(SAMPLE_RATE * dur_ms / 1000.0)
    t = np.arange(n, dtype=np.float64) / SAMPLE_RATE

    # Pitch drift + detuned (inharmonic) partials + a small noise floor:
    # perfectly harmonic stacks make the autocorrelation nearly equal at
    # lag L and 2L, so pitch-lag argmaxes sit on float near-ties that flip
    # across backends. Real speech is aperiodic enough not to; make the
    # synthetic units likewise.
    drift = 1.0 + 0.05 * np.sin(2 * np.pi * 1.7 * t + (h % 7))
    phase = np.cumsum(2 * np.pi * f0 * drift / SAMPLE_RATE)
    det2 = 1.003 + (h % 5) * 1e-3
    det3 = 0.995 - (h % 3) * 1e-3

    wave = (
        0.9 * np.sin(phase)
        + 0.45 * np.sin(det2 * 2 * phase + 0.5)
        + 0.22 * np.sin(det3 * 3 * phase + 1.1)
        + 0.08 * np.sin(4.02 * phase + 2.0)
    )
    wave += 0.015 * rng.randn(n)

    # Amplitude envelope: attack, sustain with slow AM, release.
    env = np.ones(n)
    attack = max(8, int(n * 0.06))
    release = max(8, int(n * 0.12))
    env[:attack] = np.linspace(0.0, 1.0, attack)
    env[-release:] = np.linspace(1.0, 0.0, release)
    env *= 1.0 - 0.12 * np.sin(2 * np.pi * 3.1 * t)

    first = text[0]
    if first in _PLOSIVES:
        # Silence gap + click + burst before voicing.
        gap = int(SAMPLE_RATE * 0.012)
        burst = int(SAMPLE_RATE * 0.018)
        pre = np.concatenate(
            [np.zeros(gap), rng.randn(burst) * np.linspace(1.0, 0.1, burst)]
        )
        wave = np.concatenate([pre * 0.6, wave * env])
    elif first in _FRICATIVES:
        fric = int(SAMPLE_RATE * 0.035)
        noise = rng.randn(fric)
        # crude high-pass: first difference
        noise = np.diff(noise, prepend=0.0) * 0.5
        wave = np.concatenate([noise * 0.5, wave * env])
    else:
        wave = wave * env

    peak = np.max(np.abs(wave)) or 1.0
    samples = np.clip(wave / peak * 9000.0, -32768, 32767)
    return samples.astype(np.int16)


def generate_dataset(root: str) -> tuple[int, int]:
    """Write the dataset tree; returns (n_letters, n_syllables)."""
    letters_dir = os.path.join(root, "letters", "wavs")
    syls_dir = os.path.join(root, "syllables", "wavs")
    os.makedirs(letters_dir, exist_ok=True)
    os.makedirs(syls_dir, exist_ok=True)

    def fname(i: int, text: str) -> str:
        return f"u{i:04d}"

    with open(os.path.join(root, "letters", "letters.txt"), "w",
              encoding="utf-8") as f:
        for i, ch in enumerate(LETTERS):
            name = fname(i, ch)
            write_wav(os.path.join(letters_dir, name + ".wav"),
                      unit_waveform(ch), SAMPLE_RATE)
            f.write(f"{name}|{ch}|{ch.upper()}\n")

    syls = syllable_inventory()
    # The reference spells the syllable index "sillabes.txt" (ctts.c:3959).
    with open(os.path.join(root, "syllables", "sillabes.txt"), "w",
              encoding="utf-8") as f:
        for i, s in enumerate(syls):
            name = fname(i, s)
            write_wav(os.path.join(syls_dir, name + ".wav"),
                      unit_waveform(s), SAMPLE_RATE)
            f.write(f"{name}|{s}|{s}\n")

    return len(LETTERS), len(syls)
