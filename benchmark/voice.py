"""The deterministic generated voice: 840 unit recordings at 22050 Hz.

Frozen copy of ctts_tpu_torch/db/dataset.py (LETTERS, the syllable
inventory, unit_waveform, generate_dataset) and of write_wav from
ctts_tpu_torch/utils/wav.py:76: only the imports differ. The upstream
engine does not ship its recorded dataset, so the benchmark makes one
with the documented layout (letters/ and syllables/, each a wavs/
directory and a `filename|text|display` index). The port builds its
voice.db from the files written here; the benchmark's reference reads
the same recordings (`units`), never the port's voice.db.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from benchmark.reference.constants import SAMPLE_RATE
from benchmark.reference.textutil import fnv1a_hash


def write_wav(path: str, samples: np.ndarray, sample_rate: int) -> None:
    """Write int16 mono PCM WAV, byte-identical to ctts_write_wav
    (ctts.c:809-848)."""
    samples = np.ascontiguousarray(samples, dtype="<i2")
    data_size = samples.nbytes
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + data_size))
        f.write(b"WAVE")
        f.write(b"fmt ")
        f.write(struct.pack("<IHHIIHH", 16, 1, 1, sample_rate, sample_rate * 2, 2, 16))
        f.write(b"data")
        f.write(struct.pack("<I", data_size))
        f.write(samples.tobytes())


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


def units() -> list[tuple[str, np.ndarray]]:
    """Every recording as (index text, int16 samples), in the order
    generate_dataset writes them: the letters, then the syllables."""
    return ([(ch, unit_waveform(ch)) for ch in LETTERS]
            + [(s, unit_waveform(s)) for s in syllable_inventory()])
