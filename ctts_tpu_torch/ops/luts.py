"""Fade lookup tables (ctts_tpu/ops/luts.py; parity: ctts.c:52-101).

The tables are the oracle's (the port's copy, synth/dsp_np.py) and are
uploaded once per device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ctts_tpu_torch.constants import FADE_LUT_SIZE
from ctts_tpu_torch.synth.dsp_np import (
    FADE_IN_LUT,
    FADE_OUT_LUT,
    SINE_FADE_LUT,
)

_TABLES = {"fade_out": FADE_OUT_LUT, "fade_in": FADE_IN_LUT,
           "sine_fade": SINE_FADE_LUT}


@functools.lru_cache(maxsize=None)
def _table(name: str, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_TABLES[name], dtype=torch.float32, device=device)


def _lut_lookup(name: str, t: torch.Tensor) -> torch.Tensor:
    """fast_fade_* LUT lookup with linear interpolation (ctts.c:76-101)."""
    lut = _table(name, t.device)
    t = t.to(torch.float32)
    idx_f = t * float(FADE_LUT_SIZE - 1)
    idx = idx_f.to(torch.int32)
    hi = idx >= FADE_LUT_SIZE - 1
    lo = idx < 0
    idx_c = torch.clamp(idx, 0, FADE_LUT_SIZE - 2).long()
    frac = idx_f - idx_c.to(torch.float32)
    val = lut[idx_c] * (1.0 - frac) + lut[idx_c + 1] * frac
    val = torch.where(hi, lut[FADE_LUT_SIZE - 1], val)
    return torch.where(lo, lut[0], val)


def sine_fade_table(device: torch.device) -> torch.Tensor:
    """The sine-fade table on `device`, as sine_fade_gain reads it."""
    return _table("sine_fade", device)


def fade_out_table(device: torch.device) -> torch.Tensor:
    return _table("fade_out", device)


def fade_in_table(device: torch.device) -> torch.Tensor:
    return _table("fade_in", device)


def fade_out_gain(t: torch.Tensor) -> torch.Tensor:
    return _lut_lookup("fade_out", t)


def fade_in_gain(t: torch.Tensor) -> torch.Tensor:
    return _lut_lookup("fade_in", t)


def sine_fade_gain(t: torch.Tensor) -> torch.Tensor:
    return _lut_lookup("sine_fade", t)


@functools.lru_cache(maxsize=None)
def hann(n: int, device: torch.device) -> torch.Tensor:
    """Periodic Hann window, computed in f32 exactly as the JAX table."""
    i = np.arange(n, dtype=np.float32)
    w = np.float32(0.5) * (
        np.float32(1.0)
        - np.cos(np.float32(2.0) * np.float32(np.pi) * i / np.float32(n),
                 dtype=np.float32)
    )
    return torch.as_tensor(w.astype(np.float32), device=device)
