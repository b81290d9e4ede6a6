"""Pitch-search correlations: CUDA kernel, plain version, launch count.

Counterpart of ctts_tpu/ops/pallas/pitch.py:88 pitch_corr_components.
For each row it returns the exact integers, rounded once to f32,
    corr[lag] = sum_{i < L} s[i] * s[i + lag]
    e2[lag]   = sum_{i < L} s[i + lag]^2        lag = 0..275
of an int16-valued segment s [495] and its analysis length L (clamped
to [0, 220]). The Pallas kernel returns the same integers as six hi/lo
component sums; here they are int64 sums (csrc/pitch.cu).
"""

from __future__ import annotations

import torch

from ctts_tpu_torch.ops.hopper.build import check, launch

KERNEL = "pitch_corr"
SOURCE = "ctts_tpu_torch/csrc/pitch.cu"
REPLACES = "ctts_tpu/ops/pallas/pitch.py:88"
GLOBALS = ("pitch_corr_kernel",)

SPAN = 495   # PITCH_MAX_LAG + PITCH_ANALYSIS
ANA = 220    # PITCH_ANALYSIS
NLAG = 276   # lags 0..PITCH_MAX_LAG

launches = 0

_CHUNK = 256  # rows per int64 product block in the plain version


def pitch_corr_plain(seg: torch.Tensor, ana_len: torch.Tensor):
    """int64 unfold-and-sum over the 220-sample analysis window."""
    s = seg.to(torch.int64)
    n_ana = torch.clamp(ana_len.to(torch.int64), 0, ANA)
    mask = (torch.arange(ANA, device=seg.device)[None, :]
            < n_ana[:, None]).to(torch.int64)
    base = s[:, :ANA] * mask
    corr, e2 = [], []
    for lo in range(0, s.shape[0], _CHUNK):
        win = s[lo:lo + _CHUNK].unfold(1, ANA, 1)        # [c, 276, 220]
        corr.append((win * base[lo:lo + _CHUNK, None, :]).sum(-1))
        e2.append((win * win * mask[lo:lo + _CHUNK, None, :]).sum(-1))
    if not corr:
        z = torch.zeros(0, NLAG, dtype=torch.float32, device=seg.device)
        return z, z.clone()
    return (torch.cat(corr).to(torch.float32),
            torch.cat(e2).to(torch.float32))


def pitch_corr(seg: torch.Tensor, ana_len: torch.Tensor):
    """seg [n, 495] f32 (int16-valued), ana_len [n] i32 ->
    (corr [n, 276], e2 [n, 276]) f32. CPU tensors take the plain
    version; CUDA tensors the kernel."""
    global launches
    if seg.device.type == "cpu":
        return pitch_corr_plain(seg, ana_len)
    if seg.device.type != "cuda":
        raise ValueError(f"pitch_corr: unsupported device {seg.device}")
    n = seg.shape[0]
    check(seg, "seg", torch.float32, (n, SPAN), seg.device)
    check(ana_len, "ana_len", torch.int32, (n,), seg.device)
    corr = torch.empty(n, NLAG, dtype=torch.float32, device=seg.device)
    e2 = torch.empty(n, NLAG, dtype=torch.float32, device=seg.device)
    launch("ctts_pitch_corr", seg.device, seg.data_ptr(),
           ana_len.data_ptr(), corr.data_ptr(), e2.data_ptr(), n)
    launches += 1
    return corr, e2
