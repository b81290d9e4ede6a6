"""Pitch-search correlations and estimate_pitch_batch of ctts_tpu_torch
against the JAX package.

The plain int64 correlation sums must equal combine_exact over the
Pallas kernel's six component sums (interpret mode), and the port's
estimate_pitch_batch must return the same pitches, bit for bit, as the
JAX function under both of its CPU backends (grouped conv, Pallas
interpret). The two identities the CUDA kernel rests on are rebuilt in
numpy and held to the plain version on rows at the int16 extremes and
at L = 0, 1 and 220: e2 as a difference of two prefix sums of squares,
and corr as dp4a sums on int16 byte planes in the kernel's lane layout,
every partial sum inside int32. The card-only test holds the CUDA
kernel to the plain version.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ctts_tpu.ops import device_ops as jdops
from ctts_tpu.ops.exact import combine_exact, split_hi_lo
from ctts_tpu.ops.pallas.pitch import KW, SEGW, pitch_corr_components
from ctts_tpu_torch.ops import device_ops as tdops
from ctts_tpu_torch.ops.hopper import pitch as hpitch

SPAN = jdops._PITCH_SPAN


@pytest.fixture(scope="module")
def seg_data():
    """Noise, strongly periodic rows (argmax near-ties), all-zero rows,
    rows clipped at +-32767/-32768, and short or degenerate counts."""
    rng = np.random.default_rng(7)
    n = 48
    segs = rng.integers(-5000, 5000, (n, SPAN)).astype(np.float32)
    t = np.arange(SPAN)
    for r in range(0, n, 3):
        segs[r] = np.round(3000 * np.sin(2 * np.pi * t / (55 + (r * 7) % 200)))
    segs[4] = 0.0
    segs[5] = np.where(segs[5] >= 0, 32767.0, -32768.0)
    segs[7] = np.clip(segs[7] * 40, -32768, 32767)
    counts = rng.integers(0, 450, n).astype(np.int32)
    counts[:8] = [0, 100, 200, 449, 300, 495, 109, 110]
    return segs, counts


def test_plain_sums_equal_pallas_components(seg_data):
    segs, counts = seg_data
    n = segs.shape[0]
    max_lag = np.minimum(275, counts // 2)
    ana = np.minimum(220, counts - max_lag).astype(np.int32)
    mask = (np.arange(220)[None, :] < ana[:, None]).astype(np.float32)
    base = segs[:, :220] * mask
    bh, bl = split_hi_lo(jnp.asarray(base))
    pad = jnp.zeros((n, KW - 220), jnp.float32)
    segp = jnp.concatenate(
        [jnp.asarray(segs), jnp.zeros((n, SEGW - SPAN), jnp.float32)], 1)
    chh, cmid, cll, ehh, ehl, ell = pitch_corr_components(
        segp, jnp.concatenate([bh, pad], 1), jnp.concatenate([bl, pad], 1),
        jnp.concatenate([jnp.asarray(mask), pad], 1), interpret=True)
    corr_want = np.asarray(combine_exact(chh, cmid, cll, 256.0))[:, :276]
    e2_want = np.asarray(combine_exact(ehh, ehl, ell, 512.0))[:, :276]
    corr, e2 = hpitch.pitch_corr(torch.as_tensor(segs), torch.as_tensor(ana))
    assert hpitch.launches == 0          # a CPU tensor takes the plain path
    assert np.array_equal(corr.numpy(), corr_want)
    assert np.array_equal(e2.numpy(), e2_want)


@pytest.mark.parametrize("backend", ["conv", "pallas_interpret"])
def test_estimate_pitch_batch_bit_equal(seg_data, backend):
    segs, counts = seg_data
    want = jdops.estimate_pitch_batch(jnp.asarray(segs), jnp.asarray(counts),
                                      backend=backend)
    got = tdops.estimate_pitch_batch(torch.as_tensor(segs),
                                     torch.as_tensor(counts))
    assert np.array_equal(np.asarray(want), got.numpy())
    assert (got.numpy() > 0).sum() >= 8        # voiced rows are exercised


def test_library_yardstick_equals_plain(seg_data):
    """chip_smoke.py times one f64 grouped conv1d as the library call
    that computes pitch_corr; it gives the same f32 bits."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    segs, counts = seg_data
    ana = np.minimum(220, counts - np.minimum(275, counts // 2))
    ana[0] = -5                                 # clamped to 0, as the kernel
    seg_t = torch.as_tensor(segs)
    ana_t = torch.as_tensor(ana.astype(np.int32))
    got = chip_smoke.pitch_conv(torch, seg_t, ana_t)()
    want = hpitch.pitch_corr_plain(seg_t, ana_t)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and torch.equal(g, w)


ROW_KINDS = ["noise", "min", "max", "alternating", "sine", "zero"]
LENGTHS = [0, 1, 2, 3, 5, 113, 219, 220, 221, -4]


def rows_of(kind):
    """Rows of one kind (int16 noise, all -32768, all 32767, alternating
    extremes, a sine, zeros), one at each analysis length the kernel
    treats apart (0, 1, a partial last group of 4, the full 220, past
    it, negative)."""
    rng = np.random.default_rng(41 + ROW_KINDS.index(kind))
    t = np.arange(SPAN)
    row = {"noise": lambda: rng.integers(-32768, 32768, SPAN),
           "min": lambda: np.full(SPAN, -32768),
           "max": lambda: np.full(SPAN, 32767),
           "alternating": lambda: np.where(t % 2 == 0, 32767, -32768),
           "sine": lambda: np.round(12000 * np.sin(2 * np.pi * t / 61.0)),
           "zero": lambda: np.zeros(SPAN)}[kind]
    segs = np.array([row() for _ in LENGTHS], np.float32)
    return segs, np.array(LENGTHS, np.int32)


@pytest.fixture(scope="module")
def extreme_rows():
    parts = [rows_of(k) for k in ROW_KINDS]
    return (np.concatenate([p[0] for p in parts]),
            np.concatenate([p[1] for p in parts]))


@pytest.mark.parametrize("kind", ROW_KINDS)
def test_e2_is_a_difference_of_prefix_sums(kind):
    """e2[lag] = P[lag + L] - P[lag], P the prefix sum of squares, is the
    plain version's e2 (the kernel holds P in f64: every value < 2^53)."""
    segs, ana = rows_of(kind)
    s = segs.astype(np.int64)
    P = np.concatenate([np.zeros((len(s), 1), np.int64),
                        np.cumsum(s * s, 1)], 1)
    assert P.max() < 2 ** 53
    L = np.clip(ana, 0, 220)[:, None]
    lag = np.arange(276)[None, :]
    rows = np.arange(len(s))[:, None]
    e2 = (P[rows, lag + L] - P[rows, lag]).astype(np.float32)
    want = hpitch.pitch_corr_plain(torch.as_tensor(segs),
                                   torch.as_tensor(ana))[1].numpy()
    assert np.array_equal(e2, want)


def dp4a_corr(row, L):
    """corr of one row as the kernel sums it: byte planes s = 256 hi + lo
    (hi signed, lo unsigned); for lag, step g adds dp4a(base word g,
    word at lag + 4g) of each plane pair into int32 sums hh, hx (hi*lo
    then lo*hi) and ll, over ceil(L / 4) groups rounded up to even (the
    base is 0 past L); lags 0..255 are 8 a lane on 32 lanes, 256..275 one
    a lane on 20. Returns corr (f32) and the largest |partial sum|."""
    s = np.zeros(520, np.int64)
    s[:SPAN] = row
    hi, lo = s >> 8, s & 0xFF
    assert np.array_equal(256 * hi + lo, s)
    lags = [8 * lane + d for lane in range(32) for d in range(8)]
    lags += [256 + lane for lane in range(20)]
    assert sorted(lags) == list(range(276))        # each lag exactly once
    ng = (L + 3) // 4
    ng += ng % 2
    i = np.arange(4 * ng)
    bh = np.where(i < L, hi[i], 0)
    bl = np.where(i < L, lo[i], 0)
    lag = np.array(lags)[:, None]
    wh, wl = hi[lag + i], lo[lag + i]              # [276, 4 ng]

    def steps(a, w):                               # one dp4a a step
        return (a[None, :] * w).reshape(len(lags), ng, 4).sum(-1)

    hh = np.cumsum(steps(bh, wh), 1)
    hx1 = steps(bh, wl)                            # dp4a_su, then dp4a_us
    hx = np.cumsum(hx1 + steps(bl, wh), 1)
    hx_mid = hx - steps(bl, wh)                    # the sum between the two
    ll = np.cumsum(steps(bl, wl), 1)
    peak = max([abs(x).max(initial=0) for x in (hh, hx, hx_mid, ll)])
    tot = (65536 * hh[:, -1:] + 256 * hx[:, -1:] + ll[:, -1:])[:, 0] \
        if ng else np.zeros(len(lags), np.int64)
    corr = np.zeros(276, np.float32)
    corr[np.array(lags)] = tot.astype(np.float32)
    return corr, peak


@pytest.mark.parametrize("kind", ROW_KINDS)
def test_dp4a_byte_planes_reproduce_corr(kind):
    segs, ana = rows_of(kind)
    want = hpitch.pitch_corr_plain(torch.as_tensor(segs),
                                   torch.as_tensor(ana))[0].numpy()
    worst = 0
    for r in range(len(segs)):
        got, peak = dp4a_corr(segs[r].astype(np.int64),
                              int(np.clip(ana[r], 0, 220)))
        assert np.array_equal(got, want[r]), r
        worst = max(worst, peak)
    assert worst < 2 ** 31


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(seg_data, extreme_rows, cuda_device):
    segs, counts = seg_data
    ana = np.minimum(220, counts - np.minimum(275, counts // 2))
    for s, a in ((segs, ana.astype(np.int32)), extreme_rows,
                 (segs, np.full(len(segs), 220, np.int32))):
        seg_t = torch.as_tensor(s, device=cuda_device)
        ana_t = torch.as_tensor(a, device=cuda_device)
        before = hpitch.launches
        got = hpitch.pitch_corr(seg_t, ana_t)
        assert hpitch.launches == before + 1
        want = hpitch.pitch_corr_plain(seg_t, ana_t)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
