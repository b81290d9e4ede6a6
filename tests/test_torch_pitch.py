"""Pitch-search correlations and estimate_pitch_batch of ctts_tpu_torch
against the JAX package.

The plain int64 correlation sums must equal combine_exact over the
Pallas kernel's six component sums (interpret mode), and the port's
estimate_pitch_batch must return the same pitches, bit for bit, as the
JAX function under both of its CPU backends (grouped conv, Pallas
interpret). The card-only test holds the CUDA kernel to the plain
version.
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


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(seg_data, cuda_device):
    segs, counts = seg_data
    ana = np.minimum(220, counts - np.minimum(275, counts // 2))
    seg_t = torch.as_tensor(segs, device=cuda_device)
    ana_t = torch.as_tensor(ana.astype(np.int32), device=cuda_device)
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
