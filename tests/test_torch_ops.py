"""ctts_tpu_torch elementwise ops and DSP stages against the JAX package.

The same seeded numpy inputs go through the JAX function on the CPU and
its PyTorch counterpart on the CPU; every comparison is bit equality
(np.array_equal, where -0.0 == 0.0). The JAX side runs op by op
(no jit): under jit, XLA:CPU contracts multiply-add pairs such as the
LUT lerp `lut[i]*(1-f) + lut[i+1]*f` into fused multiply-adds and lands
1 ULP away on ~9% of LUT inputs, while the C reference, the NumPy
oracle and the port round the multiply and the add separately (the
LUT test also holds the port to the oracle).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ctts_tpu.ops import device_ops as jdops
from ctts_tpu.ops import exact as jexact
from ctts_tpu.ops import luts as jluts
from ctts_tpu.ops import quant as jquant
from ctts_tpu.synth.dsp_np import fast_fade_in, fast_fade_out, fast_sine_fade
from ctts_tpu_torch.ops import device_ops as tdops
from ctts_tpu_torch.ops import exact as texact
from ctts_tpu_torch.ops import luts as tluts
from ctts_tpu_torch.ops import quant as tquant

CPU = torch.device("cpu")


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _eq(a, b):
    return np.array_equal(np.asarray(a), np.asarray(b))


def lattice_fuzz(seed, n=50_000):
    """int16-lattice values, out-of-range integers and fractional values."""
    rng = np.random.default_rng(seed)
    return np.concatenate([
        rng.integers(-32768, 32768, n).astype(np.float32),
        rng.integers(-200_000, 200_000, n).astype(np.float32),
        rng.uniform(-40_000, 40_000, n).astype(np.float32),
        np.array([-32768.5, 32767.5, -0.5, 0.5, 0.0, -0.0, 65535.0,
                  -65536.0, 98303.0], np.float32),
    ])


@pytest.mark.parametrize("name", ["q16", "trunc16", "wrap16"])
def test_quant_bit_equal(name):
    x = lattice_fuzz(1)
    if name == "wrap16":
        x = np.trunc(x)          # wrap16 takes integer-valued floats
    want = getattr(jquant, name)(jnp.asarray(x))
    got = getattr(tquant, name)(_t(x))
    assert _eq(want, got)


@pytest.mark.parametrize("name", ["fade_out_gain", "fade_in_gain",
                                  "sine_fade_gain"])
def test_lut_gains_bit_equal(name):
    rng = np.random.default_rng(2)
    cf = rng.integers(1, 4096, 4000).astype(np.float32)
    i = rng.integers(0, 4096, 4000).astype(np.float32)
    t = np.concatenate([
        i * (np.float32(1.0) / cf),          # the core's tmix form
        rng.uniform(-0.5, 1.5, 20_000).astype(np.float32),
        np.array([0.0, 1.0, -1e-7, 1.0000001, 0.5, 2.0], np.float32),
    ])
    got = getattr(tluts, name)(_t(t))
    assert _eq(getattr(jluts, name)(jnp.asarray(t)), got)
    oracle = {"fade_out_gain": fast_fade_out, "fade_in_gain": fast_fade_in,
              "sine_fade_gain": fast_sine_fade}[name]
    assert _eq(oracle(t), got)


@pytest.mark.parametrize("n", [256, 512, 1000])
def test_hann_bit_equal(n):
    assert _eq(jluts.hann(n), tluts.hann(n, CPU))


def test_div_sqrt_bit_equal_to_exact():
    """Plain IEEE `/` and sqrt equal div_rn / sqrt_rn on the value sets
    of tests/test_exact_div_sqrt.py."""
    rng = np.random.default_rng(7)
    a = np.concatenate([
        (22050.0 / rng.integers(30, 300, 200_000)).astype(np.float32),
        rng.uniform(-1e6, 1e6, 200_000).astype(np.float32),
        np.array([1.0, 3.0, 10.0, 157.5, 0.0, -157.5], np.float32)])
    b = np.concatenate([
        (22050.0 / rng.integers(30, 300, 200_000)).astype(np.float32),
        rng.uniform(1e-3, 1e6, 200_000).astype(np.float32),
        np.array([2.0, 4.0, 8.0, 0.5, 3.0, 0.5], np.float32)])
    want = jexact.div_rn(jnp.asarray(a), jnp.asarray(b))
    assert _eq(want, _t(a) / _t(b))

    rng = np.random.default_rng(8)
    x = np.concatenate([
        rng.uniform(0, 1e12, 400_000).astype(np.float32),
        rng.integers(0, 2**30, 100_000).astype(np.float32),
        np.array([0.0, 1.0, 2.0, 4.0], np.float32)])
    want = jexact.sqrt_rn(jnp.asarray(x))
    assert _eq(want, texact.sqrt_rn(_t(x)))


def test_div_golden_tpu_regression_case():
    """test_exact_div_sqrt.py::test_div_rn_golden_tpu_regression_case:
    the pitch ratio that straddles the 0.85 jump threshold by 1 ULP."""
    prev_p = np.float32(22050.0) / np.float32(119.0)
    next_p = np.float32(157.5)
    want = float(jexact.div_rn(jnp.float32(next_p),
                                        jnp.float32(prev_p)))
    got = _t(np.float32([next_p])) / _t(np.float32([prev_p]))
    assert np.float32(want) == got.numpy()[0] == next_p / prev_p
    assert not (got.numpy()[0] < np.float32(0.85))


def test_pitch_shift_blend_fuzz():
    """Gather resample vs the JAX drift-shifted selects, including
    out-of-gate factors and boundary shift regions."""
    rng = np.random.default_rng(2)
    n, H = 48, 1024
    head = rng.integers(-32768, 32768, (n, H)).astype(np.float32)
    sr = rng.integers(0, H + 1, n).astype(np.int32)
    sr[:4] = [0, 99, 100, H]
    f = np.array([[rng.uniform(0.9, 1.1), rng.uniform(0.5, 2.5),
                   rng.choice([0.9, 1.1, 1.0]), rng.uniform(0.0, 100.0)][k % 4]
                  for k in range(n)], np.float32)
    want = jax.vmap(jdops.pitch_shift_blend)(
        jnp.asarray(head), jnp.asarray(sr), jnp.asarray(f))
    got = tdops.pitch_shift_blend(_t(head), _t(sr), _t(f))
    assert _eq(want, got)


def _silence_rows(seed, n_rows, W):
    rng = np.random.default_rng(seed)
    rows = np.zeros((n_rows, W), np.float32)
    lens = np.zeros(n_rows, np.int32)
    for r in range(n_rows):
        n = int(rng.integers(50, W))
        x = rng.normal(0, 3000, n).astype(np.float32).round()
        for _ in range(int(rng.integers(0, 6))):
            s = int(rng.integers(0, max(n - 40, 1)))
            x[s:s + int(rng.integers(10, 900))] = 0.0
        rows[r, :n] = x
        lens[r] = n
    lens[0] = 0
    rows[1] = 0.0
    # Dense bursts: more kept segments than the NBLK table holds.
    burst = np.zeros(W, np.float32)
    for k in range(40):
        burst[k * 400:k * 400 + 32] = 8000.0
    rows[2], lens[2] = burst, 40 * 400
    return rows, lens


def test_silence_segments_bit_equal():
    rows, lens = _silence_rows(7, 24, 16384)
    fn = jax.vmap(
        lambda b, n: jdops.silence_segments(b, n, jnp.float32(0.01), 330))
    want = fn(jnp.asarray(rows), jnp.asarray(lens))
    got = tdops.silence_segments(_t(rows), _t(lens),
                                 torch.full((24,), 0.01), 330)
    for w, g in zip(want, got):
        assert _eq(w, g)
    assert bool(np.asarray(want[3])[2])      # the overflow row


def _bound_rows(seed, W, min_silence, nblk):
    """Rows that reach kept_segments_bound exactly: runs of L silent
    samples (small values under the threshold), each followed by one
    loud sample, L = the shortest run silence removal cuts; the first
    row fills the nblk-slot table, the second is one run short of it
    and starts loud, the third reaches the bound at a length that is not
    a multiple of L + 1. Then random rows of silent runs and loud bursts
    of every length, short enough that their bound is at most nblk."""
    from ctts_tpu_torch.synth.plan_arrays import kept_segments_bound

    rng = np.random.default_rng(seed)
    L = max(min_silence, max(min_silence // 4, 10) + 1)
    rows, lens, exact = [], [], []

    def periodic(k, lead, tail):
        x = np.concatenate([np.full(lead, 9000.0)]
                           + [np.r_[rng.integers(-40, 41, L), 9000.0]
                              for _ in range(k)]
                           + [rng.integers(-40, 41, tail)])
        return x.astype(np.float32)

    for k, lead, tail in ((nblk - 1, 0, 0), (nblk - 2, 1, 0),
                          (nblk // 2, 0, L - 1)):
        rows.append(periodic(k, lead, tail))
        exact.append(True)
    for _ in range(9):
        parts, n = [], 0
        while n < (nblk - 1) * (L + 1) - 4:
            run = int(rng.integers(1, 3 * L))
            parts.append(rng.integers(-40, 41, run))
            loud = int(rng.integers(1, 4))
            parts.append(rng.choice([-1, 1], loud) * rng.integers(
                2000, 30000, loud))
            n += run + loud
        rows.append(np.concatenate(parts).astype(np.float32)[
            :(nblk - 1) * (L + 1)])
        exact.append(False)
    buf = np.zeros((len(rows), W), np.float32)
    for r, x in enumerate(rows):
        buf[r, :x.shape[0]] = x
        lens.append(x.shape[0])
    lens = np.array(lens, np.int32)
    return buf, lens, np.array(exact), kept_segments_bound(lens, min_silence)


@pytest.mark.parametrize("nblk,min_silence", [(64, 200), (512, 22)])
def test_silence_segments_at_a_wide_table(nblk, min_silence):
    """silence_segments at a table of nblk slots, on rows built to reach
    kept_segments_bound: the count of kept segments equals the bound on
    those rows and never exceeds it on any row, nothing overflows, and
    the buffer moved by those tables equals the oracle's silence
    removal."""
    from ctts_tpu_torch.synth.dsp_np import remove_silence_regions

    W = 16384
    buf, lens, exact, bound = _bound_rows(nblk, W, min_silence, nblk)
    assert bound[0] == nblk and bound.max() <= nblk
    thr = 0.01
    starts, seg_len, new_len, ovf = tdops.silence_segments(
        _t(buf), _t(lens), torch.full((buf.shape[0],), thr), min_silence,
        nblk)
    assert starts.shape == (buf.shape[0], nblk)
    count = (seg_len > 0).sum(1).numpy()
    assert not ovf.any()
    assert (count <= bound).all(), (count, bound)
    assert (count[exact] == bound[exact]).all(), (count, bound)
    dst = torch.cumsum(seg_len, 1) - seg_len
    moved = tdops.move_segments(_t(buf), starts, dst, seg_len).numpy()
    for r in range(buf.shape[0]):
        want = remove_silence_regions(buf[r, :lens[r]].astype(np.int16),
                                      thr, min_silence)
        assert int(new_len[r]) == want.shape[0], r
        assert np.array_equal(moved[r, :want.shape[0]], want), r
    # One table narrower, the full row overflows (its last slot is the
    # catch-all); the row one run short still fits.
    _, _, _, ovf = tdops.silence_segments(
        _t(buf[:2]), _t(lens[:2]), torch.full((2,), thr), min_silence,
        nblk - 1)
    assert ovf.tolist() == [True, False]


@pytest.mark.parametrize("seg_off", [0, 700])
def test_contour_segment_bit_equal(seg_off):
    """Gather resample + two-term OLA vs the JAX shifted selects and
    interleaved tilings; seg_off > 0 is the interrogative fall."""
    rng = np.random.default_rng(4 + seg_off)
    n, W = 12, 4096
    K = (W - 256) // 128 + 2
    content = rng.integers(-20000, 20000, (n, W)).astype(np.float32)
    count = rng.integers(0, W - seg_off, n).astype(np.int32)
    count[:3] = [0, 99, 256]
    fs = rng.uniform(0.9, 1.1, n).astype(np.float32)
    fe = rng.uniform(0.9, 1.1, n).astype(np.float32)
    fe[4] = fs[4]
    D = int(np.ceil(256 * 0.1)) + 2
    off = jnp.int32(seg_off) if seg_off else 0
    fn = jax.vmap(lambda c, k, a, b: jdops.contour_segment(
        c, off, k, a, b, K, D))
    want = np.asarray(fn(jnp.asarray(content), jnp.asarray(count),
                         jnp.asarray(fs), jnp.asarray(fe)))
    got = tdops.contour_segment(
        _t(content), torch.full((n,), seg_off), _t(count), _t(fs), _t(fe),
        K).numpy()
    rows = count != 256      # count == 256: the C's 1/0 frame (NaN quirk)
    assert _eq(want[rows], got[rows])


def test_tail_fade_window_bit_equal():
    rng = np.random.default_rng(9)
    n, W, W2 = 16, 4096, 128
    buf = rng.integers(-32768, 32768, (n, W)).astype(np.float32)
    end = rng.integers(0, W + 1, n).astype(np.int32)
    fade = rng.integers(0, W2 + 1, n).astype(np.int32)
    end[:3] = [0, 5, W]
    fade[:2] = [0, 50]
    fn = jax.vmap(lambda b, e, f: jdops.tail_fade_window(b, e, f, W2))
    want = fn(jnp.asarray(buf), jnp.asarray(end), jnp.asarray(fade))
    got = tdops.tail_fade_window(_t(buf), _t(end), _t(fade), W2)
    assert _eq(want, got)
