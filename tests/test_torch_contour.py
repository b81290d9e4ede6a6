"""Contour zones and region_post of ctts_tpu_torch against the JAX package.

contour_plain (ops/hopper/contour.py, what SynthesisCore._contour
returns) must equal, bit for bit, the JAX package's per-segment
contour_segment (ctts_tpu/ops/device_ops.py:732) run op by op (vmap, no
jit), on the rise segment of every DSP region and then on the fall
segment of the question-final ones, gated as
ctts_tpu/synth/device.py:1345-1353 and :1527-1547 gate them: rows of
99, 100, 257 and CONTW samples, a split question whose rise and fall
abut, equal factors and factors 0.005 apart. region_post_plain must
equal the energy ramp of ctts_tpu/synth/device.py:1573-1578 and
jdops.tail_fade_window, with the fade min(fade_after, before + cnt)
taken over a buffer that holds `before` samples ahead of the row (what
apply_fade_out does over the whole sentence): rows under 100 samples,
fades longer than their row and `before` > 0. On the CPU the wrappers
run the plain versions; the card-only tests hold the CUDA kernels to
them, at the serving bucket and the one-sentence bucket, with NaN equal
to NaN (a segment of exactly 256 samples: the reference's 1/0 frame).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ctts_tpu.ops import device_ops as jdops
from ctts_tpu.ops import quant as jquant
from ctts_tpu_torch.ops.hopper import contour as hcontour
from ctts_tpu_torch.ops.hopper import region_post as hpost

F32 = np.float32
B, R, MARGIN, CONTW = 2, 8, 256, 4096
WREG = CONTW + 2 * MARGIN
SMAX = R * CONTW
FADE2W = 512


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
    jax.clear_caches()


def segments(cnt, qfinal, do_dsp, active, c):
    """Each row's (rise, fall) segments as the core derives them:
    (offset, count, f_start, f_end) arrays of [n] each, numpy."""
    rise = (cnt.astype(F32) * F32(0.6)).astype(np.int64)
    split = (rise > 100) & (cnt - rise > 100)
    split1 = qfinal & split
    n0 = np.where(do_dsp, np.where(split1, rise, cnt), 0)
    n1 = np.where(qfinal & do_dsp & active & split, cnt - rise, 0)
    return ((np.zeros_like(cnt), n0, c[:, 0], np.where(split1, c[:, 2],
                                                       c[:, 1])),
            (rise, n1, c[:, 2], c[:, 1]))


def contour_rows(seed, b=B, r=R, contw=CONTW, margin=MARGIN, smax=None):
    """Region rows [b, r, contw + 2 margin] of int16 values with their
    region arrays; the first rows hold the edge cases, the rest are
    random, and each sentence's lengths sum to at most smax."""
    rng = np.random.default_rng(seed)
    smax = smax or r * contw
    wreg = contw + 2 * margin
    bufs = rng.integers(-20000, 20000, (b, r, wreg)).astype(F32)
    cnt = rng.integers(0, contw + 1, (b, r)).astype(np.int64)
    qfinal = rng.random((b, r)) < 0.4
    do_dsp = rng.random((b, r)) < 0.8
    active = rng.random((b, r)) < 0.9
    c = rng.uniform(0.9, 1.1, (b, r, 5)).astype(F32)
    flat = [x.reshape(b * r, *x.shape[2:]) for x in (cnt, qfinal, do_dsp,
                                                     active, c)]
    edge = [  # (cnt, qfinal, do_dsp, active)
        (99, False, True, True), (100, False, True, True),
        (257, False, True, True), (contw, False, True, True),
        (3000, True, True, True),            # rise 1800 and fall abut
        (contw, True, True, True),           # a split question, full row
        (2000, False, True, True),           # fs == fe below
        (2000, False, True, True),           # |fs - fe| == 0.005 below
        (200, True, True, True),             # question, too short to split
        (3500, True, True, False),           # inactive: the rise alone
        (4000, True, False, True),           # no DSP: nothing
        (0, True, True, True)]
    for k, (n, q, d, a) in enumerate(edge[:b * r]):
        flat[0][k], flat[1][k], flat[2][k], flat[3][k] = n, q, d, a
    if b * r > 7:
        flat[4][6, 1] = flat[4][6, 0]
        flat[4][7, 1] = flat[4][7, 0] + F32(0.005)
    for s in range(b):     # the lowering's bound: a sentence <= smax
        row = cnt[s]
        while row.sum() > smax:
            row[int(np.argmax(row))] //= 2
    return bufs, cnt, c, qfinal, do_dsp, active


def no_256(cnt, qfinal, do_dsp, active, c):
    """Lengthen rows with a segment of exactly 256 samples (NaN in the C
    and both versions, which the JAX comparison leaves out)."""
    shape = cnt.shape
    cnt = cnt.reshape(-1)
    while True:
        s0, s1 = segments(cnt, qfinal.reshape(-1), do_dsp.reshape(-1),
                          active.reshape(-1), c.reshape(-1, 5))
        bad = (s0[1] == 256) | (s1[1] == 256)
        if not bad.any():
            return cnt.reshape(shape)
        cnt[bad] += 1


def jax_contour(rows, cnt, qfinal, do_dsp, active, c, margin, contw):
    """The JAX package's contour per region row: contour_segment on the
    rise segment, then on the fall segment of the result."""
    K = (contw - 256) // 128 + 2
    seg = jax.vmap(lambda x, o, n, a, b: jdops.contour_segment(
        x, o, n, a, b, K))
    content = jnp.asarray(rows[:, margin:margin + contw])
    for off, n, fs, fe in segments(cnt, qfinal, do_dsp, active, c):
        content = seg(content, jnp.asarray(off, jnp.int32),
                      jnp.asarray(n, jnp.int32), jnp.asarray(fs),
                      jnp.asarray(fe))
    out = rows.copy()
    out[:, margin:margin + contw] = np.asarray(content)
    return out


def plain_contour(bufs, cnt, c, qfinal, do_dsp, active, margin=MARGIN,
                  smax=SMAX):
    return hcontour.contour_plain(
        torch.as_tensor(bufs.copy()), torch.as_tensor(cnt),
        torch.as_tensor(c), torch.as_tensor(qfinal),
        torch.as_tensor(do_dsp), torch.as_tensor(active), margin,
        smax).numpy()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_contour_plain_equals_jax_contour_segment(seed):
    bufs, cnt, c, qfinal, do_dsp, active = contour_rows(seed)
    cnt = no_256(cnt, qfinal, do_dsp, active, c)
    got = plain_contour(bufs, cnt, c, qfinal, do_dsp, active)
    n = B * R
    want = jax_contour(bufs.reshape(n, WREG), cnt.reshape(n),
                       qfinal.reshape(n), do_dsp.reshape(n),
                       active.reshape(n), c.reshape(n, 5), MARGIN, CONTW)
    assert np.array_equal(got.reshape(n, WREG), want)
    changed = (got != bufs).any(-1).reshape(n)
    # The edge rows: 99 and 100 keep everything (100 runs no frame),
    # 257 and CONTW change, equal factors keep, 0.005 apart keeps, no
    # DSP and empty keep.
    assert changed[:12].tolist() == [False, False, True, True, True, True,
                                     False, False, False, True, False,
                                     False]
    # The split question: the fall starts where the rise ends.
    s0, s1 = segments(cnt.reshape(n), qfinal.reshape(n), do_dsp.reshape(n),
                      active.reshape(n), c.reshape(n, 5))
    assert s0[1][4] == 1800 and (s1[0][4], s1[1][4]) == (1800, 1200)


def post_rows(seed, b=B, r=R, contw=CONTW, margin=MARGIN, fade2w=FADE2W):
    """Region rows and region_post's arrays: the first rows hold the
    edge cases (under 100 samples, fades longer than the row, before >
    0, no fade, no ramp), the rest are random."""
    rng = np.random.default_rng(100 + seed)
    wreg = contw + 2 * margin
    w2 = min(fade2w, contw)
    bufs = rng.integers(-32768, 32768, (b, r, wreg)).astype(F32)
    cnt = rng.integers(0, contw + 1, (b, r)).astype(np.int64)
    before = rng.integers(0, 20000, (b, r)).astype(np.int64)
    c = rng.uniform(0.9, 1.1, (b, r, 5)).astype(F32)
    c[..., 3:] = rng.uniform(0.7, 1.4, (b, r, 2))
    do_dsp = rng.random((b, r)) < 0.8
    energy = rng.random((b, r)) < 0.7
    fade = rng.integers(0, w2 + 1, (b, r)).astype(np.int32)
    fade[rng.random((b, r)) < 0.3] = 0
    flat = [x.reshape(-1) for x in (cnt, before, do_dsp, energy, fade)]
    edge = [  # (cnt, before, do_dsp, energy, fade_after)
        (50, 0, True, True, 30), (99, 0, True, True, 0),
        (100, 0, True, True, 0), (contw, 0, True, True, w2),
        (80, 0, False, False, w2),           # fade longer than the row
        (80, 3000, True, True, w2),          # ... reaching back before it
        (1500, 700, True, True, w2),
        (1500, 0, False, True, 0),           # no ramp (no DSP), no fade
        (1500, 0, True, False, 40),          # the fade alone
        (0, 500, True, True, w2)]            # empty, fading back
    for k, row in enumerate(edge[:b * r]):
        for a, v in zip(flat, row):
            a[k] = v
    return bufs, cnt, before, c, do_dsp, energy, fade


def jax_region_post(rows, cnt, before, c, do_dsp, energy, fade_after,
                    margin, contw, w2):
    """ctts_tpu/synth/device.py:1567-1593 per region row, the fade taken
    as jdops.tail_fade_window takes it on a buffer that holds `before`
    samples ahead of the row (PRE of them, zeros, and the fade length
    min(fade_after, before + cnt))."""
    pre = int(max(before.max(), 0))

    def post(row, count, dsp, contour, on, fade, ahead):
        content = row[margin:margin + contw]
        es, ee = contour[3], contour[4]
        ic = jnp.arange(contw)
        te = ic.astype(F32) / jnp.maximum(count - 1, 1).astype(F32)
        ramped = jquant.q16(content * (es + (ee - es) * te))
        apply_e = dsp & on & (count >= 100)
        content = jnp.where((ic < count) & apply_e, ramped, content)
        ext = jnp.concatenate([jnp.zeros(pre, jnp.float32), content])
        faded = jdops.tail_fade_window(
            ext, pre + count, jnp.minimum(fade, count + ahead), w2)[pre:]
        content = jnp.where(fade > 0, faded, content)
        return row.at[margin:margin + contw].set(content)

    return np.asarray(jax.vmap(post)(
        jnp.asarray(rows), jnp.asarray(cnt, jnp.int32), jnp.asarray(do_dsp),
        jnp.asarray(c), jnp.asarray(energy), jnp.asarray(fade_after),
        jnp.asarray(before, jnp.int32)))


def plain_post(bufs, cnt, before, c, do_dsp, energy, fade, margin=MARGIN,
               contw=CONTW, fade2w=FADE2W):
    return hpost.region_post_plain(
        torch.as_tensor(bufs.copy()), torch.as_tensor(cnt),
        torch.as_tensor(before), torch.as_tensor(c),
        torch.as_tensor(do_dsp), torch.as_tensor(energy),
        torch.as_tensor(fade), margin, contw, fade2w).numpy()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_region_post_plain_equals_jax(seed):
    rows = post_rows(seed)
    got = plain_post(*rows)
    n = B * R
    bufs, cnt, before, c, do_dsp, energy, fade = rows
    want = jax_region_post(bufs.reshape(n, WREG), cnt.reshape(n),
                           before.reshape(n), c.reshape(n, 5),
                           do_dsp.reshape(n), energy.reshape(n),
                           fade.reshape(n), MARGIN, CONTW,
                           min(FADE2W, CONTW))
    assert np.array_equal(got.reshape(n, WREG), want)
    changed = (got != bufs).any(-1).reshape(n)
    assert changed[:10].tolist() == [True, False, True, True, True, True,
                                     True, False, True, False]


def test_cpu_route_runs_the_plain_versions_and_counts_nothing():
    bufs, cnt, c, qfinal, do_dsp, active = contour_rows(2)
    args = [torch.as_tensor(x) for x in (bufs, cnt, c, qfinal, do_dsp,
                                         active)]
    before = hcontour.launches
    got = hcontour.contour_zones(args[0].clone(), *args[1:], MARGIN, SMAX)
    assert hcontour.launches == before
    assert np.array_equal(got.numpy(),
                          plain_contour(bufs, cnt, c, qfinal, do_dsp,
                                        active), equal_nan=True)

    rows = post_rows(2)
    targs = [torch.as_tensor(x) for x in rows]
    before = hpost.launches
    got = hpost.region_post(targs[0].clone(), *targs[1:], MARGIN, CONTW,
                            FADE2W)
    assert hpost.launches == before
    assert np.array_equal(got.numpy(), plain_post(*rows))


def test_other_devices_raise():
    meta = [torch.as_tensor(x).to("meta") for x in contour_rows(3)]
    with pytest.raises(ValueError, match="unsupported device"):
        hcontour.contour_zones(*meta, MARGIN, SMAX)
    meta = [torch.as_tensor(x).to("meta") for x in post_rows(3)]
    with pytest.raises(ValueError, match="unsupported device"):
        hpost.region_post(*meta, MARGIN, CONTW, FADE2W)


def test_the_core_calls_both_wrappers(monkeypatch):
    """SynthesisCore._contour and _region_post are the wrappers' calls,
    with the plan's region arrays and dims."""
    from types import SimpleNamespace

    from ctts_tpu_torch.synth import device

    bufs, cnt, c, qfinal, do_dsp, active = contour_rows(4)
    _, _, before, _, _, energy, fade = post_rows(4)
    seen = {}

    def spy(name, fn):
        def wrapper(*args):
            seen[name] = args
            return fn(*args)
        monkeypatch.setattr(device, name, wrapper)

    spy("contour_zones", hcontour.contour_zones)
    spy("region_post", hpost.region_post)
    dims = SimpleNamespace(R=R, MARGIN=MARGIN, SMAX=SMAX, CONTW=CONTW,
                           WREG=WREG, FADE2W=FADE2W)
    ar = {"region_contour": torch.as_tensor(c),
          "region_qfinal": torch.as_tensor(qfinal),
          "region_do_dsp": torch.as_tensor(do_dsp),
          "region_active": torch.as_tensor(active),
          "region_energy": torch.as_tensor(energy),
          "region_fade_after": torch.as_tensor(fade)}
    t_cnt, t_before = torch.as_tensor(cnt), torch.as_tensor(before)
    out = device.SynthesisCore._contour(None, dims, ar,
                                        torch.as_tensor(bufs.copy()), t_cnt)
    assert seen["contour_zones"][1] is t_cnt
    assert seen["contour_zones"][6:] == (MARGIN, SMAX)
    assert np.array_equal(out.numpy(), plain_contour(
        bufs, cnt, c, qfinal, do_dsp, active))
    mid = out.numpy().copy()
    out = device.SynthesisCore._region_post(None, dims, ar, out, t_cnt,
                                            t_before)
    args = seen["region_post"]
    assert args[1] is t_cnt and args[2] is t_before
    assert args[7:] == (MARGIN, CONTW, FADE2W)
    assert np.array_equal(out.numpy(), plain_post(
        mid, cnt, before, c, do_dsp, energy, fade))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# The serving bucket (B = 144 at 1.0, R = 16, CONTW = 28672, MARGIN =
# 3072, WREG = 32768, SMAX = 114688, FADE2W = 128) and the one-sentence
# bucket (B = 1).
CARD_CASES = {"serving": (144, 16, 28672, 3072, 114688, 128),
              "one sentence": (1, 16, 28672, 3072, 114688, 128),
              "small": (B, R, CONTW, MARGIN, SMAX, FADE2W)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_contour_kernel_matches_plain_on_card(cuda_device, case):
    b, r, contw, margin, smax, _ = CARD_CASES[case]
    bufs, cnt, c, qfinal, do_dsp, active = contour_rows(
        5, b, r, contw, margin, smax)
    k = b * r - 1                                 # the 1/0 frame: NaN
    cnt.reshape(-1)[k], qfinal.reshape(-1)[k] = 256, False
    do_dsp.reshape(-1)[k] = True
    c.reshape(-1, 5)[k, :2] = (0.95, 1.05)
    args = [torch.as_tensor(x, device=cuda_device)
            for x in (bufs, cnt, c, qfinal, do_dsp, active)]
    before = hcontour.launches
    got = hcontour.contour_zones(args[0].clone(), *args[1:], margin, smax)
    assert hcontour.launches == before + 1
    want = hcontour.contour_plain(args[0].clone(), *args[1:], margin, smax)
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.nan_to_num(), want.nan_to_num())


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_region_post_kernel_matches_plain_on_card(cuda_device, case):
    b, r, contw, margin, _, fade2w = CARD_CASES[case]
    rows = post_rows(6, b, r, contw, margin, fade2w)
    args = [torch.as_tensor(x, device=cuda_device) for x in rows]
    before = hpost.launches
    got = hpost.region_post(args[0].clone(), *args[1:], margin, contw,
                            fade2w)
    assert hpost.launches == before + 1
    want = hpost.region_post_plain(args[0].clone(), *args[1:], margin,
                                   contw, fade2w)
    assert torch.equal(got, want)
