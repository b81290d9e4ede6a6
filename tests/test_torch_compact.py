"""Silence-removal compaction of ctts_tpu_torch against the Pallas kernel.

The plain PyTorch version (move_segments over the region rows) must
equal ctts_tpu's compact_units in interpret mode, bit for bit, on the
fuzzed segment tables and shapes of tests/test_pallas_compact.py, with
all trials as one batch, at a 128-slot table (the width a row takes
when it runs again after its 32-slot table overflowed; the Pallas
kernel's NBLK is a static argument), and on adversarial tables at 32
and 512 slots: zero-length slots (with the next destination, or 0 as
padding), segments that do not move (starts == dst), adjacent segments,
a segment ending at MARGIN + CONTW, and every slot used. The card-only
tests hold the CUDA kernel to the plain version on all of them.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ctts_tpu.ops import device_ops as jdops
from ctts_tpu.ops.pallas.compact import compact_units
from ctts_tpu_torch.ops.hopper import compact as hcompact

R, WREG, MARGIN, CONTW = 4, 8192, 2048, 4096
NBLK = jdops.NBLK
TRIALS = 6


WIDE = 128


def make_tables(rng, nblk=NBLK, segs=(0, 6), gap=400, length=700):
    starts = np.zeros((R, nblk), np.int32)
    dst = np.zeros((R, nblk), np.int32)
    seg_len = np.zeros((R, nblk), np.int32)
    for r in range(R):
        pos = out = MARGIN
        for s in range(int(rng.integers(*segs))):
            pos += int(rng.integers(0, gap))
            ln = int(rng.integers(1, length))
            if pos + ln > MARGIN + CONTW:
                break
            starts[r, s], dst[r, s], seg_len[r, s] = pos, out, ln
            pos += ln
            out += ln
    return starts, dst, seg_len


def make_batch(seed, **table):
    rng = np.random.default_rng(seed)
    bufs, tables = [], []
    for _ in range(TRIALS):
        bufs.append(np.trunc(rng.uniform(-30000, 30000, (R, WREG))
                             ).astype(np.float32))
        tables.append(make_tables(rng, **table))
    return (np.stack(bufs).reshape(TRIALS, R * WREG),
            *[np.stack([t[i] for t in tables]) for i in range(3)])


@pytest.fixture(scope="module")
def batch():
    return make_batch(11)


@pytest.fixture(scope="module")
def wide_batch():
    """Up to 128 kept segments a region, short and close together, so
    that the last slots of the table are used."""
    out = make_batch(12, nblk=WIDE, segs=(WIDE // 2, WIDE + 1), gap=16,
                     length=24)
    assert (out[3][..., WIDE - 1] > 0).any()
    return out


def adversarial_tables(rng, nblk):
    """Tables that hold silence removal's invariants at their edges, four
    kinds of region in turn (as chip_smoke.adversarial_tables): unmoved
    segments (starts == dst) before moving ones; zero-length slots
    between used ones; adjacent segments, the last ending at MARGIN +
    CONTW; short segments in every slot. Unused slots are padding (0)
    on even trials and the next destination on odd ones."""
    starts = np.zeros((R, nblk), np.int32)
    dst = np.zeros((R, nblk), np.int32)
    seg_len = np.zeros((R, nblk), np.int32)
    end = MARGIN + CONTW
    short = max(1, CONTW // (2 * nblk))
    for r in range(R):
        kind = r % 4
        pos = out = MARGIN
        k = 0
        while k < nblk and pos < end:
            if kind == 1 and k % 3 == 1:
                starts[r, k] = int(rng.integers(0, end))
                dst[r, k] = out
                k += 1
                continue
            gap = (0 if (kind == 0 and k < 3) or (kind == 2 and k > 0)
                   else int(rng.integers(0, short)) if kind == 3
                   else int(rng.integers(1 if kind == 2 else 0, 4 * short)))
            ln = (int(rng.integers(1, short + 1)) if kind == 3
                  else int(rng.integers(1, 8 * short)))
            if kind == 2 and (pos + gap + ln >= end or k == nblk - 1):
                ln = end - pos - gap
            elif pos + gap + ln > end:
                break
            pos += gap
            starts[r, k], dst[r, k], seg_len[r, k] = pos, out, ln
            pos += ln
            out += ln
            k += 1
    return starts, dst, seg_len


def make_adversarial(seed, nblk):
    rng = np.random.default_rng(seed)
    bufs, tables = [], []
    for trial in range(TRIALS):
        bufs.append(np.trunc(rng.uniform(-30000, 30000, (R, WREG))
                             ).astype(np.float32))
        starts, dst, seg_len = adversarial_tables(rng, nblk)
        if trial % 2:
            out = (dst + seg_len).max(1, keepdims=True)
            dst = np.where(seg_len > 0, dst, np.where(
                np.arange(nblk) >= (seg_len > 0).sum(1, keepdims=True),
                out, dst)).astype(np.int32)
        tables.append((starts, dst, seg_len))
    out = (np.stack(bufs).reshape(TRIALS, R * WREG),
           *[np.stack([t[i] for t in tables]) for i in range(3)])
    assert int((out[1] + out[3]).max()) == MARGIN + CONTW
    return out


@pytest.fixture(scope="module")
def adversarial_32():
    return make_adversarial(13, NBLK)


@pytest.fixture(scope="module")
def adversarial_512():
    out = make_adversarial(14, 512)
    assert (out[3][..., 511] > 0).any()
    return out


def test_plain_matches_pallas(batch):
    bufs, starts, dst, seg_len = batch
    got = hcompact.compact(*[torch.as_tensor(x) for x in batch], WREG)
    assert hcompact.launches == 0
    for b in range(TRIALS):
        want = compact_units(
            jnp.asarray(bufs[b]), jnp.asarray(starts[b]), jnp.asarray(dst[b]),
            jnp.asarray(seg_len[b]), R=R, WREG=WREG, NBLK=NBLK, MW=CONTW,
            interpret=True)
        assert np.array_equal(np.asarray(want), got[b].numpy()), b


def test_plain_matches_pallas_at_a_wide_table(wide_batch):
    bufs, starts, dst, seg_len = wide_batch
    got = hcompact.compact(*[torch.as_tensor(x) for x in wide_batch], WREG)
    assert hcompact.launches == 0
    for b in range(TRIALS):
        want = compact_units(
            jnp.asarray(bufs[b]), jnp.asarray(starts[b]), jnp.asarray(dst[b]),
            jnp.asarray(seg_len[b]), R=R, WREG=WREG, NBLK=WIDE, MW=CONTW,
            interpret=True)
        assert np.array_equal(np.asarray(want), got[b].numpy()), b


@pytest.mark.parametrize("tables", ["adversarial_32", "adversarial_512"])
def test_plain_matches_pallas_on_adversarial_tables(request, tables):
    args = request.getfixturevalue(tables)
    bufs, starts, dst, seg_len = args
    got = hcompact.compact(*[torch.as_tensor(x) for x in args], WREG)
    assert hcompact.launches == 0
    for b in range(TRIALS):
        want = compact_units(
            jnp.asarray(bufs[b]), jnp.asarray(starts[b]), jnp.asarray(dst[b]),
            jnp.asarray(seg_len[b]), R=R, WREG=WREG, NBLK=starts.shape[-1],
            MW=CONTW, interpret=True)
        assert np.array_equal(np.asarray(want), got[b].numpy()), b


@pytest.mark.cuda
@pytest.mark.parametrize("tables", ["batch", "wide_batch", "adversarial_32",
                                    "adversarial_512"])
def test_kernel_matches_plain_on_card(request, tables, cuda_device):
    args = [torch.as_tensor(x, device=cuda_device)
            for x in request.getfixturevalue(tables)]
    before = hcompact.launches
    got = hcompact.compact(*args, WREG)
    assert hcompact.launches == before + 1
    assert torch.equal(got, hcompact.compact_plain(*args, WREG))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
