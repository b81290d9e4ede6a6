"""Silence-removal compaction of ctts_tpu_torch against the Pallas kernel.

The plain PyTorch version (move_segments over the region rows) must
equal ctts_tpu's compact_units in interpret mode, bit for bit, on the
fuzzed segment tables and shapes of tests/test_pallas_compact.py, with
all trials as one batch. The card-only test holds the CUDA kernel to
the plain version.
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


def make_tables(rng):
    starts = np.zeros((R, NBLK), np.int32)
    dst = np.zeros((R, NBLK), np.int32)
    seg_len = np.zeros((R, NBLK), np.int32)
    for r in range(R):
        pos = out = MARGIN
        for s in range(int(rng.integers(0, 6))):
            pos += int(rng.integers(0, 400))
            ln = int(rng.integers(1, 700))
            if pos + ln > MARGIN + CONTW:
                break
            starts[r, s], dst[r, s], seg_len[r, s] = pos, out, ln
            pos += ln
            out += ln
    return starts, dst, seg_len


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(11)
    bufs, tables = [], []
    for _ in range(TRIALS):
        bufs.append(np.trunc(rng.uniform(-30000, 30000, (R, WREG))
                             ).astype(np.float32))
        tables.append(make_tables(rng))
    return (np.stack(bufs).reshape(TRIALS, R * WREG),
            *[np.stack([t[i] for t in tables]) for i in range(3)])


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


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(batch, cuda_device):
    args = [torch.as_tensor(x, device=cuda_device) for x in batch]
    before = hcompact.launches
    got = hcompact.compact(*args, WREG)
    assert hcompact.launches == before + 1
    assert torch.equal(got, hcompact.compact_plain(*args, WREG))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
