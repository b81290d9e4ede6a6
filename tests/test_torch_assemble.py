"""Sentence assembly of ctts_tpu_torch against the Pallas kernel.

The plain PyTorch version must equal ctts_tpu's assemble_regions in
interpret mode, bit for bit, on the fuzzed region tables and shapes of
tests/test_pallas_assemble.py (inactive and zero-length regions, margin
overlap into the previous pause), with all trials as one batch. The
card-only test holds the CUDA kernel to the plain version.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ctts_tpu.ops.pallas.assemble import assemble_regions
from ctts_tpu_torch.ops.hopper import assemble as hassemble

R, WREG, MARGIN, SMAX = 4, 8192, 2048, 16384
TRIALS = 6


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(13)
    bufs, offs, lives = [], [], []
    for trial in range(TRIALS):
        bufs.append(np.trunc(rng.uniform(-30000, 30000, (R, WREG))
                             ).astype(np.float32))
        active = rng.integers(0, 2, R).astype(bool)
        if trial == 0:
            active[:] = True
        new_lens = np.where(active, rng.integers(0, 2000, R), 0)
        pauses = np.where(active, rng.integers(0, 1000, R), 0)
        seg = new_lens + pauses
        offs.append(np.concatenate([[0], np.cumsum(seg)[:-1]]))
        lives.append(np.where(active, MARGIN + new_lens, 0))
    return (np.stack(bufs).reshape(TRIALS, R * WREG),
            np.stack(offs).astype(np.int32), np.stack(lives).astype(np.int32))


def test_plain_matches_pallas(batch):
    bufs, offsets, live = batch
    got = hassemble.assemble(*[torch.as_tensor(x) for x in batch], WREG,
                             MARGIN + SMAX)
    assert hassemble.launches == 0
    for b in range(TRIALS):
        want = assemble_regions(
            jnp.asarray(bufs[b]), jnp.asarray(offsets[b]),
            jnp.asarray(live[b]), R=R, WREG=WREG, SMAX=SMAX, MARGIN=MARGIN,
            interpret=True)
        assert np.array_equal(np.asarray(want), got[b].numpy()), b


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(batch, cuda_device):
    args = [torch.as_tensor(x, device=cuda_device) for x in batch]
    before = hassemble.launches
    got = hassemble.assemble(*args, WREG, MARGIN + SMAX)
    assert hassemble.launches == before + 1
    assert torch.equal(got, hassemble.assemble_plain(*args, WREG,
                                                     MARGIN + SMAX))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
