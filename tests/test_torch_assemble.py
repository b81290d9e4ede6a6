"""Sentence assembly of ctts_tpu_torch against the Pallas kernel.

The plain PyTorch version must equal ctts_tpu's assemble_regions in
interpret mode, bit for bit, on the fuzzed region tables and shapes of
tests/test_pallas_assemble.py (inactive and zero-length regions, margin
overlap into the previous pause), with all trials as one batch. The
CUDA kernel's order of adds (each warp's 128 positions walk the list of
regions that meet them, in ascending r) is rebuilt in numpy and held to
the plain version on those tables and on adversarial ones (3- to 5-deep
overlaps, live lengths past WREG, a region past the output's end,
inactive and zero-length regions between active ones), also at an
output width that is not a multiple of 4. The card-only test holds the
CUDA kernel to the plain version on all of them.
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


@pytest.fixture(scope="module")
def adversarial():
    """Region tables outside the plan's invariants, one kind a row."""
    rng = np.random.default_rng(29)
    n = 6
    bufs = np.trunc(rng.uniform(-30000, 30000, (n, R * WREG))
                    ).astype(np.float32)
    offs = np.tile(np.array([0, 2500, 5000, 7500], np.int32), (n, 1))
    live = np.full((n, R), MARGIN + 1000, np.int32)
    offs[0, 1:] = (600, 900, 1200)            # 4 regions over one stretch
    live[0] = (4000, 5000, 6000, 3000)
    live[1, 1] = WREG + 3000                  # live past WREG
    live[1, 3] = 2 * WREG
    offs[2, 3] = MARGIN + SMAX - 1000         # runs past the output's end
    live[2, 3] = WREG
    live[3] = (MARGIN + 500, 0, -7, MARGIN)   # inactive, zero-length
    offs[4] = 0                               # 4 regions, all at 0
    live[4] = (9000, 300, WREG, 1)
    live[5] = 0                               # nothing active
    return bufs, offs, live


def tile_walk(bufs, offsets, live, outw):
    """The kernel's adds in numpy: each warp span of 128 positions starts
    at 0.0f and adds, in ascending r, the regions whose live span
    [off, off + min(live, WREG)) meets it, each where it covers."""
    B, Rn = offsets.shape
    out = np.zeros((B, outw), np.float32)
    for b in range(B):
        rows = bufs[b].reshape(Rn, WREG)
        n = np.clip(np.minimum(live[b], WREG), 0, None)
        for lo in range(0, outw, 128):
            hi = min(lo + 128, outw)
            p = np.arange(lo, hi)
            v = np.zeros(hi - lo, np.float32)
            for r in range(Rn):
                if n[r] > 0 and offsets[b, r] < hi and offsets[b, r] + n[r] > lo:
                    j = p - offsets[b, r]
                    m = (j >= 0) & (j < n[r])
                    v[m] = v[m] + rows[r][j[m]]
            out[b, lo:hi] = v
    return out


@pytest.mark.parametrize("case", ["fuzzed", "adversarial",
                                  "adversarial_odd_width"])
def test_tile_region_walk_matches_plain(batch, adversarial, case):
    tables = batch if case == "fuzzed" else adversarial
    outw = MARGIN + SMAX - (2 if case.endswith("odd_width") else 0)
    want = hassemble.assemble_plain(*[torch.as_tensor(x) for x in tables],
                                    WREG, outw).numpy()
    got = tile_walk(*tables, outw)
    assert np.array_equal(got, want)
    if case != "fuzzed":
        # Overlap depth reached by the adversarial tables.
        bufs, offs, live = tables
        n = np.clip(np.minimum(live, WREG), 0, None)
        p = np.arange(outw)[None, None, :]
        depth = ((p >= offs[:, :, None]) & (p < (offs + n)[:, :, None])
                 ).sum(1).max()
        assert depth >= 3


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
def test_kernel_matches_plain_on_card(batch, adversarial, cuda_device):
    for tables, outw in ((batch, MARGIN + SMAX), (adversarial, MARGIN + SMAX),
                         (adversarial, MARGIN + SMAX - 2)):
        args = [torch.as_tensor(x, device=cuda_device) for x in tables]
        before = hassemble.launches
        got = hassemble.assemble(*args, WREG, outw)
        assert hassemble.launches == before + 1
        assert torch.equal(got, hassemble.assemble_plain(*args, WREG, outw))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
