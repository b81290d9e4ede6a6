"""Unit placement (compose) of ctts_tpu_torch against the Pallas kernel.

The plain PyTorch version is held to ctts_tpu's compose_units in
interpret mode, with the boundary-DSP exports on and off, on the shapes
of tests/test_pallas_compose.py: the exported pitch segments and energy
tails bit for bit on live slots (the Pallas kernel parks inactive
slots, so their exports are unspecified), and `buf` bit for bit except
where XLA:CPU evaluates the crossfade mix `cur*fo + x` of the
interpret-mode kernel as a fused multiply-add. There the port follows
the reference (a separately rounded multiply and add, as the NumPy
transcription below), and the Pallas result is the one that is 1 LSB
off. A NumPy walk per position (what the CUDA kernel computes) equals
the plain version bit for bit, on those inputs and on adversarial ones.
The card-only test holds the CUDA kernel to the plain version.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ctts_tpu.ops.pallas.compose import compose_units
from ctts_tpu_torch.ops.hopper import compose as hcompose

U, UBUF, CFMAX, TOT = 12, 2048, 1024, 16384
MARGIN = 2 * CFMAX
B = 2


def sentence(seed):
    """Ascending overlapping offsets with every alignment class, an
    inactive slot, random crossfades and analysis lengths."""
    rng = np.random.default_rng(seed)
    base_off = np.zeros(U, np.int32)
    cur = MARGIN
    for k in range(U):
        base_off[k] = cur + int(rng.integers(0, 96))
        cur += int(rng.integers(700, 1100))
    cf_in = rng.integers(0, CFMAX + 1, U).astype(np.int32)
    cf_in[0] = 0
    n_eff = rng.integers(CFMAX + 1, UBUF + 1, U).astype(np.int32)
    n_eff[5] = 0
    base_off[5] = 0
    ana = rng.integers(0, 2 * CFMAX + 1, U).astype(np.int32)
    contrib = np.trunc(rng.uniform(-8000, 8000, (U, UBUF))).astype(np.float32)
    fo = rng.uniform(0.0, 1.0, (U, CFMAX)).astype(np.float32)
    return base_off, cf_in, n_eff, ana, contrib, fo


def numpy_compose(base_off, cf_in, n_eff, contrib, fo):
    """The placement loop in NumPy, multiply and add rounded apart."""
    flat = np.zeros(TOT, np.float32)
    iu = np.arange(UBUF)
    for k in range(U):
        off, cf, n = int(base_off[k]), int(cf_in[k]), int(n_eff[k])
        if n == 0:
            continue
        cur = flat[off:off + UBUF].copy()
        x = contrib[k].copy()
        mixed = np.trunc(np.clip(np.trunc(cur[:CFMAX] * fo[k] + x[:CFMAX]),
                                 -32768.0, 32767.0)).astype(np.float32)
        x[:CFMAX] = np.where(iu[:CFMAX] < cf, mixed, x[:CFMAX])
        flat[off:off + UBUF] = np.where(iu < n, x, cur)
    return flat


def numpy_walk(base_off, cf_in, n_eff, ana, contrib, fo):
    """Placement as a function of position: the value at p starts from
    0.0f and applies, in ascending k, each active unit that covers p; an
    export of unit k is that walk over the units before k, read at its
    pre-merge windows (zeros for inactive slots)."""
    def walk(p, units):
        v = np.zeros(p.shape, np.float32)
        for k in units:
            n = min(int(n_eff[k]), UBUF)
            i = p - int(base_off[k])
            cover = (i >= 0) & (i < n)
            ic = np.clip(i, 0, UBUF - 1)
            x = contrib[k][ic]
            mixed = np.trunc(np.clip(np.trunc(
                v * fo[k][np.clip(ic, 0, CFMAX - 1)] + x), -32768.0, 32767.0))
            mix = i < min(int(cf_in[k]), CFMAX)
            v = np.where(cover, np.where(mix, mixed, x), v).astype(np.float32)
        return v

    active = [k for k in range(U) if n_eff[k] > 0]
    flat = walk(np.arange(TOT), active)
    seg = np.zeros((U, hcompose.SEGW), np.float32)
    tail = np.zeros((U, CFMAX), np.float32)
    for k in active:
        before = [u for u in active if u < k]
        at = int(base_off[k]) + int(cf_in[k])
        seg[k] = walk(at - int(ana[k]) + np.arange(hcompose.SEGW), before)
        tail[k] = walk(at - CFMAX + np.arange(CFMAX), before)
    return flat, seg, tail


def adversarial(seed):
    """Units 0-3 cover one stretch together (4 deep), unit 2 has
    cf > n_eff, unit 4 has cf = 0, slots 5 and 7 are inactive between
    active ones, and unit 1's exports reach before unit 0."""
    base_off, cf_in, n_eff, ana, contrib, fo = sentence(seed)
    base_off[:5] = [3000, 2600, 3300, 3500, 6000]
    n_eff[:5] = [2048, 1500, 700, 1200, 1800]
    cf_in[:5] = [0, 1024, 900, 1024, 0]
    ana[1] = 2048                       # segment starts at 1576 < 3000
    n_eff[7] = 0
    base_off[6] = 8000
    base_off[8:] = 9000 + 700 * np.arange(U - 8)
    return base_off, cf_in, n_eff, ana, contrib, fo


@pytest.mark.parametrize("which", ["sentences", "adversarial"])
def test_position_walk_matches_plain(which):
    rows = ([sentence(3), sentence(4)] if which == "sentences"
            else [adversarial(5), adversarial(6)])
    data = [np.stack([r[i] for r in rows]) for i in range(6)]
    if which == "adversarial":
        depth = np.zeros(TOT, int)
        for k in range(4):
            depth[data[0][0, k]:data[0][0, k] + data[2][0, k]] += 1
        assert depth.max() == 4 and data[1][0, 2] > data[2][0, 2]
    buf, seg, tail = hcompose.compose_plain(*_port_args(data, "cpu"), TOT,
                                            True)
    for b in range(B):
        want = numpy_walk(*[x[b] for x in data])
        assert np.array_equal(buf[b].numpy(), want[0])
        assert np.array_equal(seg[b].numpy(), want[1])
        assert np.array_equal(tail[b].numpy(), want[2])


@pytest.fixture(scope="module")
def batch():
    rows = [sentence(3), sentence(4)]
    return [np.stack([r[i] for r in rows]) for i in range(6)]


def _port_args(batch, device):
    base_off, cf_in, n_eff, ana, contrib, fo = [
        torch.as_tensor(x, device=device) for x in batch]
    return contrib, fo, base_off, cf_in, n_eff, ana


@pytest.mark.parametrize("export", [True, False])
def test_plain_matches_pallas(batch, export):
    buf, seg, tail = hcompose.compose(*_port_args(batch, "cpu"), TOT, export)
    assert hcompose.launches == 0
    for b in range(B):
        want = compose_units(*[jnp.asarray(x[b]) for x in batch],
                             U=U, UBUF=UBUF, CFMAX=CFMAX, TOT=TOT,
                             export=export, interpret=True)
        ref = numpy_compose(batch[0][b], batch[1][b], batch[2][b],
                            batch[4][b], batch[5][b])
        got, pal = buf[b].numpy(), np.asarray(want[0])
        assert np.array_equal(got, ref)
        # Where the two differ, Pallas fused the mix (1 sample here).
        assert (got != pal).sum() <= 1 and np.abs(got - pal).max() <= 1.0
        if export:
            live = batch[2][b] > 0
            assert np.array_equal(np.asarray(want[1])[live],
                                  seg[b].numpy()[live])
            assert np.array_equal(np.asarray(want[2])[live],
                                  tail[b].numpy()[live])


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(batch, cuda_device):
    args = _port_args(batch, cuda_device)
    before = hcompose.launches
    got = hcompose.compose(*args, TOT, True)
    assert hcompose.launches == before + 1
    for g, w in zip(got, hcompose.compose_plain(*args, TOT, True)):
        assert torch.equal(g, w)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
