"""Silence-removal tables of ctts_tpu_torch against the JAX package.

silence_tables_plain (ops/hopper/silence.py, what SynthesisCore.
_seg_tables returns) must equal, bit for bit, the JAX seg_table pass of
ctts_tpu/synth/device.py:1276-1291 (vmapped
ctts_tpu.ops.device_ops.silence_segments, then MARGIN, dst and the
remove mask) at the 32-slot table, on seeded rows that cover an all-zero
region, an empty one, one of length CONTW, one that removes no silence,
exactly 32 and 33 kept segments, and silent runs at the region's end.
At 256 and 512 slots (the widths rows run again at), the plain tables,
moved by the plain compaction, equal the NumPy oracle's
remove_silence_regions. On the CPU the wrapper runs the plain version;
the card-only tests hold the CUDA kernel to it.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ctts_tpu.ops import device_ops as jdops
from ctts_tpu.synth.dsp_np import remove_silence_regions
from ctts_tpu_torch.ops.hopper import compact as hcompact
from ctts_tpu_torch.ops.hopper import silence as hsilence

B, R, MARGIN, CONTW = 3, 4, 256, 12288
WREG = CONTW + 2 * MARGIN
NBLK = jdops.NBLK
THRESHOLDS = (0.02, 0.5, 0.1)


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run_length(min_silence: int) -> int:
    """The shortest silent run silence removal cuts."""
    return max(max(min_silence, 1), max(min_silence // 4, 10) + 1)


def speech(rng, n: int) -> np.ndarray:
    """Voiced stretches between low-noise silences of every length."""
    x = rng.normal(0, 6, n)
    pos = 0
    while pos < n:
        ln = int(rng.integers(50, 1500))
        seg = np.arange(min(ln, n - pos))
        x[pos:pos + ln] += rng.uniform(2000, 9000) * np.sin(
            2 * np.pi * rng.uniform(80, 300) * seg / 22050)
        pos += ln + int(rng.integers(1, 1200))
    return np.trunc(x)


def periodic(rng, runs: int, L: int, tail: int = 0) -> np.ndarray:
    """A loud sample, then `runs` times L silent samples and a loud one:
    runs + 1 kept segments; `tail` silent samples after the last."""
    x = [np.full(1, 9000.0)]
    for _ in range(runs):
        x += [rng.integers(-40, 41, L).astype(np.float64),
              np.full(1, -9000.0)]
    x.append(rng.integers(-40, 41, tail).astype(np.float64))
    return np.concatenate(x)


def make_rows(seed: int, min_silence: int):
    """bufs [B, R*WREG] f32, region_len [B, R] i32, region_remove [B, R]
    bool, threshold [B] f32: twelve region rows of the kinds above."""
    rng = np.random.default_rng(seed)
    L = run_length(min_silence)
    rows = [
        np.zeros(3000),                                  # all zero
        speech(rng, 2000),                               # length 0 below
        speech(rng, CONTW),                              # length CONTW
        speech(rng, 5000),                               # not removed
        periodic(rng, NBLK - 1, L),                      # 32 segments
        periodic(rng, NBLK, L),                          # 33 segments
        np.r_[speech(rng, 3000), np.zeros(L + 57)],      # silent end
        np.r_[speech(rng, 900), np.zeros(L)],            # end run of L
        np.r_[speech(rng, 900), np.zeros(L - 1)],        # one short of L
        speech(rng, int(rng.integers(1, CONTW))),
        periodic(rng, 3, L, tail=L + 5),
        speech(rng, int(rng.integers(1, CONTW))),
    ]
    bufs = np.zeros((B, R * WREG), np.float32)
    lens = np.zeros((B, R), np.int32)
    remove = np.ones((B, R), bool)
    for k, x in enumerate(rows):
        b, r = divmod(k, R)
        assert x.shape[0] <= CONTW
        o = r * WREG + MARGIN
        bufs[b, o:o + x.shape[0]] = x
        lens[b, r] = x.shape[0]
    lens[0, 1] = 0
    remove[0, 3] = False
    # Noise outside the content, which the tables must not read.
    for b in range(B):
        for r in range(R):
            o = r * WREG
            bufs[b, o:o + MARGIN] = rng.integers(-30000, 30000, MARGIN)
            bufs[b, o + MARGIN + CONTW:o + WREG] = rng.integers(
                -30000, 30000, WREG - MARGIN - CONTW)
    return bufs, lens, remove, np.array(THRESHOLDS, np.float32)


def jax_seg_tables(bufs, lens, remove, thr, min_silence):
    """ctts_tpu/synth/device.py:1276-1291 for each sentence: (starts,
    dst, seg_len [B, R, NBLK], new_len [B, R], ovf_count [B])."""
    def seg_table(threshold):
        def table(row, length, do_remove):
            starts, seg_len, new_len, ovf = jdops.silence_segments(
                row[MARGIN:MARGIN + CONTW], length, threshold, min_silence)
            starts = jnp.where(do_remove, starts, 0)
            seg_len = jnp.where(do_remove, seg_len, 0)
            new_len = jnp.where(do_remove, new_len, length)
            dst = MARGIN + jnp.concatenate(
                [jnp.zeros(1, jnp.int32), jnp.cumsum(seg_len)[:-1]])
            return starts + MARGIN, dst, seg_len, new_len, ovf & do_remove
        return table

    out = []
    for b in range(B):
        s, d, ln, nl, ovf = jax.vmap(seg_table(jnp.float32(thr[b])))(
            jnp.asarray(bufs[b].reshape(R, WREG)), jnp.asarray(lens[b]),
            jnp.asarray(remove[b]))
        out.append((s, d, ln, nl, jnp.sum(ovf.astype(jnp.int32))))
    return [np.stack([np.asarray(o[i]) for o in out]) for i in range(5)]


def plain(bufs, lens, remove, thr, min_silence, nblk):
    return hsilence.silence_tables_plain(
        torch.as_tensor(bufs), torch.as_tensor(lens),
        torch.as_tensor(remove), torch.as_tensor(thr), min_silence, nblk,
        MARGIN, CONTW)


@pytest.mark.parametrize("min_silence", [22, 330])
def test_plain_equals_jax_seg_table(min_silence):
    rows = make_rows(3 + min_silence, min_silence)
    got = plain(*rows, min_silence, NBLK)
    want = jax_seg_tables(*rows, min_silence)
    for name, g, w in zip(("starts", "dst", "seg_len", "new_len",
                           "ovf_count"), got, want):
        assert g.shape == w.shape, name
        assert np.array_equal(g.numpy(), w.astype(g.numpy().dtype)), name
    assert [g.dtype for g in got] == [torch.int32] * 3 + [torch.int64,
                                                           torch.int32]
    seg_len = got[2].numpy()
    used = (seg_len > 0).sum(-1)
    assert used[1, 0] == NBLK and seg_len[1, 0, -1] > 0      # exactly 32
    assert used[1, 1] == NBLK                                # 33: catch-all
    assert got[4].tolist() == [0, 1, 0]                      # its overflow
    assert used[0, 0] == 0 and used[0, 1] == 0 and used[0, 3] == 0


@pytest.mark.parametrize("nblk", [256, 512])
def test_plain_wide_tables_equal_the_oracle(nblk):
    """At a table wide enough for every kept segment (min_silence 22,
    thresholds up to 0.5), nothing overflows and each removed region,
    moved by its tables, is the oracle's remove_silence_regions."""
    min_silence = 22
    bufs, lens, remove, thr = make_rows(40 + nblk, min_silence)
    # Rows up to the width's bound (kept_segments_bound <= nblk).
    L = run_length(min_silence)
    rng = np.random.default_rng(nblk)
    x = periodic(rng, nblk - 1, L)[:CONTW]
    o = 2 * WREG + MARGIN
    bufs[1, o:o + x.shape[0]] = x
    lens[1, 2] = x.shape[0]
    starts, dst, seg_len, new_len, ovf = plain(bufs, lens, remove, thr,
                                               min_silence, nblk)
    assert ovf.tolist() == [0, 0, 0]
    assert int((seg_len > 0).sum(-1).max()) == min(nblk, x.shape[0] //
                                                   (L + 1) + 1)
    moved = hcompact.compact_plain(torch.as_tensor(bufs), starts, dst,
                                   seg_len, WREG).numpy()
    for b in range(B):
        for r in range(R):
            n = int(lens[b, r])
            row = bufs[b, r * WREG + MARGIN:r * WREG + MARGIN + n]
            want = (remove_silence_regions(row.astype(np.int16),
                                           float(thr[b]), min_silence)
                    if remove[b, r] else row.astype(np.int16))
            got = moved[b, r * WREG + MARGIN:][:int(new_len[b, r])]
            assert int(new_len[b, r]) == want.shape[0], (b, r)
            assert np.array_equal(got.astype(np.int16), want), (b, r)


def test_cpu_dispatch_runs_the_plain_version():
    rows = make_rows(5, 330)
    args = [torch.as_tensor(x) for x in rows]
    before = hsilence.launches
    got = hsilence.silence_tables(*args, 330, NBLK, MARGIN, CONTW)
    assert hsilence.launches == before
    for g, w in zip(got, plain(*rows, 330, NBLK)):
        assert torch.equal(g, w)
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="unsupported device"):
        hsilence.silence_tables(*meta, 330, NBLK, MARGIN, CONTW)


def test_the_core_takes_its_tables_from_the_wrapper(monkeypatch):
    """SynthesisCore._seg_tables is the wrapper's call, with the plan's
    region arrays and dims."""
    from types import SimpleNamespace

    from ctts_tpu_torch.synth import device

    rows = make_rows(6, 22)
    bufs, lens, remove, thr = (torch.as_tensor(x) for x in rows)
    seen = []

    def wrapper(*args):
        seen.append(args)
        return hsilence.silence_tables(*args)

    monkeypatch.setattr(device, "silence_tables", wrapper)
    dims = SimpleNamespace(MARGIN=MARGIN, CONTW=CONTW,
                           min_silence_samples=22)
    ar = {"region_len": lens, "region_remove": remove, "threshold": thr}
    got = device.SynthesisCore._seg_tables(None, dims, ar, bufs, 64)
    assert len(seen) == 1 and seen[0][4:] == (22, 64, MARGIN, CONTW)
    for g, w in zip(got, plain(*rows, 22, 64)):
        assert torch.equal(g, w)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("min_silence,nblk",
                         [(330, 32), (22, 32), (22, 33), (22, 256),
                          (44, 512)])
def test_kernel_matches_plain_on_card(cuda_device, min_silence, nblk):
    rows = make_rows(7 + nblk, min_silence)
    args = [torch.as_tensor(x, device=cuda_device) for x in rows]
    before = hsilence.launches
    got = hsilence.silence_tables(*args, min_silence, nblk, MARGIN, CONTW)
    assert hsilence.launches == before + 1
    want = hsilence.silence_tables_plain(*args, min_silence, nblk, MARGIN,
                                         CONTW)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
