"""The port's WSOLA (ctts_tpu_torch/ops/wsola.py) against ctts_tpu's.

(a) wsola_frames_plain (what the CPU runs, and what the Hopper kernel
    is held to on the card) equals the Pallas frame-chain kernels in
    interpret mode bit for bit: wsola_frames on the cases of
    tests/test_pallas_wsola.py, wsola_frames_batch on its ragged
    5-row batch (one row with nrun = 0).
(b) time_stretch equals time_stretch_device (the XLA scan) bit for
    bit on the same cases, at speed 1.005 (passthrough with the
    stretch branch compiled), and on a mixed batch of B = 5 rows.
(c) the exact energy table equals _sliding_sumsq.
(d) torch's int64 -> float32 conversion rounds once, correctly, like
    numpy's int64 -> float64 -> float32 for integers below 2^53.
S = 4096, as in tests/test_pallas_wsola.py, so the JAX compiles stay
small.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ctts_tpu.ops.wsola_jax import (
    _sliding_sumsq,
    _wsola_planes,
    time_stretch_device,
)
from ctts_tpu_torch.ops import wsola as tw

F32 = jnp.float32
S = 4096
OUT_SIZE = 2 * S + 2048

CASES = [
    ("tonal", 3000, 1.5),
    ("tonal", 3000, 0.5),
    ("noise", 4096, 1.25),
    ("periodic", 2500, 0.75),
    ("tonal", 600, 2.0),     # barely more than one frame
    ("tonal", 400, 1.5),     # input < FRAME: no frame runs
]


@pytest.fixture(autouse=True)
def _drop_jax_executables():
    """XLA:CPU segfaults once enough executables of these tests stay
    resident in one process (the same fragility conftest.py's module
    fixture guards against); drop them after every test."""
    yield
    jax.clear_caches()


def _signal(rng, n, kind):
    t = np.arange(n, dtype=np.float32)
    if kind == "tonal":
        x = (6000 * np.sin(2 * np.pi * 137.3 * t / 22050)
             + 2500 * np.sin(2 * np.pi * 291.7 * t / 22050)
             + rng.normal(0, 300, n))
    elif kind == "noise":
        x = rng.normal(0, 5000, n)
    else:  # periodic near-ties: the tie-break stressor
        x = 8000 * np.sin(2 * np.pi * 128 * t / 22050)
    return np.trunc(np.clip(x, -32768, 32767)).astype(np.float32)


def _row(kind, count, seed):
    buf = np.zeros(S, np.float32)
    if count:
        buf[:count] = _signal(np.random.default_rng(seed), count, kind)
    return buf


def _jax_planes(buf, count, hop):
    """ctts_tpu's kernel input planes and run count for one row."""
    max_steps = tw.max_steps_for(S, OUT_SIZE, hop)
    ks = np.arange(max_steps)
    frames = (count - tw.FRAME) // tw.AHOP + 1 if count > tw.FRAME else 1
    alloc = frames * hop + tw.FRAME + 1024
    run_all = jnp.asarray((ks * tw.AHOP + tw.FRAME <= count)
                          & (ks * hop + tw.FRAME <= alloc)
                          & (ks * hop + tw.FRAME <= OUT_SIZE))
    return _wsola_planes(jnp.asarray(buf), run_all, max_steps)


def _port_frames(rows, counts, hop):
    inp = torch.as_tensor(np.stack(rows))
    ic = torch.tensor(counts, dtype=torch.int32)
    nrun = tw.run_counts(ic, S, OUT_SIZE, hop)
    acc, norm = tw.wsola_frames_plain(inp, tw.energy_table(inp), ic, nrun,
                                      hop, OUT_SIZE)
    return acc.numpy(), norm.numpy(), nrun.numpy()


@pytest.mark.parametrize("kind,count,speed", CASES)
def test_frames_plain_matches_pallas_kernel(kind, count, speed):
    from ctts_tpu.ops.pallas.wsola import wsola_frames

    hop = tw.synthesis_hop_for_speed(speed)
    buf = _row(kind, count, count)
    iv, sqs, sq4, nrun = _jax_planes(buf, count, hop)
    acc_j, norm_j = wsola_frames(iv, sqs, sq4, jnp.int32(count), nrun,
                                 hop=hop, out_size=OUT_SIZE, interpret=True)
    acc, norm, nrun_t = _port_frames([buf], [count], hop)
    assert int(nrun) == int(nrun_t[0])
    assert np.array_equal(acc[0], np.asarray(acc_j))
    assert np.array_equal(norm[0], np.asarray(norm_j))


def test_frames_plain_matches_pallas_batch_kernel():
    """Ragged rows, one empty (nrun = 0), one below FRAME."""
    from ctts_tpu.ops.pallas.wsola import wsola_frames_batch
    from ctts_tpu.parallel.batch import _no_persistent_cache

    hop = tw.synthesis_hop_for_speed(1.5)
    counts = [3000, 4096, 400, 1800, 0]
    kinds = ["tonal", "noise", "tonal", "periodic", "tonal"]
    rows = [_row(k, c, 23 + i)
            for i, (k, c) in enumerate(zip(kinds, counts))]
    planes = [_jax_planes(b, c, hop) for b, c in zip(rows, counts)]
    stack = [jnp.stack([p[i] for p in planes]) for i in range(4)]
    with _no_persistent_cache():
        # Serializing the interpret-mode batch-kernel executable
        # segfaults XLA:CPU's cache writer (tests/test_pallas_wsola.py).
        acc_j, norm_j = wsola_frames_batch(
            stack[0], stack[1], stack[2], jnp.asarray(counts, jnp.int32),
            stack[3], hop=hop, out_size=OUT_SIZE, S=5, interpret=True)
    acc, norm, nrun = _port_frames(rows, counts, hop)
    assert nrun.tolist() == np.asarray(stack[3]).tolist()
    assert nrun[-1] == 0 and nrun[2] == 0
    assert np.array_equal(acc, np.asarray(acc_j))
    assert np.array_equal(norm, np.asarray(norm_j))


def _jax_stretch(buf, count, speed, hop):
    out, n = time_stretch_device(jnp.asarray(buf), jnp.int32(count),
                                 F32(speed), OUT_SIZE, hop)
    return np.asarray(out), int(n)


@pytest.mark.parametrize("kind,count,speed",
                         CASES + [("tonal", 3000, 1.005)])
def test_time_stretch_matches_xla_scan(monkeypatch, kind, count, speed):
    monkeypatch.setenv("CTTS_WSOLA_BACKEND", "xla")
    hop = tw.synthesis_hop_for_speed(speed)
    buf = _row(kind, count, count)
    want, want_n = _jax_stretch(buf, count, speed, hop)
    out, n = tw.time_stretch(torch.as_tensor(buf)[None],
                             torch.tensor([count], dtype=torch.int32),
                             torch.tensor([speed], dtype=torch.float32),
                             OUT_SIZE, hop)
    assert out.dtype == torch.float32 and n.dtype == torch.int32
    assert int(n[0]) == want_n
    assert np.array_equal(out[0].numpy(), want)


def test_time_stretch_batch_matches_xla_scan(monkeypatch):
    """B = 5 rows of one bucket (one hop), mixed counts and speeds: the
    speed-1.005 row passes through, the empty row gives length 0."""
    monkeypatch.setenv("CTTS_WSOLA_BACKEND", "xla")
    hop = tw.synthesis_hop_for_speed(1.5)
    counts = [3000, 4096, 400, 0, 2500]
    kinds = ["tonal", "noise", "tonal", "tonal", "periodic"]
    speeds = [1.5, 1.5, 1.5, 1.5, 1.005]
    rows = [_row(k, c, 40 + i)
            for i, (k, c) in enumerate(zip(kinds, counts))]
    out, n = tw.time_stretch(torch.as_tensor(np.stack(rows)),
                             torch.tensor(counts, dtype=torch.int32),
                             torch.tensor(speeds, dtype=torch.float32),
                             OUT_SIZE, hop)
    assert int(n[3]) == 0 and int(n[4]) == counts[4]
    for i, (buf, c, s) in enumerate(zip(rows, counts, speeds)):
        want, want_n = _jax_stretch(buf, c, s, hop)
        assert int(n[i]) == want_n, i
        assert np.array_equal(out[i].numpy(), want), i


def test_energy_table_matches_sliding_sumsq():
    rng = np.random.default_rng(5)
    rows = np.stack([_row("noise", S, 1), _row("tonal", 2000, 2),
                     np.where(rng.random(S) < 0.5, 32767.0, -32768.0
                              ).astype(np.float32)])
    got = tw.sliding_sumsq(torch.as_tensor(rows), tw.OVERLAP).numpy()
    for r in range(rows.shape[0]):
        want = np.asarray(_sliding_sumsq(jnp.asarray(rows[r]), tw.OVERLAP))
        assert np.array_equal(got[r], want), r
    table = tw.energy_table(torch.as_tensor(rows)).numpy()
    assert table.shape == rows.shape
    assert np.array_equal(table[:, :S - tw.OVERLAP + 1], got)


def test_int64_to_float32_rounds_once():
    """Every exact sum the port rounds to f32 (energies, numerators) is
    an int64 below 2^53; torch's conversion equals numpy's exact f64
    step followed by one f64 -> f32 rounding, including the halfway
    cases (ties to even)."""
    rng = np.random.default_rng(11)
    vals = [rng.integers(-2**39, 2**39, 200_000),
            rng.integers(0, 2**52, 100_000)]
    for e in range(24, 53):
        base = rng.integers(2**(e - 1), 2**e, 2000)
        ulp = 1 << (e - 24)
        base -= base % ulp
        vals.append(base + ulp // 2)             # exact halfway cases
        vals.append(base + ulp // 2 + 1)
        vals.append(-(base + ulp // 2))
    v = np.concatenate(vals).astype(np.int64)
    got = torch.as_tensor(v).to(torch.float32).numpy()
    want = v.astype(np.float64).astype(np.float32)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_wrapper_takes_plain_only_on_cpu():
    """A CPU tensor runs the plain chain and counts no launch; a tensor
    on any device other than CPU or CUDA is refused."""
    from ctts_tpu_torch.ops.hopper import wsola as hwsola

    hop = tw.synthesis_hop_for_speed(1.5)
    inp = torch.as_tensor(_row("tonal", 3000, 3))[None]
    ic = torch.tensor([3000], dtype=torch.int32)
    nrun = tw.run_counts(ic, S, OUT_SIZE, hop)
    sq = tw.energy_table(inp)
    before = hwsola.launches
    acc, norm = hwsola.wsola_frames(inp, sq, ic, nrun, hop, OUT_SIZE)
    want = tw.wsola_frames_plain(inp, sq, ic, nrun, hop, OUT_SIZE)
    assert torch.equal(acc, want[0]) and torch.equal(norm, want[1])
    meta = [t.to("meta") for t in (inp, sq, ic, nrun)]
    with pytest.raises(ValueError, match="unsupported device"):
        hwsola.wsola_frames(*meta, hop, OUT_SIZE)
    assert hwsola.launches == before


def _valid_positions(count, nrun, js):
    """Candidates at window indices js that lie inside [0, count), over
    the frames k = 1..nrun-1 that search."""
    k = np.arange(1, max(nrun, 1))[:, None]
    pos = k * tw.AHOP + np.asarray(js)[None, :] - tw.MAX_SHIFT
    return int(((pos >= 0) & (pos + tw.FRAME <= count)).sum())


def test_searched_counts_the_valid_candidates():
    """The plain chain's candidate counts (the work chip_smoke.py
    bounds): valid coarse candidates in closed form, and on a silent
    row the fine ones too (every correlation is 0, so the earliest coarse
    candidate, offset -128, wins and only +1..+3 lie in the window)."""
    hop = tw.synthesis_hop_for_speed(1.5)
    counts = [3000, 4096, 400, 1800, 0, 2500]
    kinds = ["tonal", "noise", "tonal", "periodic", "tonal", "tonal"]
    rows = [_row(k, c, 60 + i) for i, (k, c) in enumerate(zip(kinds, counts))]
    rows[-1][:] = 0.0
    inp = torch.as_tensor(np.stack(rows))
    ic = torch.tensor(counts, dtype=torch.int32)
    nrun = tw.run_counts(ic, S, OUT_SIZE, hop)
    sq = tw.energy_table(inp)
    searched = {}
    acc, norm = tw.wsola_frames_plain(inp, sq, ic, nrun, hop, OUT_SIZE,
                                      searched=searched)
    want = tw.wsola_frames_plain(inp, sq, ic, nrun, hop, OUT_SIZE)
    assert torch.equal(acc, want[0]) and torch.equal(norm, want[1])
    per_row = []
    for b in range(len(counts)):
        d = {}
        tw.wsola_frames_plain(inp[b:b + 1], sq[b:b + 1], ic[b:b + 1],
                              nrun[b:b + 1], hop, OUT_SIZE, searched=d)
        per_row.append(d)
        nr = int(nrun[b])
        assert d["coarse"] == _valid_positions(
            counts[b], nr, 4 * np.arange(tw.NCOARSE)), b
        assert 0 <= d["fine"] <= 6 * max(nr - 1, 0), b
    assert per_row[-1]["fine"] == 3 * (int(nrun[-1]) - 1) > 0
    assert per_row[4] == {"coarse": 0, "fine": 0}
    for key in ("coarse", "fine"):
        assert searched[key] == sum(d[key] for d in per_row)


def _numpy_emit(inp, pos, nrun, hop):
    """The overlap-add from the chosen positions, per output sample: the
    frames k < nrun that cover it, added in ascending k from 0.0f."""
    window = tw.hann(tw.FRAME, "cpu").numpy()
    i = np.arange(tw.FRAME)
    acc = np.zeros((inp.shape[0], OUT_SIZE), np.float32)
    norm = np.zeros_like(acc)
    for b in range(inp.shape[0]):
        for k in range(int(nrun[b])):
            frame = inp[b, pos[b, k] + i]
            at = k * hop + i
            acc[b, at] = acc[b, at] + np.trunc(frame * window)
            norm[b, at] = norm[b, at] + window
    return acc, norm


@pytest.mark.parametrize("speed", [1.5, 0.5])
def test_emit_from_choices_matches_plain(speed):
    """The kernel's split: the chain's chosen positions alone, added per
    output sample in ascending frame order, give the plain chain's
    (acc, norm) bit for bit (hop 85 and 256; rows of length 0, 300 and
    S)."""
    hop = tw.synthesis_hop_for_speed(speed)
    assert hop == {1.5: 85, 0.5: 256}[speed]
    counts = [0, 300, S, S]
    rows = [_row("tonal", 0, 1), _row("noise", 300, 2), _row("tonal", S, 3),
            _row("periodic", S, 4)]
    inp = torch.as_tensor(np.stack(rows))
    ic = torch.tensor(counts, dtype=torch.int32)
    nrun = tw.run_counts(ic, S, OUT_SIZE, hop)
    sq = tw.energy_table(inp)
    choices = {}
    acc, norm = tw.wsola_frames_plain(inp, sq, ic, nrun, hop, OUT_SIZE,
                                      choices=choices)
    pos, nr = choices["pos"].numpy(), nrun.numpy()
    assert pos.shape == (4, tw.max_steps_for(S, OUT_SIZE, hop))
    assert pos.dtype == np.int32 and nr.tolist()[:2] == [0, 0] and nr[2] > 0
    for b in range(4):
        live = pos[b, :nr[b]]
        assert (pos[b, nr[b]:] == -1).all()
        assert ((live >= 0) & (live + tw.FRAME <= counts[b])).all()
    want = _numpy_emit(inp.numpy(), pos, nr, hop)
    assert np.array_equal(acc.numpy(), want[0])
    assert np.array_equal(norm.numpy(), want[1])


def test_chain_floor_needs_the_card():
    from ctts_tpu_torch.ops.hopper import wsola as hwsola

    inp = torch.zeros(2, S)
    ic = torch.tensor([S, 0], dtype=torch.int32)
    nrun = torch.tensor([3, 0], dtype=torch.int32)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        hwsola.chain_floor(inp, tw.energy_table(inp), ic, nrun, 8)


@pytest.mark.cuda
def test_chain_floor_runs_on_card(cuda_device):
    """The latency floor and the decide launch with its prefetch launch
    and mark the frames past nrun with -1; with the prefetch, the chosen
    positions are the plain chain's."""
    from ctts_tpu_torch.ops.hopper import wsola as hwsola

    hop = tw.synthesis_hop_for_speed(1.5)
    inp = torch.as_tensor(np.stack([_row("tonal", S, 5), _row("noise", S, 6)]),
                          device=cuda_device)
    ic = torch.tensor([S, S], dtype=torch.int32, device=cuda_device)
    nrun = torch.tensor([20, 0], dtype=torch.int32, device=cuda_device)
    sq = tw.energy_table(inp)
    steps = tw.max_steps_for(S, OUT_SIZE, hop)
    choices = {}
    tw.wsola_frames_plain(inp, sq, ic, nrun, hop, OUT_SIZE, choices=choices)
    before = hwsola.launches
    out = hwsola.chain_floor(inp, sq, ic, nrun, steps).cpu()
    assert (out[0, 20:] == -1).all() and (out[1] == -1).all()
    assert ((out[0, :20] >= 0) & (out[0, :20] <= S - tw.FRAME)).all()
    got = hwsola.decide(inp, sq, ic, nrun, steps)
    assert torch.equal(got, choices["pos"])
    assert hwsola.launches == before


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(cuda_device):
    """The Hopper kernel equals the plain chain bit for bit on the
    ragged batch of test_frames_plain_matches_pallas_batch_kernel."""
    from ctts_tpu_torch.ops.hopper import wsola as hwsola

    hop = tw.synthesis_hop_for_speed(1.5)
    counts = [3000, 4096, 400, 1800, 0]
    kinds = ["tonal", "noise", "tonal", "periodic", "tonal"]
    inp = torch.as_tensor(np.stack([
        _row(k, c, 23 + i) for i, (k, c) in enumerate(zip(kinds, counts))]),
        device=cuda_device)
    ic = torch.tensor(counts, dtype=torch.int32, device=cuda_device)
    nrun = tw.run_counts(ic, S, OUT_SIZE, hop)
    sq = tw.energy_table(inp)
    before = hwsola.launches
    got, want = {}, {}
    acc, norm = hwsola.wsola_frames(inp, sq, ic, nrun, hop, OUT_SIZE,
                                    choices=got)
    assert hwsola.launches == before + 1
    plain = tw.wsola_frames_plain(inp, sq, ic, nrun, hop, OUT_SIZE,
                                  choices=want)
    assert torch.equal(acc, plain[0]) and torch.equal(norm, plain[1])
    assert torch.equal(got["pos"], want["pos"])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
