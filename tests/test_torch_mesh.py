"""The row split of ctts_tpu_torch (parallel/mesh.py, the mesh branch of
parallel/batch.py, CTTSEngine(mesh=...), testing/dryrun.py) on the CPU,
with the analogs of tests/test_device_executor.py:110, 290, 326, 400 and
445 over meshes of repeated CPU devices.

(a) a mesh of [cpu] * 4 gives the port's unsplit output bit for bit,
    within 2 LSB of the oracle; stream equals synthesize on a 9-text
    batch (padded to 16); the same 9 texts through the JAX package's
    unsplit BatchSynthesizer (the bucket test_device_executor.py:336
    compiles): equal lengths, <= 1 LSB (the FMA difference of ROADMAP
    Queue C);
(b) the per-shard trim and drain on a ragged batch with a zero-length
    row, with and without the wire codec; _next_batch_size with mesh
    multiples; dryrun_multigpu([cpu] * 4); CTTSEngine with a mesh equal
    to the engine without one;
(c) the forward path under a mesh calls nothing of torch.distributed;
    make_mesh's defaults and refusals;
(d) a kernel launch goes to the current stream of its tensor's device,
    with that device current (on the CPU through a stand-in library; on
    two cards for real).
"""

import numpy as np
import pytest
import torch

from ctts_tpu.config import config_defaults
from ctts_tpu.db.reader import VoiceDatabase
from ctts_tpu.plan.compiler import compile_plan
from ctts_tpu.synth.oracle import execute_plan_oracle

CPU = torch.device("cpu")
# tests/test_device_executor.py:125-126 and :338-339.
TEXTS8 = ["como vai", "bom dia", "que legal", "a rosa", "vamos",
          "sim claro", "oi", "nada"]
TEXTS9 = ["como vai", "bom dia. tudo bem.", "que legal", "a rosa",
          "vamos", "oi", "nada", "sim claro", "mais um"]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The suite runs in six workers on a few cores: a small intra-op
    pool keeps torch's many small CPU ops from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _max_diff(a, b):
    assert a.shape == b.shape
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max(initial=0))


@pytest.fixture(scope="module")
def db(voice_db):
    return VoiceDatabase(voice_db)


@pytest.fixture(scope="module")
def plain(db):
    from ctts_tpu_torch.parallel.batch import BatchSynthesizer

    return BatchSynthesizer(db, config_defaults(), device=CPU)


@pytest.fixture(scope="module")
def unsplit9(plain):
    return plain.synthesize(TEXTS9)


@pytest.fixture(scope="module")
def split(db):
    from ctts_tpu_torch.parallel import BatchSynthesizer, make_mesh

    return BatchSynthesizer(db, config_defaults(), mesh=make_mesh([CPU] * 4))


def test_mesh_equals_unsplit_and_oracle(db, plain, split):
    assert [s.device for s in split.shards] == [CPU] * 4
    assert len({id(s.core) for s in split.shards}) == 1   # one device
    got = split.synthesize(TEXTS8)
    want = plain.synthesize(TEXTS8)
    for t, o, w in zip(TEXTS8, got, want):
        assert o.dtype == np.int16 and np.array_equal(o, w), t
        ref = execute_plan_oracle(
            compile_plan(db, t, config_defaults(), None, 1.0), db)
        assert _max_diff(o, ref) <= 2, t


@pytest.mark.parametrize("wire", [False, True], ids=["plain", "wire"])
def test_stream_matches_synthesize_on_mesh(db, unsplit9, wire):
    from ctts_tpu_torch.parallel import BatchSynthesizer, make_mesh

    bs = BatchSynthesizer(db, config_defaults(), mesh=make_mesh([CPU] * 4),
                          wire=wire)
    got = list(bs.stream(iter([TEXTS9, TEXTS9[:3]])))
    want = bs.synthesize(TEXTS9)
    assert [len(g) for g in got] == [9, 3]
    for t, o, w, p in zip(TEXTS9, got[0], want, unsplit9):
        assert np.array_equal(o, w) and np.array_equal(o, p), t
    for o, w in zip(got[1], want):
        assert np.array_equal(o, w)


def test_mesh_matches_jax_unsplit(db, split):
    """The JAX package's unsplit batch path on the 9 texts (the bucket
    test_device_executor.py:336 compiles, so its core comes from the
    persistent cache): equal lengths, <= 1 LSB."""
    from ctts_tpu.parallel.batch import BatchSynthesizer as JBatch
    from ctts_tpu.parallel.batch import release_compiled

    want = JBatch(db, config_defaults()).synthesize(TEXTS9)
    got = split.synthesize(TEXTS9)
    release_compiled()
    for t, o, w in zip(TEXTS9, got, want):
        assert o.shape == w.shape, t
        assert _max_diff(o, w) <= 1, t


@pytest.mark.parametrize("wire", [False, True], ids=["plain", "wire"])
def test_trim_and_drain_layout(db, wire):
    """Per-shard trim and drain on a ragged batch: 8 slots over 4 shards
    of 2, the last 3 slots pad rows (so shard 3 holds none and is not
    copied), slot 3 a zero-length row; slots map back to row ids
    through a permutation; the real rows whose overflow count is above
    0 (one per shard, and a pad row's is not read) run again as one
    batch, and their outputs take those rows' places after the decode."""
    from ctts_tpu_torch.ops import wire as wire_codec
    from ctts_tpu_torch.parallel import BatchSynthesizer, make_mesh
    from ctts_tpu_torch.parallel.batch import Enqueued, pack_rows

    bs = BatchSynthesizer(db, config_defaults(), mesh=make_mesh([CPU] * 4),
                          wire=wire, native_plans=False)
    ndev, rows, om = 4, 2, 700
    bsz, n = ndev * rows, ndev * rows - 3
    rng = np.random.default_rng(3)
    lens = rng.integers(1, om + 1, bsz).astype(np.int32)
    lens[3] = 0
    out = rng.integers(-32768, 32768, (bsz, om)).astype(np.int16)
    handles = []
    for d in range(ndev):
        sl = slice(d * rows, (d + 1) * rows)
        ln = torch.as_tensor(lens[sl])
        payload = pack_rows(torch.as_tensor(out[sl]), ln)
        classes = None
        if wire:
            pad = -payload.shape[0] % wire_codec.WIRE_BLOCK
            payload, classes = wire_codec.encode(
                torch.cat([payload, payload.new_zeros(pad)]))
        ovf = torch.tensor([d, 0], dtype=torch.int32)
        handles.append((payload, classes, ln, ovf))
    idxs = [4, 0, 3, 1, 2] + [-1] * 3        # slot -> row id
    widened = {}

    def widen(handle, slots):
        widened["slots"] = slots
        return {s: np.full(s + 1, -s, np.int16) for s in slots}

    bs._widen = widen
    trimmed = bs._trim((n, [(idxs, Enqueued(n, rows, handles, None,
                                            None))]))
    shards, wide = trimmed[1][0][1]
    assert len(shards) == 3                   # shard 3: pad rows only
    assert widened["slots"] == [2, 4]         # shard 3's slot 6 is a pad
    got = bs._drain(trimmed)
    assert len(got) == n
    for slot in range(n):
        want = wide[slot] if slot in wide else out[slot, :lens[slot]]
        assert got[idxs[slot]].dtype == np.int16
        assert np.array_equal(got[idxs[slot]], want), slot
    assert got[idxs[3]].shape == (0,)
    assert np.array_equal(got[idxs[4]], np.full(5, -4, np.int16))


def test_next_batch_size_mesh_multiples():
    from ctts_tpu.parallel.batch import _next_batch_size as jax_size
    from ctts_tpu_torch.parallel.batch import _next_batch_size

    assert _next_batch_size(72, 1) == 72
    assert _next_batch_size(65, 1) == 72
    assert _next_batch_size(1, 1) == 8
    assert _next_batch_size(72, 16) == 80
    assert _next_batch_size(8, 8) == 8
    assert _next_batch_size(9, 4) == 16
    assert _next_batch_size(9, 2) == 16
    assert _next_batch_size(1, 3) == 24
    assert _next_batch_size(25, 6) == 48
    for n in range(1, 70, 3):
        for m in range(1, 13):
            assert _next_batch_size(n, m) == jax_size(n, m), (n, m)
            assert _next_batch_size(n, m) % m == 0


def test_dryrun_multigpu_cpu(voice_db):
    from ctts_tpu_torch.testing.dryrun import dryrun_multigpu

    res = dryrun_multigpu([CPU] * 4, voice_db)
    assert res["devices"] == ["cpu"] * 4
    assert res["sentences"] == 8 and res["stream_rows"] == [11, 3]
    assert res["samples"] > 0


def test_engine_mesh_equals_engine(voice_db):
    from ctts_tpu_torch.models.engine import CTTSEngine
    from ctts_tpu_torch.parallel import make_mesh

    meshed = CTTSEngine(voice_db, mesh=make_mesh([CPU] * 2))
    single = CTTSEngine(voice_db, device=CPU)
    texts = TEXTS8[:5]
    try:
        for speed in (1.0, 1.5):
            got = meshed.synthesize_batch(texts, speed)
            want = single.synthesize_batch(texts, speed)
            for t, o, w in zip(texts, got, want):
                assert np.array_equal(o, w), (t, speed)
        assert meshed._batcher.mesh.size == 2
        assert np.array_equal(meshed.synthesize("como vai"),
                              single.synthesize("como vai"))
    finally:
        meshed.close()
        single.close()


def test_mesh_forward_calls_no_collective(monkeypatch, split):
    import torch.distributed as dist

    def refuse(*args, **kwargs):
        raise AssertionError("torch.distributed called on the forward path")

    for name in ("init_process_group", "all_gather", "all_gather_object",
                 "all_gather_into_tensor", "all_reduce", "all_to_all",
                 "all_to_all_single", "barrier", "broadcast",
                 "broadcast_object_list", "gather", "reduce", "reduce_scatter",
                 "reduce_scatter_tensor", "scatter", "send", "recv",
                 "isend", "irecv"):
        if hasattr(dist, name):
            monkeypatch.setattr(dist, name, refuse)
    assert len(split.synthesize(TEXTS9)) == 9
    assert [len(b) for b in split.stream(iter([TEXTS8, TEXTS8[:2]]))] \
        == [8, 2]


def test_make_mesh_defaults_and_refusals():
    from ctts_tpu_torch.parallel.mesh import Mesh, first_device, make_mesh

    mesh = make_mesh(["cpu", torch.device("cpu")])
    assert mesh == Mesh((CPU, CPU)) and mesh.size == 2
    if torch.cuda.is_available():
        assert make_mesh().size == torch.cuda.device_count()
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh(["cuda:0"])
    with pytest.raises(ValueError, match="mixed"):
        make_mesh(["cpu", "cuda:0"])
    with pytest.raises(ValueError, match="no devices"):
        make_mesh([])
    with pytest.raises(ValueError, match="unsupported"):
        make_mesh(["meta"])
    assert first_device(None, CPU) == CPU
    assert first_device(mesh, None) == CPU
    with pytest.raises(TypeError):
        first_device(object(), None)
    with pytest.raises(ValueError, match="not both"):
        first_device(mesh, CPU)


class _Stream:
    def __init__(self, device):
        self.cuda_stream = 1000 + device.index


def test_launch_uses_the_tensor_device_stream(monkeypatch):
    """build.launch makes the tensors' device current and passes that
    device's current stream, whatever device the caller has current; a
    nonzero return raises."""
    from contextlib import contextmanager

    from ctts_tpu_torch.ops.hopper import build

    seen = []

    class Lib:
        def ctts_compact(self, *args):
            seen.append((list(current), args))
            return args[0]

        def ctts_error_string(self, rc):
            return b"refused"

    current = [0]

    @contextmanager
    def device(dev):
        current.append(dev.index)
        try:
            yield
        finally:
            current.pop()

    monkeypatch.setattr(build, "lib", Lib)
    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_stream", _Stream)
    build.launch("ctts_compact", torch.device("cuda", 1), 0, 7)
    assert seen == [([0, 1], (0, 7, 1001))]
    with pytest.raises(RuntimeError, match="CUDA error 2 .refused."):
        build.launch("ctts_compact", torch.device("cuda", 3), 2)
    assert seen[-1] == ([0, 3], (2, 1003))


@pytest.mark.cuda
def test_kernels_on_second_device():
    """With cuda:0 current, kernels on cuda:1 tensors launch there and
    equal their plain versions (needs two cards)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from ctts_tpu_torch.ops.hopper import assemble, compact, pitch

    dev = torch.device("cuda", 1)
    rng = np.random.default_rng(0)
    seg = torch.as_tensor(rng.integers(-32768, 32768, (64, 495))
                          .astype(np.float32), device=dev)
    ana = torch.as_tensor(rng.integers(0, 221, 64).astype(np.int32),
                          device=dev)
    R, WREG, NBLK = 2, 4096, 32
    bufs = torch.as_tensor(rng.uniform(-3e4, 3e4, (3, R * WREG))
                           .astype(np.float32).round(), device=dev)
    starts = torch.zeros(3, R, NBLK, dtype=torch.int32, device=dev)
    offs = torch.tensor([[0, 900]] * 3, dtype=torch.int32, device=dev)
    live = torch.tensor([[1200, 700]] * 3, dtype=torch.int32, device=dev)
    with torch.cuda.device(0):
        assert torch.equal(pitch.pitch_corr(seg, ana)[0],
                           pitch.pitch_corr_plain(seg, ana)[0])
        assert torch.equal(
            compact.compact(bufs, starts, starts, starts, WREG),
            compact.compact_plain(bufs, starts, starts, starts, WREG))
        assert torch.equal(
            assemble.assemble(bufs, offs, live, WREG, 4096),
            assemble.assemble_plain(bufs, offs, live, WREG, 4096))
        torch.cuda.synchronize(dev)
