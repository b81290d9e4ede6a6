"""The compiled batch core: CUDA graphs per batch signature, replayed.

Counterpart of the JAX package's compiled programs:
`_compiled_batch_core` (ctts_tpu/parallel/batch.py:36-146) builds one
program per (bucket dims, batch size) that covers the vmapped core, the
packed valid prefix and the wire encode, keeps it in an lru_cache of 64,
and every later batch of that signature replays it; `build_core`'s cache
and `_compiled_core` (ctts_tpu/synth/device.py:648, 1655) do the same
for one sentence; `release_compiled` (ctts_tpu/parallel/batch.py:
179-199) drops them.

Here the program is three CUDA graphs, one per stage of SynthesisCore
(synth/device.py makes what each stage launches depend on nothing but
the signature): the prologue, one refine trip, and the epilogue with
the pack and the wire encode (one pack_encode launch). A batch replays the prologue,
the trip graph once per trip of its refine depth (read from the host
arrays before staging; the counterpart of the while_loop of ctts_tpu/
synth/device.py:1186-1214, whose trip count XLA reads on the device),
then the epilogue. The signature is the core's voice and device, the
bucket dims, the layout of the staged arrays (which fixes the batch size
and the shared-table lengths), the wire flag and how the batch's fades
run (plan_arrays.fade_passes, read from the host arrays like the trip
count: where a configuration's fades reach back past their regions,
the epilogue holds more passes of its fade and silence-table stages)
and the silence tables' width (dops.NBLK = 32 for every batch; wider
only where run_wide runs a batch's overflowing rows again).
  - inputs: the graphs read one static device byte buffer; a batch's
    arrays are packed into one pinned host buffer and reach it in one
    copy (Staging.upload);
  - when: a signature's first batch runs the same stages eagerly, which
    also makes the lazy LUT and Hann uploads (ops/luts.py) and the
    kernel library's build and module loads happen outside capture; its
    second batch captures the graphs (on a capture stream of the device,
    in thread-local mode, so the serving drain thread keeps running)
    and replays them, as does every later one. A batch whose signature
    never comes back costs no capture;
  - memory: one pool per device, shared by every graph captured there.
    Replays on a device are serialized on its current stream, a
    signature's three replays run back to back, and each replay's
    outputs are copied out of the pool at once; so the stage state
    (written by the prologue, read by the trips and the epilogue) is
    dropped after capture, and any later capture of the pool may reuse
    its memory and that of every graph's temporaries;
  - cache: an LRU of MAX_GRAPHS captured signatures (and one of the
    signatures seen once); release_compiled() drops every graph and its
    pool;
  - launch counts: a capture launches nothing, so the kernel wrappers'
    counts made while capturing are taken back, and each replay adds
    what its graphs recorded (ops/hopper.recorded_launches); chip_smoke.py
    holds these counts to the kernels of a profiler trace;
  - the serving loop's stretch buckets: the WSOLA frame chain's decide
    is a chain of ~900 dependent frames, whose latency one launch pays
    whatever its rows. So where the serving loop passes a Pending, a
    stretching signature (a signature of its own: `split`) captures its
    epilogue as two graphs around the decide, stretch_head and
    stretch_tail, with a Handoff of static tensors outside the pool
    between them; the replay stops after the first, and Pending.flush
    makes the decisions of every such bucket of the batch in one
    decide_table launch a device, then replays each bucket's second
    graph and copies its outputs out. The signature's first batch,
    run_wide and the one-sentence path keep the whole epilogue graph
    and its own decide.
A failed capture or replay raises: nothing falls back to the eager
path after a capture on a CUDA device. On the CPU (asked for
explicitly, as the tests do) run_batch stages the inputs and runs the
same stages eagerly (run_eager; with a Pending, a stretching bucket's
two halves around the batch's decide_table, EagerSplit).

The one-sentence path (execute_plan_torch) runs here too, as a batch
of one row without the codec on its voice's one core (the counterpart
of _compiled_core): a sentence whose signature comes back replays, and
the CLI's one synth in a fresh process is a first sighting, so it runs
eagerly and pays no capture.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import Counter, OrderedDict
from typing import NamedTuple, Optional

import numpy as np
import torch

from ctts_tpu_torch.ops import hopper
from ctts_tpu_torch.ops.device_ops import NBLK
from ctts_tpu_torch.ops.hopper import wsola
from ctts_tpu_torch.ops.hopper.pack_encode import (  # noqa: F401 (re-exported)
    pack_encode,
    pack_rows,
)
from ctts_tpu_torch.ops.wsola import (
    energy_table,
    finish,
    max_steps_for,
    run_counts,
)
from ctts_tpu_torch.synth.device import (
    Staging,
    SynthesisCore,
    check_zone_capacity,
    refine_depth,
)
from ctts_tpu_torch.synth.plan_arrays import PlanDims, fade_passes, seg_width
from ctts_tpu_torch.utils import timing

MAX_GRAPHS = 64   # the lru_cache size of _compiled_batch_core
MAX_SEEN = 4 * MAX_GRAPHS


def _pack_encode(out, out_lens, ovf, wire: bool):
    """The packed valid prefixes and, with the codec, their wire encode
    (the tail of JAX's `run`, ctts_tpu/parallel/batch.py:75-100): one
    pack_encode (ops/hopper/pack_encode.py): (payload, classes or None,
    out_lens, ovf)."""
    payload, classes = pack_encode(out, out_lens, wire)
    return payload, classes, out_lens, ovf


def batch_epilogue(core: SynthesisCore, dims: PlanDims, st: dict,
                   wire: bool, fades: int = 0, nblk: int = NBLK):
    """What the epilogue graph covers: the core's epilogue, pack and
    encode."""
    return _pack_encode(*core.epilogue(dims, st, fades, nblk), wire)


class Handoff(NamedTuple):
    """What a split stretch epilogue hands from its first graph, over
    the batch's decide launch, to its second: the frame chain's inputs
    (inp, sq [B, SMAX] f32, input_count, nrun [B] i32), its chosen
    positions (pos [B, max_steps] i32, which the decide writes) and the
    silence tables' overflow counts (ovf [B] i32). Static tensors,
    allocated outside the graphs' pool: a later replay of any graph of
    the pool may write over memory that a capture handed out."""

    inp: torch.Tensor
    sq: torch.Tensor
    input_count: torch.Tensor
    nrun: torch.Tensor
    pos: torch.Tensor
    ovf: torch.Tensor

    @classmethod
    def empty(cls, dims: PlanDims, rows: int, device) -> "Handoff":
        S = dims.SMAX
        steps = max_steps_for(S, dims.OMAX, dims.synth_hop)

        def new(*shape, dtype=torch.int32):
            return torch.empty(shape, dtype=dtype, device=device)
        return cls(new(rows, S, dtype=torch.float32),
                   new(rows, S, dtype=torch.float32), new(rows), new(rows),
                   new(rows, steps), new(rows))

    def segment(self) -> wsola.Segment:
        return wsola.Segment(self.inp, self.sq, self.input_count,
                             self.nrun, self.pos)


def stretch_head(core: SynthesisCore, dims: PlanDims, st: dict,
                 hand: Handoff, fades: int = 0, nblk: int = NBLK) -> None:
    """A split stretch epilogue's first half: the core's epilogue up to
    the frame chain's inputs, written to `hand` (what time_stretch
    computes before its frame chain, on the same values)."""
    out, out_len, ovf = core.assembled(dims, st, fades, nblk)
    hand.inp.copy_(out)
    hand.input_count.copy_(out_len)
    hand.nrun.copy_(run_counts(hand.input_count, dims.SMAX, dims.OMAX,
                               dims.synth_hop))
    energy_table(hand.inp, out=hand.sq)
    hand.ovf.copy_(ovf)


def stretch_tail(dims: PlanDims, hand: Handoff, speed: torch.Tensor,
                 wire: bool):
    """Its second half, once a decide has written hand.pos: the
    overlap-add, finish, the int16 cast, pack and encode (what
    batch_epilogue computes after the frame chain's decisions)."""
    acc, norm = wsola.emit(hand.inp, hand.pos, hand.nrun, dims.synth_hop,
                           dims.OMAX)
    out, out_len = finish(acc, norm, hand.inp, hand.input_count, hand.nrun,
                          speed, dims.OMAX, dims.synth_hop)
    return _pack_encode(out.to(torch.int16), out_len.to(torch.int32),
                        hand.ovf, wire)


def batch_core(core: SynthesisCore, dims: PlanDims, ar: dict, trips: int,
               wire: bool, fades: int = 0, nblk: int = NBLK):
    """What a signature's graphs cover, op by op: the core, pack and
    encode (`fades`: plan_arrays.fade_passes of the batch; `nblk`: the
    silence tables' width)."""
    return _pack_encode(*core(dims, ar, trips, fades, nblk), wire)


def _inputs(dims: PlanDims, arrays: dict, shared: dict) -> dict:
    merged = dict(arrays)
    merged.update(shared)
    check_zone_capacity(dims, merged)
    return merged


def run_eager(core: SynthesisCore, dims: PlanDims, arrays: dict,
              shared: dict, wire: bool, nblk: int = NBLK,
              pending: Optional["Pending"] = None):
    """batch_core on freshly staged inputs, op by op (the CPU path, a
    signature's first batch, and the reference a graph's output is held
    to). `pending` is not used: every bucket's frame chain runs in its
    own epilogue, as run_batch's callers without one have it."""
    merged = _inputs(dims, arrays, shared)
    ar = Staging(merged).upload(merged, core.bank.device)
    return batch_core(core, dims, ar, refine_depth(merged), wire,
                      fade_passes(dims, merged), nblk)


class Signature(NamedTuple):
    core: int            # the SynthesisCore's token (its voice tensors)
    device: str
    dims: PlanDims
    layout: tuple        # Staging.key(): names, dtypes and shapes
    wire: bool
    fades: int           # plan_arrays.fade_passes: how the fades run
    nblk: int            # the silence tables' width
    split: bool = False  # a stretch epilogue split at its decide (Pending)


class CapturedCore:
    """One signature's graphs (prologue, refine trip, epilogue), their
    static input buffer and outputs, and the kernel launches each
    recorded. A split signature's epilogue is two graphs: `epilogue`
    (stretch_head) and `tail` (stretch_tail), with their Handoff."""

    def __init__(self, core: SynthesisCore, sig: Signature, layout: Staging):
        dev = core.bank.device
        self.core = core              # the graphs read its voice tensors
        self.layout = layout
        self.static_in = torch.empty(layout.nbytes, dtype=torch.uint8,
                                     device=dev)
        ar = layout.views(self.static_in)
        dims = sig.dims
        t0 = time.perf_counter()
        torch.cuda.synchronize(dev)
        self.prologue, pro, st = _capture(
            dev, lambda: core.prologue(dims, ar))
        self.trip, self.trip_launches, _ = _capture(
            dev, lambda: core.refine_trip(dims, st))
        self.hand = self.tail = None
        tail = {}
        if sig.split:
            self.hand = Handoff.empty(dims, ar["speed"].shape[0], dev)
            self.epilogue, epi, _ = _capture(
                dev, lambda: stretch_head(core, dims, st, self.hand,
                                          sig.fades, sig.nblk))
            self.tail, tail, self.outputs = _capture(
                dev, lambda: stretch_tail(dims, self.hand, ar["speed"],
                                          sig.wire))
        else:
            self.epilogue, epi, self.outputs = _capture(
                dev, lambda: batch_epilogue(core, dims, st, sig.wire,
                                            sig.fades, sig.nblk))
        # The stage state lives from the prologue's replay to the
        # epilogue's, which nothing else interleaves with: once no tensor
        # holds it, later captures may reuse its memory.
        del st
        self.launches = Counter(pro) + Counter(epi) + Counter(tail)
        self.capture_s = time.perf_counter() - t0

    def start(self, merged: dict, trips: int) -> None:
        """Stage the batch and replay the prologue, `trips` refine trips
        and the epilogue (a split signature's first half)."""
        self.layout.upload(merged, self.static_in.device, self.static_in)
        self.prologue.replay()
        for _ in range(trips):
            self.trip.replay()
        self.epilogue.replay()
        hopper.add_launches(self.launches)
        for _ in range(trips):
            hopper.add_launches(self.trip_launches)

    def replay(self, merged: dict, trips: int):
        """start() and a copy of the outputs out of the pool (on the
        device's current stream, before any later replay)."""
        self.start(merged, trips)
        return self._copy_out()

    def finish(self):
        """A split signature's second half, once the decide has written
        the handoff's positions: the tail's replay and a copy of its
        outputs."""
        with torch.cuda.device(self.static_in.device):
            self.tail.replay()
            return self._copy_out()

    def _copy_out(self):
        return tuple(None if t is None else t.clone() for t in self.outputs)


class EagerSplit:
    """A split stretch bucket op by op (the CPU): the core up to the
    decide's inputs at once, stretch_tail at finish()."""

    def __init__(self, core: SynthesisCore, sig: Signature, layout: Staging,
                 merged: dict, trips: int):
        dims = sig.dims
        ar = layout.upload(merged, core.bank.device)
        st = core.prologue(dims, ar)
        for _ in range(trips):
            core.refine_trip(dims, st)
        self.hand = Handoff.empty(dims, ar["speed"].shape[0],
                                  core.bank.device)
        stretch_head(core, dims, st, self.hand, sig.fades, sig.nblk)
        self._tail = (dims, self.hand, ar["speed"], sig.wire)

    def finish(self):
        return stretch_tail(*self._tail)


class Deferred:
    """A split stretch bucket's outputs (payload, classes or None,
    out_lens, ovf), set by Pending.flush."""

    __slots__ = ("out",)

    def __init__(self):
        self.out = None


def resolved(result):
    """run_batch's result: the outputs, or a Deferred's once flushed."""
    return result.out if isinstance(result, Deferred) else result


class Pending:
    """The split stretch buckets of one enqueue (BatchSynthesizer's
    _enqueue) whose epilogue stopped before the frame chain's decide.
    flush() makes all their decisions in one decide_table launch a
    device (ops/hopper/wsola.py: the chains side by side, so the batch
    pays the chain's latency once), then runs each bucket's tail. A
    signature has one handoff and one staging buffer, so admit() flushes
    first where the signature is already waiting (two shards on one
    device share a signature)."""

    def __init__(self):
        self._waiting: list = []     # (signature, entry, Deferred)

    def admit(self, sig: Signature) -> None:
        if any(s == sig for s, _, _ in self._waiting):
            self.flush()

    def add(self, sig: Signature, entry) -> Deferred:
        out = Deferred()
        self._waiting.append((sig, entry, out))
        return out

    def flush(self) -> None:
        waiting, self._waiting = self._waiting, []
        per_device: dict = {}
        for _, entry, _ in waiting:
            per_device.setdefault(entry.hand.pos.device, []).append(
                entry.hand.segment())
        for segments in per_device.values():
            wsola.decide_table(segments)
        for _, entry, out in waiting:
            out.out = entry.finish()


def _capture(dev: torch.device, fn):
    """(graph, kernel launches it recorded, fn's result captured). What
    torch.cuda.graph does, less its empty_cache of the device and of the
    pinned host memory on every capture: the serving path allocates from
    both again right after, and a signature captures three graphs."""
    graph = torch.cuda.CUDAGraph()
    with hopper.recorded_launches() as launches, \
            torch.cuda.stream(_capture_stream(dev)):
        graph.capture_begin(_pool(dev), capture_error_mode="thread_local")
        try:
            out = fn()
        finally:
            graph.capture_end()
    return graph, launches, out


_lock = threading.Lock()
_graphs: "OrderedDict[Signature, CapturedCore]" = OrderedDict()
_seen: "OrderedDict[Signature, None]" = OrderedDict()
_pools: dict = {}
_streams: dict = {}
_tokens = itertools.count()
# Batches run on a card: "eager" (a signature's first), "capture" (its
# second, captured and replayed), "replay" (every later one).
runs: Counter = Counter()


def _pool(device: torch.device):
    if device not in _pools:
        with torch.cuda.device(device):
            _pools[device] = torch.cuda.graph_pool_handle()
    return _pools[device]


def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    if device not in _streams:
        _streams[device] = torch.cuda.Stream(device)
    return _streams[device]


def _token(core: SynthesisCore) -> int:
    tok = getattr(core, "_graph_token", None)
    if tok is None:
        tok = core._graph_token = next(_tokens)
    return tok


def signature(core: SynthesisCore, dims: PlanDims, arrays: dict,
              shared: dict, wire: bool, nblk: int = NBLK,
              split: bool = False):
    """(Signature, staging layout, merged arrays) of one shard's batch."""
    merged = _inputs(dims, arrays, shared)
    layout = Staging(merged)
    sig = Signature(_token(core), str(core.bank.device), dims, layout.key(),
                    bool(wire), fade_passes(dims, merged), nblk, split)
    return sig, layout, merged


def cached(sig: Signature, make):
    """The entry of `sig`: None at the signature's first sighting, made
    by make() at its second, the cached one after (counted in `runs`);
    the least recently used entries past MAX_GRAPHS (and signatures seen
    once past MAX_SEEN) are dropped."""
    with _lock:
        entry = _graphs.get(sig)
        if entry is not None:
            runs["replay"] += 1
        elif sig not in _seen:
            runs["eager"] += 1
            _seen[sig] = None
            while len(_seen) > MAX_SEEN:
                _seen.popitem(last=False)
            return None
        else:
            runs["capture"] += 1
            del _seen[sig]
            entry = _graphs[sig] = make()
            while len(_graphs) > MAX_GRAPHS:
                _graphs.popitem(last=False)
        _graphs.move_to_end(sig)
        return entry


def run_batch(core: SynthesisCore, dims: PlanDims, arrays: dict,
              shared: dict, wire: bool, nblk: int = NBLK,
              pending: Optional[Pending] = None):
    """The compiled batch core: (payload, classes or None, out_lens,
    ovf) of one shard's rows, from its graphs on a CUDA device (eagerly
    at the signature's first batch, captured at its second) or eagerly
    on the CPU. ovf [B] counts each row's regions with more than nblk
    kept segments: such a row's audio is not the reference's, and the
    caller runs it again (run_wide) before it returns it. With a
    `pending` set (the serving loop's) a stretching bucket's epilogue
    is split at the frame chain's decide (a signature of its own): the
    replay (or, on the CPU, the eager run) stops there and returns a
    Deferred that pending.flush() fills. Recorded as the span
    `core.run`."""
    dev = core.bank.device
    split = pending is not None and dims.stretch
    with timing.span("core.run"):
        if dev.type != "cuda" and not split:
            return run_eager(core, dims, arrays, shared, wire, nblk)
        sig, layout, merged = signature(core, dims, arrays, shared, wire,
                                        nblk, split)
        trips = refine_depth(merged)
        if dev.type != "cuda":
            pending.admit(sig)
            return pending.add(sig, EagerSplit(core, sig, layout, merged,
                                               trips))
        with torch.cuda.device(dev):
            # A capture synchronizes the device first, so no replay of a
            # graph it evicts is still running.
            entry = cached(sig, lambda: CapturedCore(core, sig, layout))
            if entry is None:
                return batch_core(core, dims, layout.upload(merged, dev),
                                  trips, wire, sig.fades, nblk)
            if not split:
                return entry.replay(merged, trips)
            pending.admit(sig)
            entry.start(merged, trips)
            return pending.add(sig, entry)


# Rows run again by run_wide, per silence-table width.
widened: Counter = Counter()


def run_wide(run, core: SynthesisCore, dims: PlanDims, arrays: dict,
             shared: dict, n: int) -> list:
    """The int16 outputs of the first n rows of a batch whose silence
    tables overflowed at NBLK, run again through `run` (run_batch, or
    run_eager) without the codec, with tables of plan_arrays.seg_width
    of these rows: wide enough for every kept segment they can hold, so
    a row that still overflows is a fault and raises. The wider tables
    make a signature of their own; the default path never reaches it."""
    nblk = seg_width(dims, arrays)
    payload, _, lens, ovf = run(core, dims, arrays, shared, False,
                                nblk=nblk)
    B = lens.shape[0]
    small = torch.cat([lens, ovf]).cpu().numpy()
    if small[B:B + n].any():
        raise RuntimeError(
            f"silence tables of {nblk} slots overflowed in "
            f"{int(small[B:B + n].sum())} region(s), past the bound of "
            "plan_arrays.kept_segments_bound")
    with _lock:
        widened[nblk] += n
    ends = np.cumsum(small[:n].astype(np.int64))
    host = payload[:int(ends[-1])].cpu().numpy()
    return np.split(host, ends[:-1])


def signatures() -> list:
    """The captured signatures, least recently used first."""
    with _lock:
        return list(_graphs)


def captured(sig: Signature) -> Optional[CapturedCore]:
    with _lock:
        return _graphs.get(sig)


def release_compiled(core: Optional[SynthesisCore] = None) -> None:
    """Drop every captured graph and seen signature (or those of one
    core) and, when no graph is left, the pools and capture streams,
    returning their memory to the device."""
    with _lock:
        for dev in _pools:
            torch.cuda.synchronize(dev)
        tok = None if core is None else getattr(core, "_graph_token", -1)
        for table in (_graphs, _seen):
            for sig in [s for s in table if tok is None or s.core == tok]:
                del table[sig]
        if not _graphs:
            _pools.clear()
            _streams.clear()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
