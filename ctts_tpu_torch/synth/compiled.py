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
    holds these counts to the kernels of a profiler trace.
A failed capture or replay raises: nothing falls back to the eager
path after a capture on a CUDA device. On the CPU (asked for
explicitly, as the tests do) run_batch stages the inputs and runs the
same stages eagerly (run_eager).

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
from ctts_tpu_torch.ops.hopper.pack_encode import (  # noqa: F401 (re-exported)
    pack_encode,
    pack_rows,
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
              shared: dict, wire: bool, nblk: int = NBLK):
    """batch_core on freshly staged inputs, op by op (the CPU path, a
    signature's first batch, and the reference a graph's output is held
    to)."""
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


class CapturedCore:
    """One signature's graphs (prologue, refine trip, epilogue), their
    static input buffer and outputs, and the kernel launches each
    recorded."""

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
        self.epilogue, epi, self.outputs = _capture(
            dev, lambda: batch_epilogue(core, dims, st, sig.wire,
                                        sig.fades, sig.nblk))
        # The stage state lives from the prologue's replay to the
        # epilogue's, which nothing else interleaves with: once no tensor
        # holds it, later captures may reuse its memory.
        del st
        self.launches = Counter(pro) + Counter(epi)
        self.capture_s = time.perf_counter() - t0

    def replay(self, merged: dict, trips: int):
        """Stage the batch, replay the prologue, `trips` refine trips and
        the epilogue, and copy the outputs out of the pool (on the
        device's current stream, before any later replay)."""
        self.layout.upload(merged, self.static_in.device, self.static_in)
        self.prologue.replay()
        for _ in range(trips):
            self.trip.replay()
        self.epilogue.replay()
        hopper.add_launches(self.launches)
        for _ in range(trips):
            hopper.add_launches(self.trip_launches)
        return tuple(None if t is None else t.clone() for t in self.outputs)


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
              shared: dict, wire: bool, nblk: int = NBLK):
    """(Signature, staging layout, merged arrays) of one shard's batch."""
    merged = _inputs(dims, arrays, shared)
    layout = Staging(merged)
    sig = Signature(_token(core), str(core.bank.device), dims, layout.key(),
                    bool(wire), fade_passes(dims, merged), nblk)
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
              shared: dict, wire: bool, nblk: int = NBLK):
    """The compiled batch core: (payload, classes or None, out_lens,
    ovf) of one shard's rows, from its graphs on a CUDA device (eagerly
    at the signature's first batch, captured at its second) or eagerly
    on the CPU. ovf [B] counts each row's regions with more than nblk
    kept segments: such a row's audio is not the reference's, and the
    caller runs it again (run_wide) before it returns it. Recorded as
    the span `core.run`."""
    dev = core.bank.device
    with timing.span("core.run"):
        if dev.type != "cuda":
            return run_eager(core, dims, arrays, shared, wire, nblk)
        sig, layout, merged = signature(core, dims, arrays, shared, wire,
                                        nblk)
        trips = refine_depth(merged)
        with torch.cuda.device(dev):
            # A capture synchronizes the device first, so no replay of a
            # graph it evicts is still running.
            entry = cached(sig, lambda: CapturedCore(core, sig, layout))
            if entry is None:
                return batch_core(core, dims, layout.upload(merged, dev),
                                  trips, wire, sig.fades, nblk)
            return entry.replay(merged, trips)


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
