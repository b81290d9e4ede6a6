"""Batched serving: the production path, on one device or split over a
device mesh.

Counterpart of ctts_tpu/parallel/batch.py. Texts are lowered on the host
(natively through libctts.so, or by the Python plan pipeline), grouped
into buckets of identical PlanDims, stacked, and run through
SynthesisCore as one batch per bucket. Each batch's valid prefixes are
packed into one flat int16 buffer on the device, so the host copy is
sum(out_len) samples. With the wire codec (ops/wire.py; on by default on
a CUDA device, as the JAX package turns it on on every accelerator) the
packed samples are encoded on the device (on a card one pack_encode
launch writes the words straight from the rows) and the host copies the
valid word prefix; on the drain thread one native pass a batch
(ops/wire_rows.py) decodes every shard's words straight into the rows'
own arrays; the samples are the same bit for bit. Without the codec the
same pass copies every shard's rows out of its packed samples.

Every speed is served (WSOLA for speed != 1.0, with OMAX-wide rows).

With a mesh (parallel/mesh.py) a bucket's rows are split over its
devices: what the JAX package's shard_map branch computes
(ctts_tpu/parallel/batch.py:102-143, 254-258, 519-523, 591-611,
652-668, 692-751), not how XLA computed it. The batch size rounds up to
lcm(8, mesh size); after the length sort and the pad rows, shard d takes
the slots [d * rows_per, (d + 1) * rows_per) and runs on mesh.devices[d]
with that device's replica of the voice, its SynthesisCore and its copy
stream: the core, the pack and, with the codec, an encode of its own
(the codec is block-local). The batch-global value tables
(shared_plan_values) are computed once over the whole bucket and given
to every shard unchanged, as JAX replicates them. The trim makes one
small copy per shard (lengths, silence-table overflow counts, wire
classes); the drain walks the shards in order and stops at the n real
rows, so a shard of pad rows only is never copied.

Silence tables hold 32 kept segments a region (dops.NBLK). A real row
with a region of more runs again in the trim, with the other such rows
of its bucket, on the first shard, without the codec and at tables wide
enough for them (compiled.run_wide, plan_arrays.seg_width); the drain
puts those outputs in the rows' places after it decodes the shards.
The default configuration never overflows (tests/test_torch_config.py),
so its batches never take that path. The shards are enqueued one after
another from the calling thread, and the forward path calls no
collective. Without a mesh the batch is one shard on one device, which
is the unsplit path: the same calls as before the split existed.

Each shard runs the compiled batch core of synth/compiled.py, the
counterpart of `_compiled_batch_core` (ctts_tpu/parallel/batch.py:
36-146): on a CUDA device CUDA graphs per signature (bucket dims, rows
per shard, shared-table lengths, wire flag), the signature's first
batch run eagerly, its second captured, and every later one replayed,
the outputs copied out of the graphs' memory right after the replay, so
that the next batch's replay cannot overwrite a payload the copy stream
is still reading; on the CPU the same core eagerly. Shards on one device share its core and so its
graphs. A stretching bucket (speed != 1.0) stops before its WSOLA frame
chain's decide; once the batch's buckets are enqueued, one decide launch
a device makes the decisions of all of them and each bucket finishes
(compiled.Pending), so the batch pays the chain's latency once. `release_compiled` (synth/compiled.py) drops the graphs, as the
JAX module's drops its executables; its `_no_persistent_cache` works
around an XLA:CPU crash and has no counterpart.
"""

from __future__ import annotations

import itertools
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ctts_tpu_torch.config import CTTSConfig
from ctts_tpu_torch.db.reader import VoiceDatabase
from ctts_tpu_torch.ops import wire as wire_codec
from ctts_tpu_torch.ops import wire_rows
from ctts_tpu_torch.parallel.mesh import first_device
from ctts_tpu_torch.plan.compiler import compile_plan
from ctts_tpu_torch.plan.split import split_plan
from ctts_tpu_torch.synth import compiled
from ctts_tpu_torch.synth.compiled import (  # noqa: F401 (re-exported)
    pack_rows,
    release_compiled,
)
from ctts_tpu_torch.synth.device import DeviceVoice, SynthesisCore
from ctts_tpu_torch.synth.plan_arrays import (
    PlanDims,
    bucket_dims,
    check_config,
    derive_dims,
    fill_device_plan,
    shared_plan_values,
    split_keeps_fades,
    walk_plan,
)
from ctts_tpu_torch.text.rules import NormalizationRules
from ctts_tpu_torch.utils import timing


def _next_batch_size(n: int, multiple: int) -> int:
    """Round up to a multiple of 8 (and of `multiple`);
    ctts_tpu/parallel/batch.py:202."""
    g = int(8 * multiple // np.gcd(8, multiple))
    return max(-(-n // g) * g, g)


def on_device(device: torch.device):
    """Make a CUDA `device` current for the enclosed calls (nothing for
    the CPU)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return nullcontext()


class Shard(NamedTuple):
    """Where one block of a batch's rows runs: the device, the core over
    that device's voice replica, and the side stream of its host copies
    (None on the CPU). Shards on one device share its core and stream."""

    device: torch.device
    core: SynthesisCore
    copy_stream: Optional[torch.cuda.Stream]


class Enqueued(NamedTuple):
    """One bucket's batch on its way: n real rows, `rows` slots a shard,
    each shard's (payload, classes or None, out_lens, ovf), and the
    bucket's dims and stacked host arrays (in slot order), from which
    overflowing rows run again."""

    n: int
    rows: int
    shards: list
    dims: PlanDims
    arrays: dict


class BatchSynthesizer:
    """High-throughput batched synthesis on one device, or with its rows
    split over a device mesh."""

    # Runs one shard's rows: the compiled batch core (a CUDA graph per
    # signature on a card).
    _run_core = staticmethod(compiled.run_batch)

    def __init__(
        self,
        db: VoiceDatabase,
        config: CTTSConfig,
        rules: Optional[NormalizationRules] = None,
        mesh=None,
        target_rms: float = 3000.0,
        dims_floor: Optional[dict] = None,
        wire: Optional[bool] = None,
        native_plans: bool = True,
        device: Optional[torch.device] = None,
    ):
        check_config(config)
        device = first_device(mesh, device)
        self.db = db
        self.config = config
        self.rules = rules
        self.mesh = mesh
        self.dims_floor = dims_floor
        self.voice = DeviceVoice(db, target_rms, device)
        self.device = self.voice.device
        # The wire codec is on where the JAX package turns it on (every
        # accelerator: ctts_tpu/parallel/batch.py:246-252), here a CUDA
        # device; off on the CPU.
        self.wire = (self.device.type == "cuda" if wire is None
                     else bool(wire))
        # One voice replica, core and copy stream per distinct device
        # (the replicated voice of ctts_tpu/parallel/batch.py:254-258).
        devices = mesh.devices if mesh is not None else (self.device,)
        per_device = {}
        for dev in devices:
            if dev not in per_device:
                voice = (self.voice if dev == self.device
                         else self.voice.replica(dev))
                per_device[dev] = Shard(
                    dev, voice.core(),
                    torch.cuda.Stream(dev) if dev.type == "cuda" else None)
        self.shards = [per_device[dev] for dev in devices]
        # Request ids of the spans (utils/timing.py): one a batch.
        self._requests = itertools.count()
        self._nl = None
        if native_plans:
            from ctts_tpu_torch.plan.native_lower import NativeLowerer

            self._nl = NativeLowerer(db.path, config, rules)

    # -- plan side ---------------------------------------------------------

    def compile_plans(self, texts: Sequence[str], speed: float = 1.0):
        return [compile_plan(self.db, t, self.config, self.rules, speed)
                for t in texts]

    # -- execution ---------------------------------------------------------

    def synthesize(self, texts: Sequence[str], speed: float = 1.0,
                   split: bool = True):
        """Synthesize a batch; returns a list of int16 arrays in input
        order. Long inputs split at sentence boundaries into rows of the
        same bucket (plan/split.py) and are concatenated back, where the
        configuration's fades stay inside the rows
        (plan_arrays.split_keeps_fades)."""
        req = next(self._requests)
        with timing.span("batch.lower", req):
            prepared, spans = self._lower_batch(texts, speed, split)
        with timing.span("batch.enqueue", req):
            handles = self._enqueue(prepared)
        with timing.span("batch.trim", req):
            trimmed = self._trim(handles)
        return self._drain_batch(req, trimmed, spans)

    def execute(self, plans):
        """Synthesize compiled plans (compile_plans), one row each and
        none split; returns a list of int16 arrays in plan order
        (ctts_tpu/parallel/batch.py:360-361)."""
        prepared = self._prepare(list(plans))
        return self._drain(self._trim(self._enqueue(prepared)))

    def stream(self, text_batches, speed: float = 1.0, split: bool = True):
        """Pipelined synthesis over an iterable of text batches
        (ctts_tpu/parallel/batch.py:363). Per batch N+1:
          1. lower it on the host while batch N runs on the device;
          2. trim batch N: sync its out_lens and start the copy of its
             packed prefix on a side stream;
          3. enqueue batch N+1;
          4. hand batch N's drain to a one-worker thread (`ctts-drain`).
        Yields one list of int16 arrays per input batch, in order. Each
        step is a span of its batch's request (utils/timing.py), and the
        wait for a drain is `stream.wait_drain`."""
        prev = None      # (enqueued-but-untrimmed batch N, spans, req)
        pending = None   # (drain future of batch N-1, req)
        pool = ThreadPoolExecutor(max_workers=1,
                                  thread_name_prefix="ctts-drain")
        try:
            for texts in text_batches:
                req = next(self._requests)
                with timing.span("batch.lower", req):
                    prepped, spans = self._lower_batch(texts, speed, split)
                if prev is not None:
                    with timing.span("batch.trim", prev[2]):
                        trimmed = self._trim(prev[0])
                with timing.span("batch.enqueue", req):
                    handles = self._enqueue(prepped)
                if prev is not None:
                    fut = pool.submit(self._drain_batch, prev[2], trimmed,
                                      prev[1])
                    if pending is not None:
                        yield _wait_drain(*pending)
                    pending = (fut, prev[2])
                prev = (handles, spans, req)
            if prev is not None:
                with timing.span("batch.trim", prev[2]):
                    trimmed = self._trim(prev[0])
                if pending is not None:
                    yield _wait_drain(*pending)
                yield self._drain_batch(prev[2], trimmed, prev[1])
            elif pending is not None:
                yield _wait_drain(*pending)
        finally:
            pool.shutdown(wait=True)

    def _drain_batch(self, req, trimmed, spans):
        """_finish as the span `batch.drain` of request `req`."""
        with timing.span("batch.drain", req):
            return self._finish(trimmed, spans)

    def _finish(self, trimmed, spans):
        """The batch's outputs, one a text of `spans` (see _drain)."""
        return self._drain(trimmed, spans)

    # -- host lowering -------------------------------------------------------

    def _lower_batch(self, texts, speed: float, split: bool):
        """(prepared, spans): rows lowered and stacked per bucket, and the
        [start, end) row range of every input text."""
        split = split and split_keeps_fades(self.config)
        if self._nl is not None:
            return self._prepare_native(texts, speed, split)
        plans = self.compile_plans(texts, speed)
        if split:
            rows, spans = [], []
            for p in plans:
                r = split_plan(p, self.db)
                spans.append((len(rows), len(rows) + len(r)))
                rows.extend(r)
        else:
            rows = plans
            spans = [(i, i + 1) for i in range(len(plans))]
        return self._prepare(rows), spans

    def _prepare_native(self, texts, speed: float, split: bool):
        """Native twin of compile + split + _prepare
        (ctts_tpu/parallel/batch.py:326): rows are lowered by libctts.so,
        and each bucket's are filled, ordered and padded straight into
        its stacked arrays by one native call (NativeLowerer.fill_bucket,
        the span `lower.fill`)."""
        nl = self._nl
        spans, dims_list, trips = nl.lower(texts, speed, split)
        buckets = defaultdict(list)
        for i, d in enumerate(dims_list):
            buckets[bucket_dims(d, self.dims_floor)].append(i)
        trips = np.array(trips, np.int32)
        per_bucket = []
        with timing.span("lower.fill"):
            for bd, idxs in buckets.items():
                n = len(idxs)
                stacked, idxs = nl.fill_bucket(
                    idxs, bd, _next_batch_size(n, len(self.shards)), trips,
                    self.config.silence_threshold, speed)
                timing.count("fill.rows", n)
                timing.count("fill.native", n)
                shared = shared_plan_values(stacked, self.voice.lengths_np,
                                            bd)
                per_bucket.append((bd, idxs, (n, stacked, shared)))
        return (len(dims_list), per_bucket), spans

    def _prepare(self, plans):
        """Python lowering (ctts_tpu/parallel/batch.py:429): walk plans,
        bucket, stack the filled arrays."""
        walked = [walk_plan(p, self.db) for p in plans]
        buckets = defaultdict(list)
        for i, w in enumerate(walked):
            bd = bucket_dims(derive_dims(w, self.db), self.dims_floor)
            buckets[bd].append(i)
        per_bucket = []
        for bd, idxs in buckets.items():
            n = len(idxs)
            bsz = _next_batch_size(n, len(self.shards))
            stacked = None
            for slot, i in enumerate(idxs):
                arrays = fill_device_plan(walked[i], self.db, bd).arrays
                if stacked is None:
                    stacked = {k: np.zeros((bsz,) + np.shape(v),
                                           np.asarray(v).dtype)
                               for k, v in arrays.items()}
                for k, v in arrays.items():
                    stacked[k][slot] = v
            timing.count("fill.rows", n)
            idxs = self._order_and_pad(stacked, n, idxs)
            shared = shared_plan_values(stacked, self.voice.lengths_np, bd)
            per_bucket.append((bd, idxs, (n, stacked, shared)))
        return len(plans), per_bucket

    def _order_and_pad(self, stacked: dict, n: int, idxs: list) -> list:
        """Sort the n real rows by descending length and make the pad
        rows copies of the last one; returns the row ids in slot order."""
        order = self._length_order(stacked, n)
        for k in stacked:
            stacked[k][:n] = stacked[k][order]
            stacked[k][n:] = stacked[k][n - 1]
        return [idxs[int(p)] for p in order]

    @staticmethod
    def _length_order(stacked, n):
        """Descending per-row output-length order (stable);
        ctts_tpu/parallel/batch.py:471. Slot renumbering only: rows are
        independent and map back by id, so bits are unchanged."""
        key = (stacked["region_len"][:n].sum(axis=1)
               + stacked["region_pause"][:n].sum(axis=1))
        return np.argsort(-key, kind="stable")

    # -- device side ---------------------------------------------------------

    def _enqueue(self, prepared):
        """Enqueue every bucket. A stretching bucket's run stops before
        its frame chain's decide (compiled.Pending); once every bucket
        is enqueued, one decide launch a device makes the decisions of
        all of them, and each finishes (the chains run side by side, so
        the batch pays one chain's latency, not one a bucket)."""
        n_rows, per_bucket = prepared
        pending = compiled.Pending()
        handles = [(idxs, self._enqueue_bucket(bd, prep, pending))
                   for bd, idxs, prep in per_bucket]
        pending.flush()
        return n_rows, [
            (idxs, h._replace(shards=[compiled.resolved(s)
                                      for s in h.shards]))
            for idxs, h in handles]

    def _enqueue_bucket(self, dims: PlanDims, prep,
                        pending: "compiled.Pending") -> Enqueued:
        """Enqueue each shard's block of slots on its device, in mesh
        order."""
        n, stacked, shared = prep
        rows = stacked["speed"].shape[0] // len(self.shards)
        timing.count("buckets")
        timing.count("rows.real", n)
        timing.count("rows.pad", rows * len(self.shards) - n)
        shards, batched = [], 0
        for d, shard in enumerate(self.shards):
            arrays = {k: v[d * rows:(d + 1) * rows]
                      for k, v in stacked.items()}
            # The core over the shard's rows, the pack and, with the
            # codec, the encode, all on the shard's device: (payload,
            # classes or None, out_lens, ovf), or a Deferred of them.
            with on_device(shard.device):
                out = self._run_core(shard.core, dims, arrays, shared,
                                     self.wire, pending=pending)
            if isinstance(out, compiled.Deferred):
                batched += max(min(n - d * rows, rows), 0)
            shards.append(out)
        if dims.stretch:
            timing.count("stretch.rows", n)
            timing.count("stretch.batched", batched)
        return Enqueued(n, rows, shards, dims, stacked)

    def _trim(self, enqueued):
        n_rows, per_bucket = enqueued
        return n_rows, [(idxs, self._trim_bucket(handle))
                        for idxs, handle in per_bucket]

    def _trim_bucket(self, handle: Enqueued):
        """Per shard, sync the row lengths, the overflow counts and, with
        the wire codec, the block classes in one small copy; then start
        copying the valid prefix of the shard's packed buffer (or of its
        wire words) to pinned host memory on the shard's copy stream, so
        that the copy runs beside the next batch's compute. On a card the
        payload is the copy that the replay made of its graph's output,
        not the output itself, so the next batch's replay of the same
        graph cannot overwrite it while it is being read. Shards past the
        n real rows hold pad rows only and are not copied. Then the real
        rows whose silence tables overflowed run again (_widen). Returns
        (per shard with real rows, (host buffer, copy event or None,
        classes or None, row ends); {slot: output} of the rows run
        again)."""
        n, rows, handles = handle.n, handle.rows, handle.shards
        trimmed, over = [], []
        for d, (shard, (payload, classes, out_lens, ovf)) in enumerate(
                zip(self.shards, handles)):
            small = [out_lens, ovf] + ([] if classes is None else [classes])
            with timing.span("trim.sync"):
                small = torch.cat(small).cpu().numpy()
            n_d = min(n - d * rows, rows)
            if n_d <= 0:
                continue
            over += [d * rows + int(i)
                     for i in np.flatnonzero(small[rows:rows + n_d])]
            ends = np.cumsum(small[:n_d].astype(np.int64))
            total = int(ends[-1])
            if classes is not None:
                classes = small[2 * rows:]
                count = wire_codec.wire_valid_words(classes, total)
            else:
                count = total
            timing.count("bytes.d2h", count * payload.element_size())
            trimmed.append((*self._copy_prefix(shard, payload[:count]),
                            classes, ends))
        return trimmed, self._widen(handle, over)

    def _widen(self, handle: Enqueued, slots: list) -> dict:
        """{slot: int16 output} of the bucket's rows at `slots`, run again
        as one batch (padded to a multiple of 8 with copies of the last)
        on the first shard at silence tables wide enough for them
        (compiled.run_wide; it raises where a row still overflows)."""
        if not slots:
            return {}
        pick = slots + slots[-1:] * (_next_batch_size(len(slots), 1)
                                     - len(slots))
        arrays = {k: v[pick] for k, v in handle.arrays.items()}
        shared = shared_plan_values(arrays, self.voice.lengths_np,
                                    handle.dims)
        shard = self.shards[0]
        with on_device(shard.device):
            outs = compiled.run_wide(self._run_core, shard.core, handle.dims,
                                     arrays, shared, len(slots))
        return dict(zip(slots, outs))

    @staticmethod
    def _copy_prefix(shard: Shard, prefix: torch.Tensor):
        """(host copy, event that marks its end): on the CPU a plain copy
        and no event; on a card a pinned buffer filled on the shard's
        copy stream after the work queued on its device's stream."""
        if shard.copy_stream is None:
            return prefix.numpy().copy(), None
        host = torch.empty(prefix.shape[0], dtype=prefix.dtype,
                           pin_memory=True)
        with on_device(shard.device):
            shard.copy_stream.wait_stream(
                torch.cuda.current_stream(shard.device))
            with torch.cuda.stream(shard.copy_stream):
                host.copy_(prefix, non_blocking=True)
            done = torch.cuda.Event()
            done.record(shard.copy_stream)
        prefix.record_stream(shard.copy_stream)
        return host, done

    def _drain(self, trimmed, spans=None):
        """The outputs of `spans`, each text's [start, end) range of row
        ids (None: one a row), in order. Walk each bucket's shards in
        order, mapping slots back to row ids, and wait for each shard's
        copy; then give every text an array of its own, each of its rows
        the range of that array it fills, and write the rows there in
        one native pass a batch (ops/wire_rows.py), with the GIL
        released: with the codec it decodes every wired shard straight
        into them (`drain.decode`); without it, it copies every shard's
        rows out of its host buffer (`drain.raw`). A row that ran again
        takes that run's output (`drain.rows`)."""
        n_rows, per_bucket = trimmed
        lens = [0] * (n_rows + 1)   # row id + 1 -> samples
        native, copied = [], []     # (host, classes, ends, ids); (id, src)
        for idxs, (shards, wide) in per_bucket:
            slot = 0
            for host, done, classes, ends in shards:
                with timing.span("drain.wait_copy"):
                    if done is not None:
                        # A copy that has ended is not waited for: the
                        # wait lets go of the GIL, and taking it back
                        # from a busy calling thread takes up to a
                        # switch interval.
                        if not done.query():
                            done.synchronize()
                        host = host.numpy()
                ids, start = [], 0
                for end in ends.tolist():
                    row = idxs[slot]
                    if slot in wide:
                        copied.append((row, wide[slot]))
                        lens[row + 1] = wide[slot].shape[0]
                        row = n_rows            # address 0: not written
                    else:
                        lens[row + 1] = end - start
                    ids.append(row)
                    start = end
                    slot += 1
                native.append((host, classes, ends, ids))
        if spans is None:
            spans = [(i, i + 1) for i in range(n_rows)]
        offs = np.cumsum(lens)
        first = offs[[s for s, _ in spans]]
        count = [e - s for s, e in spans]
        wired = any(classes is not None for _, classes, _, _ in native)
        with timing.span("drain.decode" if wired else "drain.raw"):
            outs = [np.empty(n, np.int16) for n in
                    (offs[[e for _, e in spans]] - first).tolist()]
            # Each row's address: its text's array, at the row's offset
            # in the text.
            addr = np.zeros(n_rows + 1, np.int64)
            addr[:n_rows] = np.repeat(
                [o.__array_interface__["data"][0] for o in outs],
                count) + 2 * (offs[:n_rows] - np.repeat(first, count))
            if wired:
                n = wire_rows.decode_rows([
                    (host, classes, ends, addr[ids])
                    for host, classes, ends, ids in native])
            else:
                n = wire_rows.copy_rows([(host, ends, addr[ids])
                                         for host, _, ends, ids in native])
        if wired:
            timing.count("decode.samples", n)
            timing.count("decode.vector", 0 if wire_rows.path() == "scalar"
                         else n)
        else:
            timing.count("raw.samples",
                         n + sum(src.shape[0] for _, src in copied))
            timing.count("raw.native", n)
        with timing.span("drain.rows"):
            text = np.repeat(np.arange(len(spans)), count)
            for row, src in copied:
                t = int(text[row])
                at = int(offs[row] - first[t])
                outs[t][at:at + src.shape[0]] = src
        return outs


def _wait_drain(fut, req):
    """The drained batch of future `fut`, waited for as the span
    `stream.wait_drain` of its request."""
    with timing.span("stream.wait_drain", req):
        return fut.result()
