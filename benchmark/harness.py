"""One run of one cell: set-up, warm-up, the measured window, the check.

Everything a cell is made of is found by name: its configuration in
configs/<name>.json, its traffic in traffic/<name>.json (read by the one
generator, generator.py), and each metric's reader in
metrics/<metric>.py, a module with `read(run)` that returns the number
or None where the run holds nothing for it. A traffic file's "loop"
picks one of the two closed loops below:
  - "stream": one BatchSynthesizer.stream fed batch after batch; it
    runs from the warm-up straight into the window, so the pipeline is
    full when the window opens. The warm-up is the traffic file's
    `warm_batches` batches, drawn from a stream of the seed of its own
    (generator.WARM): the same work in every run. A graph signature of
    the window that the warm-up did not meet twice runs eagerly or is
    captured inside the window, as it would in a server: the info line
    counts these runs (runs_in_window);
  - "call": one caller of CTTSEngine.synthesize, text after text. The
    warm-up speaks every distinct text, in passes, until a pass runs
    none eagerly and captures no CUDA graph: every signature the window
    meets is then a replay.
The window's texts are drawn from the seed (generator.WINDOW). A traced
run (--trace 1) wraps the program's host calls (yardstick.timed_method)
and runs torch.profiler from before the window to the end of the drain.
"""

from __future__ import annotations

import importlib.util
import itertools
import json
import os
import sys
import time
from collections import deque

import numpy as np

from benchmark import check as checking
from benchmark import generator, voice
from benchmark.trace import Tracer
from benchmark.yardstick import SAMPLE_RATE, timed_method

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
CACHE = ".benchcache"           # inside the checkout, listed in .gitignore
WARM_PASSES = 8                 # the call loop's warm-up passes, at most
SETTLE = 3                      # yields or calls between profiler start
                                # and the window
FORBIDDEN = ("jax", "jaxlib", "flax", "ctts_tpu")


def load_json(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


class Cell:
    """A workload of BENCHMARK.json with what it names, read from the
    files of its configuration, traffic and metrics."""

    def __init__(self, spec: dict, name: str, bench_dir: str = BENCH_DIR):
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.workload = cells[name]
        self.name = name
        self.bench_dir = bench_dir
        self.config = load_json(os.path.join(
            bench_dir, "configs", self.workload["config"] + ".json"))
        self.traffic_dir = os.path.join(bench_dir, "traffic")
        self.traffic = load_json(os.path.join(
            self.traffic_dir, self.workload["traffic"] + ".json"))
        self.end_to_end = [m for m in spec["end_to_end"] if self._has(m)]
        self.per_layer = [m for m in spec["per_layer"] if self._has(m)]

    def _has(self, metric: dict) -> bool:
        return self.name in metric.get("workloads", [self.name])

    def reader(self, metric: str):
        path = os.path.join(self.bench_dir, "metrics", metric + ".py")
        mod_name = "benchmark_metric_" + metric.replace(".", "_")
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


class Run:
    """What a run records, on the host's perf_counter clock: set-up
    seconds, the window [t_open, t_close], and every batch or call from
    the window's opening to the end of the drain as (start, end, answer
    lengths), start being when the stream pulled the batch or the call
    began. A traced run adds the host spans of the wrapped calls, the
    profiler's window (closed at the first yield or call after t_close,
    t_trace_close) and its DeviceTrace."""

    def __init__(self, kind: str, speed: float, seconds: float, t0: float):
        self.kind = kind
        self.speed = speed
        self.seconds = seconds
        self.t0 = t0            # the process's start
        self.setup_s = None
        self.t_open = self.t_close = self.t_trace_close = None
        self.done: list = []
        self.spans: dict = {}
        self.trace = None
        self.warm_runs: dict = {}
        self.host: dict = {}
        self.runs_in_window: dict = {}

    def in_window(self) -> list:
        return [d for d in self.done if d[1] <= self.t_close]

    def in_trace(self) -> list:
        return [d for d in self.done if d[1] <= self.t_trace_close]

    def span_s(self, name: str) -> list:
        """Seconds of each wrapped call `name` that ended in the traced
        window."""
        return [b - a for a, b in self.spans.get(name, ())
                if self.t_open <= b <= self.t_trace_close]


def answer_lens(outs, n: int) -> np.ndarray:
    """Each of n answers' length in samples, -1 where it did not come as
    one row of int16 samples."""
    lens = np.full(n, -1, np.int64)
    for i, o in enumerate(outs[:n]):
        if isinstance(o, np.ndarray) and o.dtype == np.int16 and o.ndim == 1:
            lens[i] = o.shape[0]
    return lens


class Keep:
    """The answers kept for the check: a reservoir of `slots` items
    (batches or calls) drawn from the seed, every item from the window's
    opening to the end of the drain equally likely, and a few answers of
    the longest text besides."""

    def __init__(self, seed: int, slots: int):
        self.rng = generator.rng(seed, generator.KEEP)
        self.slots = max(slots, 1)
        self.items: list = []
        self.seen = 0
        self.longest: list = []

    def offer(self, texts, outs):
        if self.seen < self.slots:
            self.items.append((texts, outs))
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.slots:
                self.items[j] = (texts, outs)
        self.seen += 1

    def answers(self) -> list:
        got = [(t, o) for texts, outs in self.items
               for t, o in zip(texts, outs)]
        return got + self.longest


def _runs(compiled) -> tuple:
    return compiled.runs["eager"], compiled.runs["capture"]


def host_sample() -> dict:
    """This process's CPU seconds so far (all its threads) and its
    resident MB, to read the window's spread against."""
    import resource

    ru = resource.getrusage(resource.RUSAGE_SELF)
    out = {"cpu_s": ru.ru_utime + ru.ru_stime}
    try:
        with open("/proc/self/statm") as f:
            out["rss_mb"] = int(f.read().split()[1]) \
                * os.sysconf("SC_PAGE_SIZE") / 2**20
    except (OSError, ValueError, IndexError):
        pass
    return out


def _open(run: Run, tracer, now: float, compiled) -> tuple:
    """Open the window (at `now`, or where the tracer opens it); returns
    the run counts at its opening."""
    run.host = host_sample()
    run.t_open = tracer.open_window() if tracer is not None else now
    run.t_close = run.t_open + run.seconds
    run.setup_s = run.t_open - run.t0
    return _runs(compiled)


def _close(run: Run, tracer, now: float, compiled, base: tuple) -> None:
    run.t_trace_close = now
    end = host_sample()
    run.host = {k: end[k] - run.host[k] for k in end if k in run.host}
    run.host["rss_mb_at_close"] = end.get("rss_mb")
    cur = _runs(compiled)
    run.runs_in_window = {"eager": cur[0] - base[0],
                          "capture": cur[1] - base[1]}
    if tracer is not None:
        tracer.close_window()


def stream_loop(bs, warm, window, speed: float, run: Run, keep: Keep,
                tracer, compiled, longest: str):
    """The stream cell's closed loop (see the module's docstring): the
    warm-up's batches, then the window's, pulled by one stream."""
    inflight: deque = deque()
    stop = [False]

    def batches():
        for texts in itertools.chain(warm, window):
            if stop[0]:
                return
            inflight.append((texts, time.perf_counter()))
            yield texts

    n_warm, k, phase = len(warm), 0, "warm"
    for outs in bs.stream(batches(), speed=speed):
        now = time.perf_counter()
        texts, t_pull = inflight.popleft()
        k += 1
        if phase == "warm":
            if k < n_warm:
                continue
            run.warm_runs = dict(zip(("eager", "capture"), _runs(compiled)))
            if tracer is None:
                phase, base = "window", _open(run, tracer, now, compiled)
            else:
                phase, settle = "settle", 0
                tracer.start()
            continue
        if phase == "settle":
            settle += 1
            if settle >= SETTLE:
                phase, base = "window", _open(run, tracer, now, compiled)
            continue
        run.done.append((t_pull, now, answer_lens(outs, len(texts))))
        keep.offer(texts, outs)
        j = texts.index(longest) if longest in texts else -1
        if 0 <= j < len(outs) and len(keep.longest) < 4:
            keep.longest.append((texts[j], outs[j]))
        if phase == "window" and now >= run.t_close:
            phase = "drain"
            stop[0] = True
            _close(run, tracer, now, compiled, base)


def call_loop(eng, warm, window, speed: float, run: Run, keep: Keep,
              tracer, compiled, longest: str):
    """The sentence cell's closed loop (see the module's docstring): the
    warm-up speaks every distinct text, in passes, until a pass runs
    none eagerly and captures none; then the window's draws."""
    for _ in range(WARM_PASSES):
        before = _runs(compiled)
        for text in warm:
            eng.synthesize(text, speed)
        if _runs(compiled) == before:
            break
    run.warm_runs = dict(zip(("eager", "capture"), _runs(compiled)))
    if tracer is not None:
        tracer.start()
        for _ in range(SETTLE):
            eng.synthesize(next(window), speed)
    base = _open(run, tracer, time.perf_counter(), compiled)
    while True:
        text = next(window)
        t0 = time.perf_counter()
        out = eng.synthesize(text, speed)
        t1 = time.perf_counter()
        run.done.append((t0, t1, answer_lens([out], 1)))
        keep.offer([text], [out])
        if text == longest and len(keep.longest) < 4:
            keep.longest.append((text, out))
        if t1 >= run.t_close:
            break
    _close(run, tracer, t1, compiled, base)


def voice_db(root: str) -> str:
    """The generated voice's recordings and the port's voice.db built
    from them, in a fixed directory of the checkout: made by the first
    run there (written aside, then renamed into place), found by the
    later ones."""
    from ctts_tpu_torch.db.builder import build_database

    where = os.path.join(root, CACHE, "voice")
    path = os.path.join(where, "voice.db")
    if os.path.exists(path):
        return path
    part = where + ".part"
    if os.path.isdir(part):
        import shutil

        shutil.rmtree(part)
    ds = os.path.join(part, "dataset")
    voice.generate_dataset(ds)
    build_database(os.path.join(ds, "letters", "wavs"),
                   os.path.join(ds, "letters", "letters.txt"),
                   os.path.join(ds, "syllables", "wavs"),
                   os.path.join(ds, "syllables", "sillabes.txt"),
                   os.path.join(part, "voice.db"), verbose=False)
    os.replace(part, where)
    return path


def quarters(run: Run) -> list:
    """Answers' audio seconds a second in each quarter of the window, by
    when they were yielded: a rate that drifts inside the window shows
    here."""
    q = run.seconds / 4
    out = [0.0] * 4
    for _, end, lens in run.in_window():
        out[min(int((end - run.t_open) / q), 3)] += float(lens[lens > 0].sum())
    return [v / SAMPLE_RATE / q for v in out]


def forbidden_modules(modules=None) -> list:
    """Names in sys.modules whose top-level name (before the first dot)
    is one of FORBIDDEN, compared whole."""
    modules = sys.modules if modules is None else modules
    return sorted({m for m in modules if m.split(".", 1)[0] in FORBIDDEN})


def run_cell(root: str, spec: dict, name: str, seed: int, seconds: float,
             trace: bool, t0: float, device=None,
             bench_dir: str = BENCH_DIR) -> dict:
    """One run of the cell `name`; returns the result line's dict and the
    run's other readings under "info". `t0`: the process's start on the
    perf_counter clock. `device` None: the CUDA card (the caller has
    checked that there is one); a CPU device runs the same loops on the
    port's plain versions, for the tests."""
    import torch

    from ctts_tpu_torch.config import CTTSConfig
    from ctts_tpu_torch.db.reader import VoiceDatabase
    from ctts_tpu_torch.synth import compiled

    cell = Cell(spec, name, bench_dir)
    cfg_file, traffic = cell.config, cell.traffic
    speed = float(cfg_file["speed"])
    kind = traffic["loop"]
    run = Run(kind, speed, seconds, t0)
    dev = device if device is not None else torch.device("cuda")
    on_card = dev.type == "cuda"
    tracer = Tracer(torch) if trace and on_card else None
    base = generator.texts(traffic, cell.traffic_dir)
    longest = max(base, key=len)
    window = generator.draws(traffic, cell.traffic_dir, seed, generator.WINDOW)
    if kind == "stream":
        warm = list(itertools.islice(generator.draws(
            traffic, cell.traffic_dir, seed, generator.WARM),
            int(traffic["warm_batches"])))
    else:
        order = generator.rng(seed, generator.WARM).permutation(len(base))
        warm = [base[i] for i in order]
    per_item = int(traffic["batch"]) if kind == "stream" else 1
    keep = Keep(seed, -(-int(traffic["check_answers"]) // per_item))
    config = CTTSConfig(**cfg_file["config"])
    wire = cfg_file.get("wire", "default")
    wire = None if wire == "default" else bool(wire)
    path = voice_db(root)
    if kind == "stream":
        from ctts_tpu_torch.parallel.batch import BatchSynthesizer

        db = VoiceDatabase(path)
        holder = BatchSynthesizer(db, config, None,
                                  dims_floor=cfg_file.get("dims_floor"),
                                  wire=wire, device=dev)
        cores = [s.core for s in holder.shards]
        if trace:
            timed_method(holder, "_lower_batch",
                         run.spans.setdefault("lower", []))
            timed_method(holder, "_finish", run.spans.setdefault("drain", []))
        loop = stream_loop
    elif kind == "call":
        from ctts_tpu_torch.models.engine import CTTSEngine

        holder = CTTSEngine(path, config=config, device=dev)
        if trace:
            timed_method(holder, "compile",
                         run.spans.setdefault("compile", []))
        loop = call_loop
    else:
        raise ValueError(f"traffic {cell.workload['traffic']!r}: loop "
                         f"{kind!r} is not 'stream' or 'call'")
    try:
        loop(holder, warm, window, speed, run, keep, tracer, compiled,
             longest)
        if tracer is not None:
            run.trace = tracer.stop()
        peak = torch.cuda.max_memory_reserved(dev) if on_card else 0
        wire_used = kind == "stream" and holder.wire
    finally:
        # The program's state goes before the reference runs.
        if kind == "stream":
            for core in cores:
                compiled.release_compiled(core)
            db.close()
        else:
            holder.close()
        holder = None
        if on_card:
            torch.cuda.empty_cache()

    numbers, check_info = checking.compare(
        cfg_file, speed, keep.answers(), run.done, seed,
        int(traffic["check_texts"]), longest)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cell.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    window = run.in_window()
    attempted = sum(len(lens) for _, _, lens in window)
    failed = sum(int((lens < 0).sum()) for _, _, lens in window)
    result = {
        "correct": checking.correct(numbers),
        "attempted": attempted,
        "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if on_card else "cpu",
            "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
            "count": 1,
            "memory_peak_bytes": int(peak),
        },
    }
    if run.trace is not None:
        result["device"]["busy_s"] = run.trace.busy_s
        result["device"]["window_s"] = run.trace.window_s
        result["breakdown"] = {
            "device_ops": run.trace.top_ops(10),
            "idle_gaps": run.trace.labelled_gaps(run.spans, 10)}
    result["check"] = numbers
    result["info"] = {
        "cell": name, "seed": seed, "seconds": seconds, "trace": bool(trace),
        "loop": kind, "speed": speed, "wire": bool(wire_used),
        "setup_s": run.setup_s,
        "items_in_window": len(window),
        "answers_in_window": attempted,
        "items_after_window": len(run.done) - len(window),
        "warm_runs": run.warm_runs,
        "runs_in_window": run.runs_in_window,
        "host_in_window": run.host,
        "trace_event_kinds": getattr(run.trace, "kinds", None),
        "quarters": quarters(run),
        "p50_ms": (float(np.median([(b - a) * 1e3 for a, b, _ in window]))
                   if window else None),
        **check_info}
    return result
