"""The port's benchmark on one CUDA card:  python -m ctts_tpu_torch.bench

Counterpart of bench.py, the JAX package's benchmark (which, on a host
without a TPU, falls back to a bounded CPU run of the JAX package). It
prints ONE JSON line with bench.py's keys (bench.py:563-590),
`"backend": "cuda"`, and these of its own:
  - gpu: the card's name and power limit (nvidia-smi);
  - wire: whether the served stream ran the wire codec (on by default
    on a card; CTTS_WIRE=0 gives the wire-off line);
  - headline_window_x_realtime_per_chip: the headline's whole-window
    rate, the timed yields' audio (each block's first dropped) over
    their wall time, which a stall inside the window lowers where the
    per-yield median does not;
  - peak_device_memory_bytes: max_memory_allocated and
    max_memory_reserved over the headline run;
  - latency_ms_single_sentence: the median wall time of a warm
    CTTSEngine.synthesize of one bench text at 1.0 (its signature
    captured; it ends with the samples on the host);
  - timed_eager_runs, timed_capture_runs, timed_replay_runs: the
    compiled core's runs (synth/compiled.py `runs`) inside the timed
    regions, and timed_compiled_runs the same per section.

Each section keeps bench.py's protocol and environment names
(CTTS_BENCH_BATCH_MULT, _ITERS, _COMPUTE_PIPELINE, _MESH, _STRETCH,
_PARAGRAPH, _1024):
  - headline: the steady audio-s/s of BatchSynthesizer.stream over
    TEXTS x 8 at bench.py's bucket floor, the first yield of each block
    dropped, the median taken;
  - device compute: K batches enqueued back to back, then one wait for
    their row lengths; at 1.0 and (stretch) at 1.5;
  - mesh (default on with one card): make_mesh() of that card, one
    shard, its rates and mesh_matches_unsharded;
  - stretch at 1.5, paragraph (held to the oracle within 32 LSB),
    mixed1024, d2h_transfer_mbps (the last compute batch's payloads
    copied to the host);
  - parity: the last headline batch and the stretch batch against the
    port's NumPy oracle, and their lengths.
Warm-up differs from bench.py's in one way: there one pass compiles
XLA, here a signature's first batch runs eagerly and its second
captures its CUDA graphs, so every batch a section times is first run
until a pass of it runs nothing eagerly and captures nothing (`warm`),
and the timed regions replay only. The C reference (bench.py's
compile_c_reference and c_reference_pass, copied here) needs
reference/ctts.c inside the checkout and gcc; without them vs_baseline and c_reference_x_realtime are 0.0, as in
bench.py, and `error` says so; no other engine takes its place.

With no CUDA device the command prints bench.py's error-shaped line and
exits 1; it never measures the CPU under these names. The sections are
plain functions of a BatchSynthesizer (or a device) and sizes, so the
CPU tests call them on torch.device("cpu") at a tiny size.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager
from typing import Optional

import numpy as np
import torch

SAMPLE_RATE = 22050
METRIC = "audio_seconds_per_second_per_chip"

# bench.py's corpus (TEXTS), its paragraph and long texts, and the bucket
# floor of its headline section (bench.py:25-42, 248-250, 404-411, 449-456).
TEXTS = [
    "como vai?",
    "que legal!",
    "eu quero café, pão, e manteiga",
    "bom dia. como vai. tudo bem.",
    "eu tenho 5 livros",
    "são 42 pessoas",
    "a rosa é vermelha",
    "minha casa é grande",
    "o rato roeu a roupa do rei de roma",
    "vamos para a praia",
    "o brasil é um país muito bonito",
    "quando chegar em casa, me liga",
    "preciso comprar coisas para casa",
    "hoje de manhã eu acordei cedo e fui trabalhar",
    "isso é incrível!",
    "onde fica o banco?",
]
PARAGRAPH = (
    "no dia 15 de março de 2024, a empresa anunciou lucros de "
    "3500000 reais. o diretor, sr. joão silva, disse: isso é "
    "incrível! a meta era 2000000, mas superamos. agora temos "
    "42 filiais, 1200 funcionários, e planos para 2025. "
    "será que vamos crescer 30 por cento? talvez, quem sabe. "
    "a matriz fica na rua 7, número 123, em são paulo."
)
LONG_TEXTS = [
    "hoje de manhã eu acordei cedo, tomei café com pão e "
    "manteiga, e fui trabalhar de ônibus pela avenida principal",
    "o brasil é um país muito bonito com praias, montanhas, "
    "florestas e cidades grandes cheias de gente trabalhadora",
]
FLOOR = {"U": 32, "R": 16, "FD": 8, "WREG": 32768, "SMAX": 114688,
         "CONTW": 28672, "WIN": 2048, "CFMAX": 1024}

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The C reference bench.py compiles, looked for inside the checkout only.
REFERENCE_C = os.path.join(REPO, "reference", "ctts.c")

# The single-sentence latency: one bench text, timed this many times.
LATENCY_TEXT = TEXTS[10]
LATENCY_REPS = 21
RUN_KINDS = ("eager", "capture", "replay")
WARM_PASSES = 3     # eager, capture, then a pass that replays only


def compile_c_reference(root: str) -> str | None:
    """Compile the reference C binary once, up front (compile time stays
    out of the measurement window). None if unavailable."""
    ref = REFERENCE_C
    if not os.path.exists(ref) or shutil.which("gcc") is None:
        return None
    binpath = os.path.join(root, "ctts_ref")
    try:
        subprocess.run(
            ["gcc", "-O3", "-std=c99", "-o", binpath, ref, "-lm"],
            check=True, capture_output=True, timeout=120,
        )
    except Exception:
        return None
    return binpath


def c_reference_pass(binpath: str, root: str, dbp: str) -> float:
    """One full corpus pass of the C binary; its single-pass RTF (taken
    between the headline's stream blocks, medians on both sides)."""
    total_audio = 0.0
    t0 = time.perf_counter()
    for i, text in enumerate(TEXTS):
        out = os.path.join(root, f"ref_{i}.wav")
        r = subprocess.run(
            [binpath, "synth", dbp, text, out, "1.0"],
            capture_output=True, cwd=root, timeout=120,
        )
        if r.returncode != 0:
            return 0.0
        total_audio += (os.path.getsize(out) - 44) / 2 / SAMPLE_RATE
    dt = time.perf_counter() - t0
    return total_audio / dt if dt > 0 else 0.0


# -- the compiled core's runs -------------------------------------------


def _runs_since(before: dict) -> dict:
    from ctts_tpu_torch.synth import compiled

    return {k: compiled.runs[k] - before.get(k, 0) for k in RUN_KINDS}


class TimedRuns:
    """The compiled core's eager / capture / replay runs inside each
    timed region, per section."""

    def __init__(self):
        self.by_section: dict = {}

    @contextmanager
    def timed(self, section: str):
        from ctts_tpu_torch.synth import compiled

        before = dict(compiled.runs)
        try:
            yield
        finally:
            got = self.by_section.setdefault(section,
                                             dict.fromkeys(RUN_KINDS, 0))
            for k, v in _runs_since(before).items():
                got[k] += v

    def totals(self) -> dict:
        return {f"timed_{k}_runs": sum(s[k] for s in self.by_section.values())
                for k in RUN_KINDS}


def warm(run) -> None:
    """Run `run()` until one pass of it runs no batch eagerly and
    captures none, at most WARM_PASSES times: on a card a signature's
    first batch runs eagerly and its second captures, so a region timed
    after this replays only. On the CPU nothing is counted, and one pass
    is made."""
    from ctts_tpu_torch.synth import compiled

    for _ in range(WARM_PASSES):
        before = dict(compiled.runs)
        run()
        got = _runs_since(before)
        if not got["eager"] and not got["capture"]:
            return


def warm_oom_halving(run, texts, floor):
    """warm() a callable over `texts`; on device OOM halve the batch and
    retry, down to `floor` sentences (bench.py's guard: every section
    runs buckets of its own). Returns the surviving batch."""
    while True:
        try:
            warm(lambda: run(texts))
            return texts
        except Exception as e:
            if "memory" not in str(e).lower() or len(texts) <= floor:
                raise
            texts = texts[: max(len(texts) // 2, floor)]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _audio_s(outs) -> float:
    return sum(o.shape[0] for o in outs) / SAMPLE_RATE


def stream_yields(bs, batches: int, texts, speed: float = 1.0) -> tuple:
    """stream() over `batches` copies of `texts`: each yield's audio
    seconds and the wall seconds since the last one, and the last
    outputs."""
    yields, outs = [], None
    _sync(bs.device)
    t0 = time.perf_counter()
    for outs in bs.stream((texts for _ in range(batches)), speed=speed):
        t1 = time.perf_counter()
        yields.append((_audio_s(outs), t1 - t0))
        t0 = t1
    return yields, outs


def median_rate(yields) -> float:
    """The median of the yields' audio-s/s (bench.py's statistic)."""
    return float(np.median([a / dt for a, dt in yields]))


def window_rate(yields) -> float:
    """The yields' audio over their summed wall time."""
    return sum(a for a, _ in yields) / sum(dt for _, dt in yields)


# -- sections ------------------------------------------------------------


def headline(bs, texts, iters: int, runs: TimedRuns, c_bin=None,
             root: Optional[str] = None, dbp: Optional[str] = None) -> dict:
    """Steady audio-s/s of the served stream (bench.py:282-305): blocks
    of per_rep + 1 batches, each block's first yield dropped, the median
    taken (rtf), and the kept yields' whole-window rate (window_rtf);
    with the C binary, a corpus pass of it between blocks. The card's
    peak memory over the run."""
    reps = 3 if c_bin else 1
    per_rep = max(iters // reps, 2)
    kept, c_rtfs = [], []
    mem = _peak_reset(bs.device)
    for _ in range(reps):
        with runs.timed("headline"):
            block, outs = stream_yields(bs, per_rep + 1, texts)
        kept.extend(block[1:])
        if c_bin:
            c_rtfs.append(c_reference_pass(c_bin, root, dbp))
    return {"rtf": median_rate(kept), "window_rtf": window_rate(kept),
            "c_rtf": float(np.median(c_rtfs)) if c_rtfs else 0.0,
            "outs": outs, "peak_device_memory_bytes": mem()}


def _peak_reset(device: torch.device):
    """Reset the card's peak memory counters; the returned function
    reads them (None on the CPU)."""
    if device.type != "cuda":
        return lambda: None
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    return lambda: {
        "max_memory_allocated": torch.cuda.max_memory_allocated(device),
        "max_memory_reserved": torch.cuda.max_memory_reserved(device)}


def dispatch(bs, texts, speed: float):
    """Lower a batch (as stream() does) and enqueue it; returns its
    handles (BatchSynthesizer._enqueue)."""
    prepared, _ = bs._lower_batch(texts, speed, True)
    return bs._enqueue(prepared)


def enqueued_audio_s(enqueued) -> float:
    """Audio seconds of an enqueued batch's real rows, from the row
    lengths alone (4 bytes a row to the host)."""
    _, per_bucket = enqueued
    total = 0
    for _, b in per_bucket:
        for d, (_, _, out_lens, _) in enumerate(b.shards):
            k = min(b.n - d * b.rows, b.rows)
            if k > 0:
                total += int(out_lens[:k].sum())
    return total / SAMPLE_RATE


def device_compute(bs, texts, speed: float, K: int, runs: TimedRuns,
                   section: str, reps: int = 3) -> tuple:
    """Device-compute rate (bench.py:307-337): K batches enqueued back to
    back, then their row lengths brought to the host, so that the drain
    of the audio stays out; the median over `reps`. Returns (rate, the
    last batch's handles)."""
    rates = []
    for _ in range(reps):
        with runs.timed(section):
            _sync(bs.device)
            t0 = time.perf_counter()
            handles = [dispatch(bs, texts, speed) for _ in range(K)]
            audio = sum(enqueued_audio_s(h) for h in handles)
            rates.append(audio / (time.perf_counter() - t0))
    return float(np.median(rates)), handles[-1]


def d2h_transfer_mbps(enqueued) -> float:
    """The last compute batch's payloads (and wire classes) copied to
    the host, bytes over seconds (bench.py:339-350)."""
    _, per_bucket = enqueued
    t0 = time.perf_counter()
    drained = 0
    for _, b in per_bucket:
        for payload, classes, _, _ in b.shards:
            for b in (payload, classes):
                if b is not None:
                    drained += b.cpu().numpy().nbytes
    dt = time.perf_counter() - t0
    return drained / dt / 1e6 if dt > 0 else 0.0


def mesh_section(bs, texts, iters: int, K: int, outs, runs: TimedRuns,
                 floor) -> dict:
    """The split's path on one device (bench.py:352-404): a mesh of
    bs.device alone, its stream's median rate, whether its outputs equal
    the unsharded headline's, and its compute rate. A failure is
    reported in mesh_error, never raised."""
    from ctts_tpu_torch.parallel.batch import BatchSynthesizer
    from ctts_tpu_torch.parallel.mesh import make_mesh

    res = {"mesh_x_realtime_per_chip": 0.0,
           "mesh_compute_x_realtime_per_chip": 0.0,
           "mesh_matches_unsharded": None, "mesh_error": ""}
    try:
        bs_m = BatchSynthesizer(bs.db, bs.config, mesh=make_mesh([bs.device]),
                                dims_floor=floor)
        m_texts = warm_oom_halving(
            lambda t: [None for _ in bs_m.stream([t])], texts, len(TEXTS))
        m_iters = max(iters // 2, 3)
        with runs.timed("mesh"):
            m_yields, m_outs = stream_yields(bs_m, m_iters + 1, m_texts)
        res["mesh_x_realtime_per_chip"] = median_rate(m_yields[1:])
        if m_texts == texts and m_outs is not None:
            res["mesh_matches_unsharded"] = bool(all(
                a.shape == b.shape and np.array_equal(a, b)
                for a, b in zip(m_outs, outs)))
        res["mesh_compute_x_realtime_per_chip"] = device_compute(
            bs_m, m_texts, 1.0, K, runs, "mesh_compute")[0]
    except Exception as e:
        import traceback

        traceback.print_exc()
        res["mesh_error"] = f"{type(e).__name__}: {e}"[:300]
    return res


def stretch_section(bs, texts, iters: int, K: int, runs: TimedRuns,
                    n_chips: int = 1, compute_reps: int = 3) -> dict:
    """WSOLA at speed 1.5 (bench.py:406-446): the stream's median rate of
    output audio, and its compute rate; the last outputs feed the
    stretch parity."""
    s_texts = warm_oom_halving(
        lambda t: [None for _ in bs.stream([t], speed=1.5)],
        texts, len(TEXTS))
    s_iters = max(iters - 2, 2)
    with runs.timed("stretch"):
        s_yields, s_outs = stream_yields(bs, s_iters, s_texts, 1.5)
    rate, _ = device_compute(bs, s_texts, 1.5, K, runs, "stretch_compute",
                             compute_reps)
    return {"stretch_x_realtime_per_chip": median_rate(s_yields)
            / max(n_chips, 1),
            "stretch_compute_x_realtime_per_chip": rate / max(n_chips, 1),
            "outs": s_outs}


def oracle(db, config, text: str, speed: float) -> np.ndarray:
    from ctts_tpu_torch.plan.compiler import compile_plan
    from ctts_tpu_torch.synth.oracle import execute_plan_oracle

    return execute_plan_oracle(compile_plan(db, text, config, None, speed),
                               db)


def paragraph_section(bs, runs: TimedRuns, paragraph: str = PARAGRAPH,
                      copies: int = 8, iters: int = 4,
                      n_chips: int = 1) -> dict:
    """The multi-sentence paragraph through the stream, split at
    sentence boundaries (bench.py:448-490): the median rate, and its
    first output within 32 LSB of the oracle's one grown buffer, with
    the same length."""
    paras = warm_oom_halving(
        lambda p: [None for _ in bs.stream([p])], [paragraph] * copies, 1)
    with runs.timed("paragraph"):
        p_yields, p_outs = stream_yields(bs, iters, paras)
    ref = oracle(bs.db, bs.config, paragraph, 1.0)
    got = p_outs[0]
    ok = bool(len(ref) == len(got) and (np.abs(
        ref.astype(np.int32) - got.astype(np.int32)) <= 32).all())
    return {"paragraph_x_realtime_per_chip": median_rate(p_yields)
            / max(n_chips, 1), "paragraph_parity_ok": ok}


def mixed_section(bs, chunk: int, runs: TimedRuns, n: int = 1024) -> dict:
    """The mixed-length serving run (bench.py:492-530): n sentences of
    TEXTS and LONG_TEXTS in chunks of `chunk`, every chunk warmed (their
    buckets differ), then one timed stream over all of them."""
    mixed = ((TEXTS + LONG_TEXTS) * (-(-n // (len(TEXTS) + 2))))[:n]
    while True:
        batches = [mixed[i:i + chunk] for i in range(0, len(mixed), chunk)]
        try:
            warm(lambda: [None for _ in bs.stream(iter(batches))])
            break
        except Exception as e:
            if "memory" not in str(e).lower() or chunk <= len(TEXTS):
                raise
            chunk = max(chunk // 2, len(TEXTS))
    with runs.timed("mixed1024"):
        _sync(bs.device)
        t0 = time.perf_counter()
        audio = sum(_audio_s(outs) for outs in bs.stream(iter(batches)))
        rate = audio / (time.perf_counter() - t0)
    return {"mixed1024_aggregate_x_realtime": rate, "sentences": len(mixed),
            "chunk": chunk}


def parity(db, config, texts, outs, speed: float) -> dict:
    """Each of `texts` (the first outputs of `outs`) against the oracle
    (bench.py:532-570): the largest difference over full scale, the
    share of samples more than 32 LSB off, and whether every length
    matches."""
    max_abs, bad, total, len_match = 0.0, 0, 0, True
    for t, got in zip(texts, outs[: len(texts)]):
        ref = oracle(db, config, t, speed)
        len_match &= bool(len(ref) == len(got))
        n = min(len(ref), len(got))
        if n:
            diff = np.abs(ref[:n].astype(np.int32) - got[:n].astype(np.int32))
            max_abs = max(max_abs, float(diff.max() / 32768.0))
            bad += int((diff > 32).sum())
            total += n
    return {"max_abs": max_abs, "frac_over_budget": bad / max(total, 1),
            "length_match": len_match}


def single_sentence_latency(dbp: str, device: torch.device,
                            runs: TimedRuns, text: str = LATENCY_TEXT,
                            reps: int = LATENCY_REPS) -> float:
    """Median milliseconds of CTTSEngine.synthesize(text, 1.0) on a warm
    engine (its signature captured on a card), from an idle device to
    the samples on the host."""
    from ctts_tpu_torch.models.engine import CTTSEngine

    eng = CTTSEngine(dbp, device=device)
    try:
        warm(lambda: eng.synthesize(text, 1.0))
        times = []
        with runs.timed("latency_single_sentence"):
            for _ in range(reps):
                _sync(device)
                t0 = time.perf_counter()
                eng.synthesize(text, 1.0)
                times.append(time.perf_counter() - t0)
    finally:
        eng.close()
    return float(np.median(times)) * 1e3


# -- the whole line ------------------------------------------------------


def run(device: torch.device, dbp: str, root: str, texts=None,
        batch_mult: int = 8, iters: int = 6, K: int = 4,
        mesh: bool = True, stretch: bool = True,
        paragraph: Optional[str] = PARAGRAPH, mixed: int = 1024,
        floor: Optional[dict] = FLOOR, compute_reps: int = 3,
        latency_reps: int = LATENCY_REPS) -> dict:
    """Every section on `device` over the voice at `dbp`; returns the
    JSON line's dict. `texts` (default TEXTS) times `batch_mult` is a
    headline batch; the parity is taken on `texts`. paragraph None or
    mixed 0 turn those sections off (their keys read 0.0 / True, as in
    bench.py)."""
    from ctts_tpu_torch.config import config_defaults
    from ctts_tpu_torch.db.reader import VoiceDatabase
    from ctts_tpu_torch.parallel.batch import BatchSynthesizer
    from ctts_tpu_torch.parallel.mesh import make_mesh
    from ctts_tpu_torch.synth import compiled

    base = list(TEXTS if texts is None else texts)
    rerun = sum(compiled.widened.values())
    db = VoiceDatabase(dbp)
    config = config_defaults()
    n_chips = torch.cuda.device_count() if device.type == "cuda" else 1
    bs = BatchSynthesizer(
        db, config, mesh=make_mesh() if n_chips > 1 else None,
        dims_floor=floor, device=None if n_chips > 1 else device)
    runs = TimedRuns()

    while batch_mult >= 1:
        batch = base * batch_mult
        try:
            warm(lambda: [None for _ in bs.stream([batch])])
            break
        except Exception as e:
            if "memory" not in str(e).lower() or batch_mult == 1:
                raise
            batch_mult //= 2

    c_bin = compile_c_reference(root)
    head = headline(bs, batch, iters, runs, c_bin, root, dbp)
    rtf = head["rtf"]
    outs = head["outs"]
    compute, last = device_compute(bs, batch, 1.0, K, runs, "compute",
                                   compute_reps)
    transfer = d2h_transfer_mbps(last)
    mesh_res = {"mesh_x_realtime_per_chip": 0.0,
                "mesh_compute_x_realtime_per_chip": 0.0,
                "mesh_matches_unsharded": None, "mesh_error": ""}
    if mesh:
        mesh_res = mesh_section(bs, batch, iters, K, outs, runs, floor)
    st = {"stretch_x_realtime_per_chip": 0.0,
          "stretch_compute_x_realtime_per_chip": 0.0, "outs": None}
    if stretch:
        st = stretch_section(bs, batch, iters, K, runs, n_chips,
                             compute_reps)
    para = {"paragraph_x_realtime_per_chip": 0.0, "paragraph_parity_ok": True}
    if paragraph:
        para = paragraph_section(bs, runs, paragraph, n_chips=n_chips)
    mix = {"mixed1024_aggregate_x_realtime": 0.0}
    if mixed:
        mix = mixed_section(bs, len(batch), runs, mixed)
    par = parity(db, config, base, outs, 1.0)
    s_par = {"max_abs": 0.0, "length_match": True}
    if st["outs"] is not None:
        s_par = parity(db, config, base, st["outs"], 1.5)
    latency = single_sentence_latency(dbp, device, runs,
                                      reps=latency_reps)
    c_rtf = head["c_rtf"]
    error = "" if c_bin else (
        "C reference unavailable (reference/ctts.c in the checkout, and "
        "gcc): vs_baseline and c_reference_x_realtime are 0.0")
    line = {
        "metric": METRIC,
        "value": rtf / max(n_chips, 1),
        "unit": "x_realtime",
        "vs_baseline": rtf / c_rtf if c_rtf > 0 else 0.0,
        "aggregate_x_realtime": rtf,
        "n_chips": n_chips,
        "batch_sentences": len(batch),
        "stretch_x_realtime_per_chip": st["stretch_x_realtime_per_chip"],
        "stretch_compute_x_realtime_per_chip":
            st["stretch_compute_x_realtime_per_chip"],
        "device_compute_x_realtime_per_chip": compute / max(n_chips, 1),
        **mesh_res,
        "paragraph_x_realtime_per_chip":
            para["paragraph_x_realtime_per_chip"],
        "paragraph_parity_ok": para["paragraph_parity_ok"],
        "mixed1024_aggregate_x_realtime":
            mix["mixed1024_aggregate_x_realtime"],
        "c_reference_x_realtime": c_rtf,
        "d2h_transfer_mbps": transfer,
        "parity_max_abs_vs_oracle": par["max_abs"],
        "parity_frac_samples_over_1e3": par["frac_over_budget"],
        "parity_length_match": par["length_match"],
        "stretch_parity_max_abs_vs_oracle": s_par["max_abs"],
        "stretch_parity_length_match": s_par["length_match"],
        "backend": device.type,
        "error": error,
        "wire": bs.wire,
        "headline_window_x_realtime_per_chip":
            head["window_rtf"] / max(n_chips, 1),
        "peak_device_memory_bytes": head["peak_device_memory_bytes"],
        "latency_ms_single_sentence": latency,
        **runs.totals(),
        "timed_compiled_runs": runs.by_section,
        # Rows run again at a wider silence table (compiled.run_wide):
        # 0 at the default configuration.
        "silence_rows_rerun": sum(compiled.widened.values()) - rerun,
    }
    return line


def _env_int(name: str, default: str) -> int:
    return int(os.environ.get(name, default))


def main() -> int:
    if not torch.cuda.is_available():
        print(json.dumps({"metric": METRIC, "value": 0.0,
                          "unit": "x_realtime", "vs_baseline": 0.0,
                          "backend": "none",
                          "error": "no CUDA device: the port's bench "
                                   "measures a card only"}))
        return 1
    from ctts_tpu_torch import env
    from ctts_tpu_torch.testing.dryrun import generated_voice_db

    device = env.device()
    one_card = torch.cuda.device_count() == 1
    with tempfile.TemporaryDirectory(prefix="ctts_bench_") as root:
        line = run(
            device, generated_voice_db(root), root,
            batch_mult=_env_int("CTTS_BENCH_BATCH_MULT", "8"),
            iters=_env_int("CTTS_BENCH_ITERS", "6"),
            K=_env_int("CTTS_BENCH_COMPUTE_PIPELINE", "4"),
            mesh=os.environ.get("CTTS_BENCH_MESH",
                                "1" if one_card else "0") == "1",
            stretch=os.environ.get("CTTS_BENCH_STRETCH", "1") == "1",
            paragraph=PARAGRAPH if os.environ.get(
                "CTTS_BENCH_PARAGRAPH", "1") == "1" else None,
            mixed=1024 if os.environ.get("CTTS_BENCH_1024", "1") == "1"
            else 0)
    line["gpu"] = env.gpu_name_and_power_limit()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except Exception as e:  # always leave ONE parseable JSON line
        import traceback

        traceback.print_exc()
        print(json.dumps({"metric": METRIC, "value": 0.0,
                          "unit": "x_realtime", "vs_baseline": 0.0,
                          "backend": "cuda",
                          "error": f"{type(e).__name__}: {e}"}))
        rc = 1
    sys.exit(rc)
