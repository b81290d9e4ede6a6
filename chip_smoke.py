#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (ctts_tpu_torch) on one card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (each raises on failure; the exit code is nonzero on any fault):
  1. environment report (torch, CUDA, device, power limit, nvcc);
  2. build the Hopper kernels (csrc/*.cu) and libctts.so from source;
  3. IEEE division and sqrt on the card against numpy, bit for bit;
  4. each kernel against its plain PyTorch version on the card, at the
     serving bucket's shapes, with both median times (CUDA events);
  5. the serving path: BatchSynthesizer.stream over 3 batches of the
     16 bench texts x 8, with every kernel's launch count, the output
     checked against the NumPy oracle (equal lengths, <= 2 LSB), the
     steady-state audio-seconds per wall-second and peak memory. The
     stream yields batch N after batch N+2 is enqueued, so per-yield
     intervals are not batch periods: the steady rate of batches 2-3 is
     their audio over the wall time a 3-batch stream takes beyond a
     1-batch stream (the same fill and drain cancel), medians of
     interleaved repeats; the last 3-batch stream is the counted run.
The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# The serving corpus and bucket floor of bench.py (TEXTS, the
# dims_floor of its headline section).
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
FLOOR = {"U": 32, "R": 16, "FD": 8, "WREG": 32768, "SMAX": 114688,
         "CONTW": 28672, "WIN": 2048, "CFMAX": 1024}
BATCH_MULT = 8
N_BATCHES = 3
TIMING_REPEATS = 3  # interleaved 1- and 3-batch streams, medians used
SAMPLE_RATE = 22050
LSB_BOUND = 2       # int16 bound against the oracle (tests/test_device_executor.py)

# Kernel shapes of the serving bucket above at batch 128.
B, U, UBUF, CFMAX = 128, 32, 7168, 1024
R, WREG, MARGIN, CONTW, SMAX = 16, 32768, 3072, 28672, 114688
NSHIFT = 16
NBLK = 32


def say(tag: str, obj) -> None:
    print(f"{tag} {json.dumps(obj)}", flush=True)


def time_ms(fn, reps: int) -> float:
    """Median milliseconds of `fn` over `reps` runs, after one warm-up,
    each bracketed by CUDA events on the current stream."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def check_ieee(torch, np) -> dict:
    """Tensor division and the port's sqrt_rn on the card equal numpy
    (correctly rounded) on the value sets of tests/test_exact_div_sqrt.py;
    torch's own f32 sqrt on the card is reported beside them."""
    from ctts_tpu_torch.ops.exact import sqrt_rn

    rng = np.random.default_rng(7)
    f32 = np.float32
    a = np.concatenate([
        (22050.0 / rng.integers(30, 300, 200_000)).astype(f32),
        rng.uniform(-1e6, 1e6, 200_000).astype(f32),
        np.array([157.5, 1.0, 3.0, 10.0, 0.0, -157.5], f32)])
    b = np.concatenate([
        (22050.0 / rng.integers(30, 300, 200_000)).astype(f32),
        rng.uniform(1e-3, 1e6, 200_000).astype(f32),
        np.array([f32(22050.0) / f32(119.0), 2.0, 4.0, 8.0, 3.0, 0.5], f32)])
    x = np.concatenate([rng.uniform(0, 1e12, 400_000).astype(f32),
                        rng.integers(0, 2**30, 100_000).astype(f32),
                        np.array([0.0, 1.0, 2.0, 4.0], f32)])
    dev = torch.device("cuda")

    def mismatches(got, want):
        return int((got.cpu().numpy().view(np.int32)
                    != want.view(np.int32)).sum())

    xt = torch.as_tensor(x, device=dev)
    q_bad = mismatches(torch.as_tensor(a, device=dev)
                       / torch.as_tensor(b, device=dev), a / b)
    s_bad = mismatches(sqrt_rn(xt), np.sqrt(x))
    res = {"div_values": int(a.size), "div_mismatch": q_bad,
           "sqrt_values": int(x.size), "sqrt_mismatch": s_bad,
           "torch_f32_sqrt_mismatch": mismatches(torch.sqrt(xt), np.sqrt(x))}
    if q_bad or s_bad:
        raise RuntimeError(f"IEEE ops differ from numpy on the card: {res}")
    return res


def kernel_inputs(np):
    """Seeded inputs at the serving bucket's shapes, holding the plan
    invariants each kernel relies on."""
    rng = np.random.default_rng(0)
    ins = {}

    # pitch: B*NSHIFT candidate rows of int16-valued segments.
    n = B * NSHIFT
    seg = rng.integers(-32768, 32768, (n, 495)).astype(np.float32)
    t = np.arange(495)
    for r in range(0, n, 3):
        seg[r] = np.round(12000 * np.sin(2 * np.pi * t / (55 + r % 220)))
    seg[1::7] = 0.0
    seg[2::7] = np.where(seg[2::7] >= 0, 32767.0, -32768.0)
    ana = rng.integers(-20, 221, n).astype(np.int32)
    ins["pitch"] = (seg, ana)

    # compose: two units per region, ascending overlapping offsets.
    base_off = np.zeros((B, U), np.int32)
    for k in range(U):
        r, j = divmod(k, 2)
        base_off[:, k] = (r * WREG + MARGIN + j * 6000
                          + rng.integers(0, 96, B))
    cf_in = rng.integers(0, CFMAX + 1, (B, U)).astype(np.int32)
    n_eff = rng.integers(CFMAX + 1, UBUF + 1, (B, U)).astype(np.int32)
    n_eff[:, -3:] = 0                                   # inactive slots
    a_c = rng.integers(0, 2 * CFMAX + 1, (B, U)).astype(np.int32)
    contrib = np.trunc(rng.uniform(-8000, 8000, (B, U, UBUF))
                       ).astype(np.float32)
    fo = rng.uniform(0.0, 1.0, (B, U, CFMAX)).astype(np.float32)
    ins["compose"] = (contrib, fo, base_off, cf_in, n_eff, a_c)

    # compact: ascending kept segments, packed destinations.
    bufs = np.trunc(rng.uniform(-30000, 30000, (B, R * WREG))
                    ).astype(np.float32)
    starts = np.zeros((B, R, NBLK), np.int32)
    dst = np.zeros((B, R, NBLK), np.int32)
    seg_len = np.zeros((B, R, NBLK), np.int32)
    for b in range(B):
        for r in range(R):
            pos = out = MARGIN
            kept = 0
            for _ in range(int(rng.integers(0, 12))):
                pos += int(rng.integers(0, 900))
                ln = int(rng.integers(1, 3000))
                if pos + ln > MARGIN + CONTW:
                    break
                starts[b, r, kept] = pos
                dst[b, r, kept] = out
                seg_len[b, r, kept] = ln
                pos += ln
                out += ln
                kept += 1
            dst[b, r, kept:] = out
    ins["compact"] = (bufs, starts, dst, seg_len)

    # assemble: cumsum offsets of active regions, margin overlap.
    active = rng.random((B, R)) < 0.8
    new_lens = np.where(active, rng.integers(0, 5000, (B, R)), 0)
    pauses = np.where(active, rng.integers(0, 2000, (B, R)), 0)
    seg_tot = new_lens + pauses
    offsets = (np.cumsum(seg_tot, 1) - seg_tot).astype(np.int32)
    live = np.where(active, MARGIN + new_lens, 0).astype(np.int32)
    ins["assemble"] = (bufs, offsets, live)
    return ins


def check_kernels(torch, np, hopper) -> dict:
    """Kernel vs plain version on the card: equal bits, both times."""
    dev = torch.device("cuda")
    ins = kernel_inputs(np)

    def cuda(*xs):
        return [torch.as_tensor(x, device=dev) for x in xs]

    seg, ana = cuda(*ins["pitch"])
    contrib, fo, base_off, cf_in, n_eff, a_c = cuda(*ins["compose"])
    bufs, starts, dst, seg_len = cuda(*ins["compact"])
    _, offsets, live = cuda(*ins["assemble"])
    TOT, OUTW = R * WREG, MARGIN + SMAX
    cases = {
        "pitch_corr": (
            lambda: hopper.pitch.pitch_corr(seg, ana),
            lambda: hopper.pitch.pitch_corr_plain(seg, ana), 20, 5),
        "compose": (
            lambda: hopper.compose.compose(contrib, fo, base_off, cf_in,
                                           n_eff, a_c, TOT, True),
            lambda: hopper.compose.compose_plain(contrib, fo, base_off, cf_in,
                                                 n_eff, a_c, TOT, True),
            10, 3),
        "compact": (
            lambda: hopper.compact.compact(bufs, starts, dst, seg_len, WREG),
            lambda: hopper.compact.compact_plain(bufs, starts, dst, seg_len,
                                                 WREG), 20, 3),
        "assemble": (
            lambda: hopper.assemble.assemble(bufs, offsets, live, WREG, OUTW),
            lambda: hopper.assemble.assemble_plain(bufs, offsets, live, WREG,
                                                   OUTW), 20, 3),
    }
    results = {}
    for name, (kern, plain, reps, plain_reps) in cases.items():
        got, want = kern(), plain()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        torch.cuda.synchronize()
        equal = all(torch.equal(g, w) for g, w in zip(got, want))
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        res = {"equal": equal, "max_abs_err": err,
               "ms": time_ms(kern, reps), "plain_ms": time_ms(plain,
                                                              plain_reps),
               "shapes": [list(g.shape) for g in got]}
        say(f"kernel {name}", res)
        if not equal:
            raise RuntimeError(f"{name}: kernel differs from its plain "
                               f"version (max abs err {err})")
        results[name] = res
    return results


def run_slice(torch, np, hopper) -> dict:
    """The serving path end to end on the card, held to the oracle."""
    from ctts_tpu.config import config_defaults
    from ctts_tpu.db.builder import build_database
    from ctts_tpu.db.dataset import generate_dataset
    from ctts_tpu.db.reader import VoiceDatabase
    from ctts_tpu.plan.compiler import compile_plan
    from ctts_tpu.synth.oracle import execute_plan_oracle
    from ctts_tpu_torch.parallel.batch import BatchSynthesizer

    with tempfile.TemporaryDirectory() as root:
        ds = os.path.join(root, "dataset")
        generate_dataset(ds)
        dbp = os.path.join(root, "voice.db")
        build_database(os.path.join(ds, "letters", "wavs"),
                       os.path.join(ds, "letters", "letters.txt"),
                       os.path.join(ds, "syllables", "wavs"),
                       os.path.join(ds, "syllables", "sillabes.txt"),
                       dbp, verbose=False)
        db = VoiceDatabase(dbp)
        config = config_defaults()
        bs = BatchSynthesizer(db, config, device=torch.device("cuda"),
                              dims_floor=FLOOR)
        texts = TEXTS * BATCH_MULT

        def timed_stream(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = list(bs.stream(texts for _ in range(n)))
            return got, time.perf_counter() - t0

        timed_stream(1)                       # first-use set-up, untimed
        walls_1, walls_n = [], []
        for rep in range(TIMING_REPEATS):
            walls_1.append(timed_stream(1)[1])
            if rep == TIMING_REPEATS - 1:
                torch.cuda.reset_peak_memory_stats()
                hopper.reset_launches()
            batches, wall = timed_stream(N_BATCHES)
            walls_n.append(wall)
        launches = hopper.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        wall_1 = sorted(walls_1)[TIMING_REPEATS // 2]
        wall_n = sorted(walls_n)[TIMING_REPEATS // 2]

        if len(batches) != N_BATCHES or any(len(o) != len(texts)
                                            for o in batches):
            raise RuntimeError("stream did not yield every batch in full")
        audio = [sum(o.shape[0] for o in outs) / SAMPLE_RATE
                 for outs in batches]

        worst = 0
        for j, text in enumerate(TEXTS):
            ref = execute_plan_oracle(
                compile_plan(db, text, config, None, 1.0), db)
            for outs in batches:
                for rep in range(BATCH_MULT):
                    got = outs[rep * len(TEXTS) + j]
                    if got.dtype != np.int16 or got.shape != ref.shape:
                        raise RuntimeError(
                            f"{text!r}: length {got.shape} vs oracle "
                            f"{ref.shape}")
                    d = int(np.abs(got.astype(np.int32)
                                   - ref.astype(np.int32)).max(initial=0))
                    worst = max(worst, d)
                    if d > LSB_BOUND:
                        raise RuntimeError(
                            f"{text!r}: max |diff| {d} LSB vs the oracle")
        missing = [k for k, v in launches.items() if v <= 0]
        if missing:
            raise RuntimeError(f"kernels not launched by the path: {missing}")
        res = {
            "batches": len(batches), "sentences_per_batch": len(texts),
            "distinct_texts": len(TEXTS), "oracle_max_abs_diff": worst,
            "launches": launches,
            "audio_s_per_batch": audio,
            "stream_1_batch_s": walls_1, "stream_3_batches_s": walls_n,
            "stream_audio_s_per_wall_s": sum(audio) / wall_n,
            "steady_audio_s_per_wall_s": sum(audio[1:]) / (wall_n - wall_1),
            "max_memory_allocated_bytes": peak,
        }
        say("slice", res)
        return res


def main() -> int:
    if not os.path.isdir(os.path.join(REPO, "ctts_tpu_torch")) or \
            not os.path.isdir(os.path.join(REPO, "ctts_tpu")):
        print("chip_smoke.py: ctts_tpu_torch/ and ctts_tpu/ not found next "
              "to this script; run it from a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 3

    from ctts_tpu_torch import env
    from ctts_tpu_torch.ops import hopper
    from ctts_tpu_torch.ops.hopper import build
    from ctts_tpu_torch.plan import native_lower

    report = env.report()
    say("env", report)

    t0 = time.perf_counter()
    build.lib()
    t1 = time.perf_counter()
    native_lower._load()
    t2 = time.perf_counter()
    ptxas = [ln.strip() for ln in build.BuildInfo.log.splitlines()
             if "registers" in ln or "spill" in ln]
    say("build", {"kernels_s": t1 - t0, "nvcc_s": build.BuildInfo.seconds,
                  "libctts_s": t2 - t1, "ptxas": ptxas})

    say("ieee", check_ieee(torch, np))
    kern = check_kernels(torch, np, hopper)
    sl = run_slice(torch, np, hopper)

    if "jax" in sys.modules:
        raise RuntimeError("jax was imported")
    kernels = []
    for mod in hopper.MODULES:
        k = kern[mod.KERNEL]
        kernels.append({"name": mod.KERNEL, "route": "cuda",
                        "source": mod.SOURCE, "replaces": mod.REPLACES,
                        "launches": sl["launches"][mod.KERNEL],
                        "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                        "plain_ms": k["plain_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(env.gpu_name_and_power_limit(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
