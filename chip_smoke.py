#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (ctts_tpu_torch) on one card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (each raises on failure; the exit code is nonzero on any fault):
  1. environment report (torch, CUDA, device, power limit, nvcc);
  2. build the Hopper kernels (csrc/*.cu, one nvcc per source in
     parallel) and libctts.so from source;
  3. IEEE division and sqrt on the card against numpy, bit for bit;
  4. each kernel against its plain PyTorch version on the card, at the
     serving bucket's shapes (WSOLA at speeds 1.5 and 0.5, and for one
     sentence at 1.5; compose with rows where 3 units cover one stretch
     and cf > n_eff; assemble also on adversarial region tables and at an
     output width off the 16-byte path; pitch also with every row at
     L = 220), with the kernel's device time (device_ms: calls queued
     behind a spin kernel, CUDA events) and its time as one call
     bracketed by CUDA events (time_ms, medians; it includes the host's
     enqueue, which exceeds a small kernel's run), the plain version's
     time_ms, the least time the card could take
     (bound) and, where one PyTorch call computes the same function,
     that call's device time; for WSOLA also each frame's chosen position
     against the plain chain's, the time of its decide launch alone and
     the latency floor of the frame chain (the decide launch with the
     window already in shared memory); for compose and assemble the
     time of a zero fill of their output; for pitch an empty kernel's
     launch (the launch floor); compact also at a silence table of
     NBLK_WIDE = 512 slots (the widest phase 9 runs again at) and on
     adversarial tables (unmoved, adjacent and zero-length slots, a
     segment ending at MARGIN + CONTW), each beside one torch.gather;
     the silence tables (silence_tables) on speech-like region rows at
     the default setting and the three of phase 9 that overflow the
     32-slot table, each at NBLK and NBLK_WIDE slots (no library call
     computes them); the contour and interrogative-fall zones
     (contour_zones) and region_post on the region rows of B sentences
     and of one (B = 1), each region slot of a kind: a segment of
     exactly 256 samples (the reference's 1/0 frame: NaN, compared NaN
     equal to NaN), a split question whose rise and fall abut, a row of
     exactly CONTW, factors 0.005 apart, no DSP, a fade longer than its
     row reaching back before it, an inactive question-final region,
     and the rest random (no library call computes either); these two
     update their rows in place, so each compared call takes a copy and
     the timed calls run on a row buffer of their own; the pack and wire
     encode (pack_encode) on 128 rows of 114688 and of 78976 samples
     (the buckets at 1.0 and 1.5) with the codec and, at 114688,
     without it (beside one index_select, which packs), on one row,
     and on adversarial rows (lengths 0, 1 and 2, a total at a block
     edge, B*OM not a multiple of 512, class-5 blocks), the words
     compared over the valid prefix and the classes on every block;
     unit_base and unit_contrib on the serving bucket's unit slots (a
     bank of 840 units of 7168 samples, 128 sentences of 32 slots, some
     inactive, crossfades longer than their unit, fade-ins with and
     without one, heads a refine trip changed), on one sentence, and at
     CFMAX 8192 (past the bank), a fade-in of 6615 samples (past CFMAX)
     and remove_dc off (no library call computes either);
  5. the serving path: BatchSynthesizer.stream over 3 batches of the
     16 bench texts (batch i: the texts rotated by i, 7 times over, and
     16 rows of text i, so that every batch differs and a batch
     overwritten by the next would show) at speed 1.0 and again at
     speed 1.5 (WSOLA), through the compiled core (CUDA graphs per
     signature: its first batch runs eagerly, its second is captured,
     later ones replay) as served (the wire codec on: the default on a
     CUDA device) and with wire=False, and through the eager core (the
     same BatchSynthesizer, its shards run op by op), each way twice
     (first-use set-up, then replays). Each speed shows every kernel's
     launch count, read from the profiler trace of one more served
     stream (replays alone) and equal to the wrappers' counts, every
     graph output equal to the eager one bit for bit, wire on equal to
     wire off, the outputs held to the NumPy oracle (equal lengths,
     <= 2 LSB), and the graphs captured (launches per replay per
     kernel). Then one synchronous synthesize of batch 0 at speed 0.5
     through its graph, equal to the eager one and held to the oracle.
     Then the varied stream at 1.0 and 1.5: N_VARIED batches of texts
     drawn from the corpus and the bench texts (varied_texts), so that
     buckets and batch sizes change from batch to batch, through the
     graphs and the eager core in turns (graph, eager, eager, graph),
     with the compiled core's eager / capture / replay runs per pass,
     outputs equal bit for bit and held to the oracle. A failed capture
     or replay raises. Every stream and batch of the phase runs no row
     again at a wider silence table (rows_rerun 0: the default
     configuration never overflows);
  6. the entry points: `python -m ctts_tpu_torch.cli build` of the
     generated dataset (byte-equal to phase 5's voice.db), then `synth`
     in a subprocess at speed 1.0 (no flags: the torch executor on the
     card) and 0.5 (--executor=torch --device=cuda), each WAV held to the
     oracle; the same two commands through cli.main in this process
     with their kernel launch counts, and --executor=native held to the
     oracle; then CTTSEngine.synthesize_batch over the 120-utterance
     corpus (ctts_tpu_torch/testing/corpus.py), one call per speed, every
     utterance held to the oracle, twice: the first pass (every
     signature new, so eager), the second (captures) traced for its
     launch counts and equal to the first, with no row run again; then
     tools/torch_generate_samples.py in a subprocess with no flags (the
     torch executor on the card) over the corpus: every WAV held to the
     oracle and listed on its page;
  7. multi-device: the kernel library's CUDA runtime follows the device
     that torch.cuda.device makes current, on every card, and with two
     or more cards phase 4's kernels on cuda:1 with cuda:0 current
     against their plain versions (with one card a line says this was
     not run); stream() over phase 5's batches at 1.0 and 1.5 through a
     mesh of every visible card (make_mesh()) and through [cuda:0,
     cuda:0] (two shards on one card, one graph for both), each with
     its graphs (wire on and off) and eager, beside the unsplit served
     BatchSynthesizer, each output equal to phase 5's eager stream bit
     for bit, with launch counts (from a profiler trace, as in phase 5);
     dryrun_multigpu on both meshes; two processes over gloo, both on
     cuda:0, through synthesize_across_hosts over one batch, process
     0's gather equal to the unsplit served output; the voice bundle
     saved, loaded on the card and used for one sentence, equal to
     DeviceVoice's;
  8. the one-sentence path: CTTSEngine.synthesize of each bench text at
     1.0 and 0.5 (execute_plan_torch through the compiled core, a batch
     of one row), three passes on one engine (eager, capture, replay;
     the third traced, every kernel's trace count equal to what its
     graphs recorded times their replays, K6 at 0.5 included), passes
     2-3 and the eager core equal to pass 1 bit for bit and pass 1 held
     to the oracle, with no row run again;
  9. the configuration keys: the default and each of remove_dc_offset:
     0, min_silence_ms: 0, fade_in_ms: 300, fade_out_ms: 400,
     word_pause_ms: 0 and crossfade_ms: 200 alone, and three settings
     whose regions hold more kept segments than the 32-slot silence
     table (silence_threshold 0.5 with min_silence_ms 1 and 2, 0.3 with
     1), on the speed-1.0 texts of
     tests/test_device_executor.py::CASES at 1.0 and 1.5, as one served
     batch and one sentence at a time, each through three passes (eager,
     capture, replay): replays equal to the eager pass bit for bit, the
     eager pass held to the oracle, the rows each pass ran again and the
     table widths they ran at (above 0 in the three overflow settings,
     0 in the rest), and a fourth pass of replays whose launches
     come from the profiler's trace, held to the wrappers' counts (the
     silence tables and K3 launched); min_silence_ms: 0 must be refused
     at lowering with a ValueError naming the key, on both paths.
With --kernels-only the script stops after phase 4.
The script imports nothing of the JAX package: the oracle, the voice
builder and the plan compiler are the port's own copies. The last line
is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# bench.py's serving corpus (bench.py:25-42) and the bucket floor of its
# headline section (bench.py:248-250).
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
N_VARIED = 8        # batches of the varied stream (varied_texts)
SAMPLE_RATE = 22050
LSB_BOUND = 2       # int16 bound against the oracle (tests/test_device_executor.py)

STRETCH_SPEED = 1.5  # bench.py's stretch section
SYNC_SPEED = 0.5
# The WSOLA kernels' launch counts (ops/hopper/wsola.py: the emit, and the
# decide, in a served batch one table launch over every stretch bucket):
# none at speed 1.0.
STRETCH_KERNELS = ("wsola_frames", "wsola_decide")

# Kernel shapes of the serving bucket above at batch 128.
B, U, UBUF, CFMAX = 128, 32, 7168, 1024
R, WREG, MARGIN, CONTW, SMAX = 16, 32768, 3072, 28672, 114688
FADE2W = 128        # the region tail-fade window of the default config
NSHIFT = 16
NBLK = 32
# The widest silence table the configurations of phase 9 run again at
# (plan_arrays.seg_width): K3 is also checked and timed at it.
NBLK_WIDE = 512
# The silence tables' cases of phase 4: (silence_threshold, min_silence
# samples) of the default configuration and of phase 9's three settings
# that overflow the 32-slot table, each at NBLK and NBLK_WIDE slots.
SILENCE_CASES = {"default": (0.02, 330), "0.5, 1 ms": (0.5, 22),
                 "0.5, 2 ms": (0.5, 44), "0.3, 1 ms": (0.3, 22)}
# WSOLA cases: speed, hop and output width of that bucket
# (plan_arrays._omax_for), and the sentences of kernel_inputs taken: all
# B, or the one full-length row (what execute_plan_torch runs, B = 1).
WSOLA_CASES = {"speed_1.5": (1.5, 85, 78976, slice(None)),
               "speed_0.5": (0.5, 256, 232448, slice(None)),
               "speed_1.5_B1": (1.5, 85, 78976, slice(2, 3))}
# The pack and wire encode's cases: (rows, OM, wire) of the serving
# bucket at 1.0 (OM = SMAX) and at 1.5 (WSOLA's output width), without
# the codec, and of one sentence; "pack_encode adversarial" is
# pack_adversarial's.
PACK_CASES = {"pack_encode": (B, SMAX, True),
              "pack_encode OM=78976": (B, 78976, True),
              "pack_encode wire off": (B, SMAX, False),
              "pack_encode B=1": (1, SMAX, True)}
# The unit stage's cases: (rows, CFMAX, fade_in_samples, remove_dc) of
# the serving bucket, of one sentence, and of the settings of phase 9
# that change these kernels' work: crossfade_ms: 200 (CFMAX past the
# bank's width), fade_in_ms: 300 (a fade-in past CFMAX) and
# remove_dc_offset: 0.
UNIT_CASES = {"": (B, CFMAX, 66, True), " B=1": (1, CFMAX, 66, True),
              " CFMAX=8192": (B, 8192, 66, True),
              " fade-in 6615": (B, CFMAX, 6615, True),
              " remove_dc off": (B, CFMAX, 66, False)}
N_UNITS = 840       # the generated voice's units

# Profiled runs made again when their trace lost kernel records.
TRACE_RETRIES = 2

# The card's published peaks (NVIDIA H100 SXM data sheet, at 700 W):
# HBM bytes/s, and the f32 rate outside the tensor cores, taken for the
# 32-bit integer and float work these kernels do on the CUDA cores.
HBM_BYTES_PER_S = 3.35e12
CUDA_CORE_OPS_PER_S = 67e12


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


def device_ms(fn, reps: int) -> float:
    """Milliseconds the card takes for one call of `fn`, with the host
    out of the way: a spin kernel holds the stream while `reps` calls are
    enqueued behind it, and CUDA events bracket the calls as the card
    runs them back to back. time_ms() of a small kernel measures the
    host's enqueue instead (an empty launch takes tens of microseconds
    there). Raises if the spin ended before the enqueue did."""
    import torch

    fn()
    torch.cuda.synchronize()
    cycles = 20_000_000
    for _ in range(6):
        s = torch.cuda.Event(enable_timing=True)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        s.record()
        torch.cuda._sleep(cycles)
        a.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        b.record()
        b.synchronize()
        if s.elapsed_time(a) > 1.2 * enqueue_ms:
            return a.elapsed_time(b) / reps
        cycles *= 4
    raise RuntimeError("device_ms: the spin never outlasted the enqueue")


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


def pack_rows_of(np, rng, nb: int, om: int):
    """nb rows of om int16 samples with speech-like valid prefixes (a
    random walk) of 20000-60000 samples (at most om); rows 0-2 of length
    0, 1 and 2 where nb > 3; a class-5 pair of samples (32767, -32768)
    ending a row; random samples past each length (they must not
    leak)."""
    lens = np.minimum(rng.integers(20000, 60001, nb), om).astype(np.int32)
    if nb > 3:
        lens[:3] = (0, 1, 2)
    out = rng.integers(-32768, 32768, (nb, om)).astype(np.int16)
    for b in range(nb):
        n = int(lens[b])
        walk = np.cumsum(rng.integers(-900, 901, n))
        out[b, :n] = np.clip(walk, -32768, 32767)
    k = int(np.argmax(lens))
    out[k, lens[k] - 2:lens[k]] = (32767, -32768)
    return out, lens


def pack_adversarial(np, rng):
    """Rows of length 0, 1, 2 and the rest, whose total is 1024 (a
    block edge: the block after it holds the last samples' residuals),
    B*OM = 5000 (not a multiple of 512, and thread blocks past the
    total), the samples int16 extremes (class-5 blocks)."""
    lens = np.array([0, 1, 2, 1021, 0], np.int32)
    out = rng.choice(np.array([-32768, 32767, -1, 0, 1], np.int16),
                     (5, 1000))
    out[3, 400:900] = rng.integers(-3, 4, 500)
    return out, lens


def unit_bank(np, rng):
    """A voice bank as the generated voice's: N_UNITS units of UBUF
    int16-valued f32 samples, zeros past each length (200-UBUF, a few of
    0, 1 and under CFMAX), gains 0.1-3."""
    lengths = rng.integers(200, UBUF + 1, N_UNITS).astype(np.int32)
    lengths[:4] = (0, 1, CFMAX - 3, UBUF)
    bank = rng.integers(-32768, 32768, (N_UNITS, UBUF)).astype(np.float32)
    bank[np.arange(UBUF)[None, :] >= lengths[:, None]] = 0.0
    gains = rng.uniform(0.1, 3.0, N_UNITS).astype(np.float32)
    return bank, gains, lengths


def unit_slots(np, rng, lengths, nb: int, cfmax: int, fis: int) -> dict:
    """The unit slots of nb sentences: ~15% inactive (-1), crossfades
    0-cfmax (some longer than their unit), ~30% fade-ins (some with a
    crossfade), and the batch's distinct-value tables."""
    from types import SimpleNamespace

    from ctts_tpu_torch.synth.plan_arrays import shared_plan_values

    unit_id = rng.integers(0, N_UNITS, (nb, U)).astype(np.int32)
    unit_id[rng.random((nb, U)) < 0.15] = -1
    unit_id[0, :5] = (-1, 0, 1, 2, 3)
    cf_in = rng.integers(0, cfmax + 1, (nb, U)).astype(np.int32)
    cf_in[0, 5:8] = (0, cfmax, 1)
    fade_in = rng.random((nb, U)) < 0.3
    fade_in[0, 5:7] = True
    shared = shared_plan_values(
        {"unit_cf_in": cf_in, "unit_id": unit_id}, lengths,
        SimpleNamespace(fade_in_samples=fis))
    return dict(unit_id=unit_id, cf_in=cf_in, fade_in=fade_in, **shared)


def pack_bound(np, lens, om: int, classes) -> dict:
    """The pack and encode's least work: the valid samples read once,
    the row lengths read once, and the packed samples (wire off:
    classes None) or the words of the valid prefix and the classes
    written once; 7 operations a valid sample (the residual, the
    zigzag, the max) and 4 a nibble of a written word."""
    total = int(np.clip(lens, 0, om).sum())
    if classes is None:
        return dict(bound(4 * total + lens.nbytes, 0.0), valid=total)
    words = 64 * int(classes[:-(-total // 512)].sum())
    return dict(bound(2 * total + lens.nbytes + 4 * words + classes.nbytes,
                      7.0 * total + 32.0 * words),
                valid=total, valid_words=words)


def slot_lengths(np, bank_lengths, unit_id):
    return np.where(unit_id >= 0,
                    bank_lengths[np.maximum(unit_id, 0)], 0).astype(np.int64)


def unit_base_bound(np, lengths, slots: dict, cfmax: int, hw: int,
                    remove_dc: bool) -> dict:
    """unit_base's least work: each distinct unit's bank columns it
    needs (the head columns, and the body where remove_dc sums it) read
    once, heads, hcols, fo and fi written once; ~20 operations a head
    column (the product, q16, and both curves' t and LUT lerp), 5 a
    summed body column."""
    uid = slots["unit_id"]
    units = uid.size
    used = np.unique(np.maximum(uid, 0))
    n = np.minimum(lengths[used].astype(np.int64), UBUF)
    cols = np.maximum(np.minimum(hw, UBUF), n if remove_dc else 0)
    body = slot_lengths(np, lengths, uid) - cfmax
    nbytes = (4 * int(cols.sum()) + 4 * (3 * units * cfmax + units * hw)
              + 4 * units + 3 * uid.nbytes)
    ops = 20.0 * units * cfmax + (5.0 * np.clip(body, 0, None).sum()
                                  if remove_dc else 0.0)
    return bound(nbytes, ops)


def unit_contrib_bound(np, lengths, slots: dict, cfmax: int) -> dict:
    """unit_contrib's least work: contrib [B, U, W] written once; each
    slot's live head columns and, where it mixes, its crossfade curve
    read once; each distinct unit's live body columns read once; 4
    operations a live column (DC shift, clamp, mask), 4 more a body
    column (the product and q16), 10 more a faded one."""
    uid = slots["unit_id"]
    units = uid.size
    W = max(UBUF, cfmax)
    n = slot_lengths(np, lengths, uid)
    head = np.minimum(n, cfmax)
    mix = np.where(~slots["fade_in"], np.minimum(slots["cf_in"], head), 0)
    used = np.unique(np.maximum(uid[uid >= 0], 0))
    body = np.clip(np.minimum(lengths[used], UBUF) - cfmax, 0, None)
    fade = np.where(slots["fade_in"], np.minimum(n, slots["fis"]), 0)
    nbytes = (4 * units * W + 4 * int(head.sum() + mix.sum() + body.sum())
              + 4 * 5 * units)
    ops = (4.0 * n.sum() + 4.0 * np.clip(n - cfmax, 0, None).sum()
           + 10.0 * fade.sum())
    return bound(nbytes, ops)


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
    # Rows 0-3: units 0-2 all cover [off0 + 600, off0 + 4000), and unit
    # 4's crossfade is longer than the unit.
    base_off[:4, 1] = base_off[:4, 0] + 300
    base_off[:4, 2] = base_off[:4, 0] + 600
    n_eff[:4, :3] = 4000
    n_eff[:4, 4] = 600
    cf_in[:4, 4] = 1000
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
    ins["compact_wide"] = wide_tables(np, rng)
    # Generators of their own, so that the other cases keep their inputs.
    ins["compact_adversarial"] = adversarial_tables(
        np, np.random.default_rng(6))
    ins["silence"] = silence_rows(np, np.random.default_rng(5))
    ins["regions"] = region_arrays(np, np.random.default_rng(8), B)
    ins["regions B=1"] = region_arrays(np, np.random.default_rng(9), 1)
    prng = np.random.default_rng(10)
    rows = {(nb, om): pack_rows_of(np, prng, nb, om)
            for nb, om, _ in sorted(set(PACK_CASES.values()))}
    ins["pack"] = {name: rows[(nb, om)]
                   for name, (nb, om, _) in PACK_CASES.items()}
    ins["pack"]["pack_encode adversarial"] = pack_adversarial(np, prng)
    urng = np.random.default_rng(11)
    ins["bank"] = unit_bank(np, urng)
    ins["units"] = {tag: dict(unit_slots(np, urng, ins["bank"][2], nb, cf,
                                         fis), fis=fis)
                    for tag, (nb, cf, fis, _) in UNIT_CASES.items()}

    # assemble: cumsum offsets of active regions, margin overlap.
    active = rng.random((B, R)) < 0.8
    new_lens = np.where(active, rng.integers(0, 5000, (B, R)), 0)
    pauses = np.where(active, rng.integers(0, 2000, (B, R)), 0)
    seg_tot = new_lens + pauses
    offsets = (np.cumsum(seg_tot, 1) - seg_tot).astype(np.int32)
    live = np.where(active, MARGIN + new_lens, 0).astype(np.int32)
    ins["assemble"] = (bufs, offsets, live)
    # A generator of its own, so that the other cases keep their inputs.
    ins["assemble_adversarial"] = assemble_adversarial(
        np, np.random.default_rng(4), offsets, live)

    # wsola: int16-valued sentences (tonal, noise, periodic near-ties as
    # in tests/test_pallas_wsola.py), ragged lengths: one empty row, one
    # below a frame, one full row.
    t = np.arange(SMAX, dtype=np.float32)
    kinds = [
        lambda: (6000 * np.sin(2 * np.pi * 137.3 * t / SAMPLE_RATE)
                 + 2500 * np.sin(2 * np.pi * 291.7 * t / SAMPLE_RATE)
                 + rng.normal(0, 300, SMAX)),
        lambda: rng.normal(0, 5000, SMAX),
        lambda: 8000 * np.sin(2 * np.pi * 128 * t / SAMPLE_RATE),
    ]
    sent = np.stack([np.trunc(np.clip(kinds[b % 3](), -32768, 32767))
                     for b in range(B)]).astype(np.float32)
    counts = rng.integers(512, SMAX + 1, B).astype(np.int32)
    counts[:3] = (0, 300, SMAX)
    sent[np.arange(SMAX)[None, :] >= counts[:, None]] = 0.0
    ins["wsola"] = (sent, counts)
    return ins


def wide_tables(np, rng):
    """Kept-segment tables of NBLK_WIDE slots, as silence removal makes
    them: 256-512 segments a region of 1-39 samples, 0-15 apart,
    ascending, destinations packed from MARGIN; unused slots have length
    0 and the next free destination."""
    shape = (B, R, NBLK_WIDE)
    count = rng.integers(NBLK_WIDE // 2, NBLK_WIDE + 1, (B, R, 1))
    used = np.arange(NBLK_WIDE)[None, None, :] < count
    seg_len = np.where(used, rng.integers(1, 40, shape), 0)
    gap = rng.integers(0, 16, shape)
    dst = MARGIN + np.cumsum(seg_len, 2) - seg_len
    starts = np.where(used, dst + np.cumsum(gap, 2), 0)
    assert int((starts + seg_len).max()) <= MARGIN + CONTW
    return tuple(x.astype(np.int32) for x in (starts, dst, seg_len))


def adversarial_tables(np, rng):
    """Kept-segment tables of NBLK slots that hold silence removal's
    invariants at their edges, four kinds of row in turn: segments that
    do not move (starts == dst) before moving ones; zero-length slots
    between used ones; adjacent segments (no gap) with the last one
    ending at MARGIN + CONTW; every slot used by segments of 1-3
    samples."""
    shape = (B, R, NBLK)
    starts, dst, seg_len = (np.zeros(shape, np.int32) for _ in range(3))
    for b in range(B):
        for r in range(R):
            kind = (b * R + r) % 4
            pos = out = MARGIN
            k = 0
            while k < NBLK:
                if kind == 1 and k % 3 == 1:      # a zero-length slot
                    starts[b, r, k] = int(rng.integers(0, MARGIN + CONTW))
                    dst[b, r, k] = out
                    k += 1
                    continue
                gap = (0 if (kind == 0 and k < 3) or kind == 2
                       else int(rng.integers(0, 600)))
                ln = (int(rng.integers(1, 4)) if kind == 3
                      else int(rng.integers(1, 2000)))
                if kind == 2 and k == 0:
                    gap = int(rng.integers(1, 400))
                last = pos + gap + ln >= MARGIN + CONTW
                if kind == 2 and (last or k == NBLK - 1):
                    ln = MARGIN + CONTW - pos - gap
                elif last:
                    break
                pos += gap
                starts[b, r, k], dst[b, r, k], seg_len[b, r, k] = pos, out, ln
                pos += ln
                out += ln
                k += 1
                if pos >= MARGIN + CONTW:
                    break
            dst[b, r, k:] = out
    assert int((starts + seg_len).max()) == MARGIN + CONTW
    return starts, dst, seg_len


def silence_rows(np, rng):
    """Region rows of speech-like content for the silence tables, at the
    serving bucket: voiced stretches (two partials and noise, 2000-12000
    peak) between silences of 1-2000 samples of low noise, each region
    of a random length up to CONTW; every 7th region empty, every 11th
    all zero, every 5th not removed, every 13th of length CONTW. Returns
    (bufs [B, R*WREG] f32, region_len [B, R] i32, region_remove [B, R]
    bool)."""
    bufs = np.zeros((B, R * WREG), np.float32)
    lens = rng.integers(1, CONTW + 1, (B, R)).astype(np.int32)
    k = np.arange(B * R).reshape(B, R)
    lens[k % 13 == 0] = CONTW
    lens[k % 7 == 0] = 0
    remove = k % 5 != 0
    t = np.arange(CONTW, dtype=np.float32)
    for b in range(B):
        for r in range(R):
            n = int(lens[b, r])
            if n == 0 or k[b, r] % 11 == 0:
                continue
            x = rng.normal(0, 8, n)
            pos = 0
            while pos < n:
                ln = int(rng.integers(200, 3000))
                f0 = rng.uniform(80, 300)
                seg = t[:min(ln, n - pos)]
                x[pos:pos + ln] += rng.uniform(2000, 12000) * (
                    np.sin(2 * np.pi * f0 * seg / SAMPLE_RATE)
                    + 0.4 * np.sin(2 * np.pi * 2.7 * f0 * seg / SAMPLE_RATE))
                x[pos:pos + ln] += rng.normal(0, 300, seg.shape[0])
                pos += ln + int(rng.integers(1, 2000))
            o = r * WREG + MARGIN
            bufs[b, o:o + n] = np.trunc(np.clip(x, -32768, 32767))
    return bufs, lens, remove


def region_arrays(np, rng, nb: int) -> dict:
    """The region arrays contour_zones and region_post read, for nb
    sentences of the serving bucket: lengths after silence removal
    (500-9000 samples, a sentence's sum at most SMAX, the lowering's
    bound), pitch factors 0.9-1.1, energy factors 0.7-1.4, ~80% DSP,
    ~25% question-final and ~90% active regions, ~50% energy ramps,
    fades of 0-FADE2W samples and each region's offset in its sentence
    (pauses of 0-3000 samples). Region slots 0-6 hold the adversarial
    kinds of phase 4 in every sentence."""
    shape = (nb, R)
    cnt = rng.integers(500, 9000, shape).astype(np.int64)
    c = rng.uniform(0.9, 1.1, shape + (5,)).astype(np.float32)
    c[..., 3:] = rng.uniform(0.7, 1.4, shape + (2,))
    qfinal = rng.random(shape) < 0.25
    do_dsp = rng.random(shape) < 0.8
    active = rng.random(shape) < 0.9
    energy = rng.random(shape) < 0.5
    fade_after = rng.integers(0, FADE2W + 1, shape).astype(np.int32)
    # 0: a segment of exactly 256 samples with a pitch change (NaN).
    cnt[:, 0], qfinal[:, 0], do_dsp[:, 0] = 256, False, True
    c[:, 0, :2] = (0.95, 1.05)
    # 1, 2: split questions, rise 1800 and fall 1200 abutting, and a row
    # of exactly CONTW.
    cnt[:, 1], cnt[:, 2] = 3000, CONTW
    for k in (1, 2):
        qfinal[:, k] = do_dsp[:, k] = active[:, k] = True
    # 3: factors 0.005 apart (inactive); 4: no DSP on a question-final
    # region; 5: a fade longer than its row, reaching back before it; 6:
    # an inactive question-final region (its rise alone).
    c[:, 3, 1] = c[:, 3, 0] + np.float32(0.005)
    qfinal[:, 3], do_dsp[:, 3] = False, True
    do_dsp[:, 4], qfinal[:, 4] = False, True
    cnt[:, 5], fade_after[:, 5] = 80, FADE2W
    active[:, 6], qfinal[:, 6], do_dsp[:, 6] = False, True, True
    for b in range(nb):
        while cnt[b].sum() > SMAX:
            k = 7 + int(np.argmax(cnt[b, 7:]))
            cnt[b, k] //= 2
    seg = cnt + rng.integers(0, 3000, shape)
    return {"cnt": cnt, "contour": c, "qfinal": qfinal, "do_dsp": do_dsp,
            "active": active, "energy": energy, "fade_after": fade_after,
            "offsets": (np.cumsum(seg, 1) - seg).astype(np.int64)}


def contour_bound(np, reg: dict) -> dict:
    """The contour zones' least work: every sample of a segment that runs
    a frame (n >= 256 and factors 0.01 or more apart) read once and
    written once, the region arrays read once; ~30 operations a sample
    (two frame samples of ~10: the resample index, the lerp, the Hann
    product; the OLA sum, its int16 wrap, the division and q16)."""
    cnt, c = reg["cnt"], reg["contour"]
    rise = (cnt.astype(np.float32) * np.float32(0.6)).astype(np.int64)
    split = (rise > 100) & (cnt - rise > 100)
    split1 = reg["qfinal"] & split
    n = 0
    for count, fs, fe in (
            (np.where(reg["do_dsp"], np.where(split1, rise, cnt), 0),
             c[..., 0], np.where(split1, c[..., 2], c[..., 1])),
            (np.where(reg["qfinal"] & reg["do_dsp"] & reg["active"] & split,
                      cnt - rise, 0), c[..., 2], c[..., 1])):
        run = (count >= 256) & (np.abs(fs - fe) >= np.float32(0.01))
        n += int(np.where(run, count, 0).sum())
    rows = cnt.size
    nbytes = 8 * n + rows * (8 + 20 + 3) + 4 * 256
    return dict(bound(nbytes, 30.0 * n), live_samples=n)


def region_post_bound(np, reg: dict) -> dict:
    """region_post's least work: every ramped or faded sample read once
    and written once, the region arrays read once; 7 operations a
    ramped sample (the division, the factor, the product, q16) and 11 a
    faded one (t, the LUT index and lerp, the product, trunc)."""
    cnt = reg["cnt"]
    ramp_end = np.where(reg["do_dsp"] & reg["energy"] & (cnt >= 100),
                        np.minimum(cnt, CONTW), 0)
    fade = np.minimum(reg["fade_after"].astype(np.int64),
                      cnt + reg["offsets"])
    on = fade > 0
    lo = np.maximum(cnt - fade, np.maximum(cnt - FADE2W, 0))
    end = np.where(on, np.minimum(cnt, CONTW), 0)
    fade_n = np.where(on, np.clip(end - lo, 0, None), 0)
    overlap = np.where(on, np.clip(np.minimum(ramp_end, end)
                                   - np.maximum(lo, 0), 0, None), 0)
    touched = int((ramp_end + fade_n - np.minimum(overlap, fade_n)).sum())
    nbytes = 8 * touched + cnt.size * (8 + 8 + 20 + 2 + 4) + 4 * 1024
    return dict(bound(nbytes, 7.0 * ramp_end.sum() + 11.0 * fade_n.sum()),
                live_samples=touched)


def source_index(np, starts, dst, seg_len):
    """[B, R*WREG] int64: the input position whose sample the compaction
    of these tables puts at each position (K3's library yardstick, one
    gather)."""
    src = np.tile(np.arange(R * WREG, dtype=np.int64), (B, 1))
    b, r, k = np.nonzero(seg_len)
    n = seg_len[b, r, k].astype(np.int64)
    seg = np.repeat(np.arange(n.size), n)
    at = np.arange(seg.size) - (np.cumsum(n) - n)[seg]
    src[b[seg], r[seg] * WREG + dst[b, r, k][seg] + at] = \
        r[seg] * WREG + starts[b, r, k][seg] + at
    return src


def assemble_adversarial(np, rng, offsets, live):
    """Region tables that break the plan's invariants, four kinds of row
    in turn: 3 regions covering one stretch; a live length past WREG; a
    region that runs past the output's end; inactive (0 or negative) and
    zero-length (MARGIN only) regions between active ones."""
    OUTW = MARGIN + SMAX
    offsets, live = offsets.copy(), live.copy()
    for b in range(B):
        kind = b % 4
        o = int(rng.integers(0, 60000))
        if kind == 0:
            offsets[b, 3:6] = (o, o + 300, o + 600)
            live[b, 3:6] = (4000, 5000, 6000)
        elif kind == 1:
            live[b, 2] = WREG + int(rng.integers(1, 9000))
            live[b, 7] = 2 * WREG
        elif kind == 2:
            offsets[b, R - 1] = OUTW - int(rng.integers(1, 3000))
            live[b, R - 1] = WREG
        else:
            live[b, 1:R - 1:2] = (0, -7, MARGIN, 0, MARGIN, -1, 0)  # R = 16
    return offsets, live


def bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take: the larger of the bytes over
    the HBM rate and the operations over the CUDA-core rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / CUDA_CORE_OPS_PER_S * 1e3
    return {"bound_ms": float(max(t_bytes, t_ops)),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": int(nbytes), "ops": float(ops)}


def pitch_ops(np, ana):
    """Operations pitch_corr needs on these inputs, per row of analysis
    length L > 0: corr, 276 lags x L multiply-adds; e2 from a prefix sum
    of the L + 275 squares it reads (a multiply and an add each), one
    subtraction per lag."""
    L = np.clip(ana, 0, 220).astype(np.int64)
    return float((2 * 276 * L + np.where(L > 0, 2 * (L + 275) + 276, 0))
                 .sum())


def pitch_conv(torch, seg, ana):
    """K2's library yardstick: one f64 grouped conv1d over the channels
    [s, s^2] of each row with the weights [masked s[:220], mask] gives
    corr and e2 exactly (int16 products, every partial sum an integer
    below 2^53), rounded once to f32. The inputs are set up here; the
    returned function makes the one call."""
    n = seg.shape[0]
    s64 = seg.to(torch.float64)
    m64 = (torch.arange(220, device=seg.device)[None, :]
           < ana.clamp(0, 220)[:, None]).to(torch.float64)
    x = torch.stack([s64, s64 * s64], 1).reshape(1, 2 * n, -1)
    w = torch.stack([s64[:, :220] * m64, m64], 1).reshape(2 * n, 1, 220)

    def call():
        y = torch.nn.functional.conv1d(x, w, groups=2 * n)
        y = y.reshape(n, 2, -1).to(torch.float32)
        return y[:, 0], y[:, 1]

    return call


def wsola_ops(searched, nrun):
    """Operations the WSOLA chain needs on these inputs: 384 multiply-
    adds for each valid coarse and fine candidate its frames evaluate
    (counted by the plain version), and for every frame 512 window
    multiplies and 2 x 512 OLA adds."""
    from ctts_tpu_torch.ops.wsola import FRAME, OVERLAP

    return float((searched["coarse"] + searched["fine"]) * 2 * OVERLAP
                 + int(nrun.sum()) * 3 * FRAME)


def kernel_tensors(torch, ins, dev) -> dict:
    """Phase 4's inputs on `dev`, and the WSOLA cases' energy tables and
    run counts."""
    from ctts_tpu_torch.ops import wsola as tw

    def on(*xs):
        return [torch.as_tensor(x, device=dev) for x in xs]

    t = {}
    t["seg"], t["ana"] = on(*ins["pitch"])
    t["ana220"] = torch.full_like(t["ana"], 220)   # every row at L = 220
    (t["contrib"], t["fo"], t["base_off"], t["cf_in"], t["n_eff"],
     t["a_c"]) = on(*ins["compose"])
    t["bufs"], t["starts"], t["dst"], t["seg_len"] = on(*ins["compact"])
    t["wide_tables"] = on(*ins["compact_wide"])
    t["adv_tables"] = on(*ins["compact_adversarial"])
    t["sil_bufs"], t["region_len"], t["remove"] = on(*ins["silence"])
    for tag in ("regions", "regions B=1"):
        t[tag] = {k: torch.as_tensor(v, device=dev)
                  for k, v in ins[tag].items()}
    _, t["offsets"], t["live"] = on(*ins["assemble"])
    t["adv_offsets"], t["adv_live"] = on(*ins["assemble_adversarial"])
    for tag, (speed, hop, out_size, rows) in WSOLA_CASES.items():
        sent, counts = on(*(x[rows] for x in ins["wsola"]))
        t[tag] = (sent, tw.energy_table(sent), counts,
                  tw.run_counts(counts, SMAX, out_size, hop))
    t["pack"] = {name: on(*x) for name, x in ins["pack"].items()}
    t["bank"] = on(*ins["bank"])
    t["units"] = {tag: unit_state(torch, t["bank"], on, ins["units"][tag],
                                  *UNIT_CASES[tag][1:])
                  for tag in UNIT_CASES}
    return t


def unit_state(torch, bank, on, slots: dict, cfmax: int, fis: int,
               remove_dc: bool) -> dict:
    """A unit case's slots on the device with what unit_contrib reads:
    unit_base's plain tail_total and fi, and heads as a refine trip
    leaves them (every other slot's head replaced by other int16
    values)."""
    from ctts_tpu_torch.ops.hopper import units

    u = {k: (on(v)[0] if hasattr(v, "shape") else v)
         for k, v in slots.items()}
    _, hw = units.widths(UBUF, cfmax, 495)
    heads, _, u["tail_total"], _, u["fi"] = units.unit_base_plain(
        *bank, u["unit_id"], u["cf_in"], u["cf_values"], cfmax, hw,
        remove_dc)
    g = torch.Generator(device=heads.device).manual_seed(12)
    other = torch.randint(-32768, 32768, heads.shape, generator=g,
                          device=heads.device).to(torch.float32)
    u["heads"] = torch.where(
        (torch.arange(heads.shape[1], device=heads.device) % 2 == 1)
        [None, :, None], other, heads).contiguous()
    u["hw"] = hw
    return u


def silence_case(tag: str, nblk: int) -> str:
    """Phase 4's name of a silence-table case (the default at NBLK is the
    kernel's own line)."""
    if tag == "default" and nblk == NBLK:
        return "silence_tables"
    return f"silence_tables {tag} NBLK={nblk}"


def silence_bound(np, lens, remove, nblk: int) -> dict:
    """The silence tables' least work: the live samples of every removed
    region read once (the kernel reads them twice: the max, then the
    runs), the region tables read once and the tables written once; 3
    operations a live sample (|x|, the max, the compare)."""
    live = np.where(remove, np.clip(lens, 0, CONTW), 0).astype(np.int64)
    n = int(live.sum())
    nbytes = (4 * n + lens.nbytes + remove.nbytes + 4 * B
              + 3 * 4 * B * R * nblk + 8 * B * R + 4 * B)
    return dict(bound(nbytes, 3.0 * n), live_samples=n)


def kernel_cases(hopper, t) -> dict:
    """Phase 4's calls on the tensors `t`: name -> (kernel call, plain
    call, kernel reps, plain reps[, timed call]). A kernel that updates
    its input in place is compared on copies and timed on a buffer of
    its own (the timed call)."""
    from ctts_tpu_torch.ops import wsola as tw

    TOT, OUTW = R * WREG, MARGIN + SMAX
    # An output width that is not a multiple of 4: the scalar path.
    OUTW_ODD = OUTW - 2
    import torch

    pitch, compose, compact, assemble, silence = (
        hopper.pitch, hopper.compose, hopper.compact, hopper.assemble,
        hopper.silence)
    cp = (t["contrib"], t["fo"], t["base_off"], t["cf_in"], t["n_eff"],
          t["a_c"], TOT, True)
    cm = (t["bufs"], t["starts"], t["dst"], t["seg_len"], WREG)
    cw = (t["bufs"], *t["wide_tables"], WREG)
    ca = (t["bufs"], *t["adv_tables"], WREG)
    cases = {
        "pitch_corr": (lambda: pitch.pitch_corr(t["seg"], t["ana"]),
                       lambda: pitch.pitch_corr_plain(t["seg"], t["ana"]),
                       20, 5),
        "pitch_corr L=220": (
            lambda: pitch.pitch_corr(t["seg"], t["ana220"]),
            lambda: pitch.pitch_corr_plain(t["seg"], t["ana220"]), 20, 5),
        "compose": (lambda: compose.compose(*cp),
                    lambda: compose.compose_plain(*cp), 10, 3),
        "compact": (lambda: compact.compact(*cm),
                    lambda: compact.compact_plain(*cm), 20, 3),
        f"compact NBLK={NBLK_WIDE}": (
            lambda: compact.compact(*cw),
            lambda: compact.compact_plain(*cw), 20, 3),
        "compact adversarial": (
            lambda: compact.compact(*ca),
            lambda: compact.compact_plain(*ca), 20, 3),
    }
    for tag, (thr, ms) in SILENCE_CASES.items():
        for nblk in (NBLK, NBLK_WIDE):
            args = (t["sil_bufs"], t["region_len"], t["remove"],
                    torch.full((B,), thr, device=t["sil_bufs"].device),
                    ms, nblk, MARGIN, CONTW)
            cases[silence_case(tag, nblk)] = (
                lambda args=args: silence.silence_tables(*args),
                lambda args=args: silence.silence_tables_plain(*args),
                20, 3)
    rows = t["bufs"].reshape(B, R, WREG)
    for tag, part in (("", rows), (" B=1", rows[:1])):
        reg = t[f"regions{tag}"]
        zc = (reg["cnt"], reg["contour"], reg["qfinal"], reg["do_dsp"],
              reg["active"], MARGIN, SMAX)
        zp = (reg["cnt"], reg["offsets"], reg["contour"], reg["do_dsp"],
              reg["energy"], reg["fade_after"], MARGIN, CONTW, FADE2W)
        for name, mod, kern, plain, args in (
                ("contour_zones", hopper.contour, "contour_zones",
                 "contour_plain", zc),
                ("region_post", hopper.region_post, "region_post",
                 "region_post_plain", zp)):
            k, p = getattr(mod, kern), getattr(mod, plain)
            cases[name + tag] = (
                lambda k=k, part=part, args=args: k(part.clone(), *args),
                lambda p=p, part=part, args=args: p(part.clone(), *args),
                20, 3,
                lambda k=k, work=part.clone(), args=args: k(work, *args))
    for tag, offs, live, outw in (
            ("assemble", "offsets", "live", OUTW),
            ("assemble adversarial", "adv_offsets", "adv_live", OUTW),
            ("assemble scalar path", "offsets", "live", OUTW_ODD)):
        args = (t["bufs"], t[offs], t[live], WREG, outw)
        cases[tag] = (lambda args=args: assemble.assemble(*args),
                      lambda args=args: assemble.assemble_plain(*args),
                      20, 3)

    def with_choices(fn, args):
        def call():
            ch = {}
            acc, norm = fn(*args, choices=ch)
            return acc, norm, ch["pos"]
        return call

    for tag, (speed, hop, out_size, rows) in WSOLA_CASES.items():
        args = t[tag] + (hop, out_size)
        cases[f"wsola_frames {tag}"] = (
            with_choices(hopper.wsola.wsola_frames, args),
            with_choices(tw.wsola_frames_plain, args), 10, 3)
    pe = hopper.pack_encode
    for name, (out, lens) in t["pack"].items():
        wire = PACK_CASES.get(name, (0, 0, True))[2]
        args = (out, lens, wire)
        cases[name] = (defined_prefix(pe.pack_encode, args),
                       defined_prefix(pe.pack_encode_plain, args), 20, 3,
                       lambda args=args: pe.pack_encode(*args),
                       lambda args=args: pe.pack_encode_plain(*args))
    un = hopper.units
    for tag, (_, cfmax, fis, remove_dc) in UNIT_CASES.items():
        u = t["units"][tag]
        ub = (*t["bank"], u["unit_id"], u["cf_in"], u["cf_values"], cfmax,
              u["hw"], remove_dc)
        cases["unit_base" + tag] = (lambda ub=ub: un.unit_base(*ub),
                                    lambda ub=ub: un.unit_base_plain(*ub),
                                    20, 3)
        uc = (u["heads"], *t["bank"], u["unit_id"], u["cf_in"],
              u["fade_in"], u["tail_total"], u["fi"], u["fade_values"], fis,
              remove_dc)
        cases["unit_contrib" + tag] = (
            lambda uc=uc: un.unit_contrib(*uc),
            lambda uc=uc: un.unit_contrib_plain(*uc), 20, 3)
    return cases


def defined_prefix(fn, args):
    """A call of pack_encode (or its plain version) that returns what is
    defined: the packed valid prefix, or the words of the valid prefix
    and the classes of every block."""
    from ctts_tpu_torch.ops import wire as wire_codec

    out, lens, wire = args

    def call():
        payload, classes = fn(*args)
        total = int(lens.sum())
        if not wire:
            return (payload[:total],)
        n = wire_codec.wire_valid_words(classes.cpu().numpy(), total)
        return payload[:n], classes
    return call


def compare(torch, kern, plain) -> tuple:
    """(equal, max abs error) of a kernel call and its plain one: equal
    values, NaN equal to NaN (a contour segment of 256 samples is NaN in
    both), and the largest difference where neither is NaN."""
    got, want = kern(), plain()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    torch.cuda.synchronize(got[0].device)

    def same(g, w):
        if not g.is_floating_point():
            return torch.equal(g, w)
        return (torch.equal(g.isnan(), w.isnan())
                and torch.equal(g.nan_to_num(), w.nan_to_num()))

    equal = all(same(g, w) for g, w in zip(got, want))
    err = max(float((g - w).nan_to_num().abs().max())
              for g, w in zip(got, want))
    return equal, err, got


def check_kernels(torch, np, hopper) -> dict:
    """Kernel vs plain version on the card: equal bits, both times, the
    bound and the library call's time."""
    from ctts_tpu_torch.ops import wsola as tw

    dev = torch.device("cuda")
    ins = kernel_inputs(np)
    t = kernel_tensors(torch, ins, dev)
    seg, ana, bufs = t["seg"], t["ana"], t["bufs"]
    TOT, OUTW = R * WREG, MARGIN + SMAX
    OUTW_ODD = OUTW - 2

    # Work each function needs on these inputs (each input read once,
    # each output written once; see bound()). An empty kernel's launch
    # is the floor beside the pitch kernel, whose bound is below it.
    launch_floor = {"host_ms": time_ms(hopper.build.empty_launch, 50),
                    "ms": device_ms(hopper.build.empty_launch, 200)}
    pitch_bytes = seg.nbytes + ana.nbytes + 2 * seg.shape[0] * 276 * 4
    pitch_work = bound(pitch_bytes, pitch_ops(np, ins["pitch"][1]))
    pitch220_work = bound(pitch_bytes,
                          pitch_ops(np, np.full(seg.shape[0], 220)))
    for w in (pitch_work, pitch220_work):
        w["launch_floor_ms"] = launch_floor["ms"]
        w["launch_floor_host_ms"] = launch_floor["host_ms"]
    ne = ins["compose"][4].astype(np.int64)
    cf = np.minimum(ins["compose"][3], ne).astype(np.int64)
    compose_work = bound(
        4 * (ne.sum() + cf.sum()) + 4 * 4 * B * U
        + 4 * (B * TOT + B * U * (512 + CFMAX)), float(2 * cf.sum()))
    # The buffer's write alone: a zero fill of its bytes (context for
    # compose, whose bound is mostly this write).
    fill = torch.empty(B, TOT, dtype=torch.float32, device=dev)
    compose_work["zero_fill_ms"] = device_ms(fill.zero_, 20)
    del fill
    compact_work = bound(2 * bufs.nbytes + 3 * t["starts"].nbytes, 0.0)
    wide_work = bound(2 * bufs.nbytes + 3 * t["wide_tables"][0].nbytes,
                      0.0)
    adv_work = bound(2 * bufs.nbytes + 3 * t["adv_tables"][0].nbytes, 0.0)
    # The int64 starts and ends _first_flagged made for the silence
    # tables of B*R regions at this width (the plain version's).
    wide_work["first_flagged_int64_bytes_each"] = 8 * B * R * (NBLK_WIDE
                                                               + 1)

    def assemble_bound(offs, lv, outw):
        """The live samples that land in [0, outw), read once and added
        once, the tables, and the output written once."""
        lv = np.clip(np.minimum(lv, WREG), 0, None).astype(np.int64)
        n = np.clip(np.minimum(offs + lv, outw) - offs, 0, None).sum()
        return bound(4 * n + 2 * offs.nbytes + 4 * B * outw, float(n))

    assemble_work = assemble_bound(*ins["assemble"][1:], OUTW)
    asm_adv_work = assemble_bound(*ins["assemble_adversarial"], OUTW)
    odd_work = assemble_bound(*ins["assemble"][1:], OUTW_ODD)
    # The output's write alone: a zero fill of its bytes.
    fill = torch.empty(B, OUTW, dtype=torch.float32, device=dev)
    assemble_work["zero_fill_ms"] = device_ms(fill.zero_, 20)
    del fill

    # Library yardsticks (timed here, never called by the port).
    # compact: one gather with the source index of every position.
    compact_idx = torch.as_tensor(source_index(np, *ins["compact"][1:]),
                                  device=dev)
    wide_idx = torch.as_tensor(source_index(np, *ins["compact_wide"]),
                               device=dev)
    adv_idx = torch.as_tensor(
        source_index(np, *ins["compact_adversarial"]), device=dev)
    # assemble: one index_add of every live sample at its output slot
    # (each dead sample goes to a dropped slot of its own, so no slot
    # draws contended atomics; <= 2 adds land on a live slot, so the
    # atomics' order cannot change the f32 sums).
    jw = np.arange(WREG)[None, None, :]
    slot = (np.arange(B)[:, None, None] * OUTW
            + ins["assemble"][1][:, :, None] + jw)
    dead = (jw >= ins["assemble"][2][:, :, None]) | \
        (ins["assemble"][1][:, :, None] + jw >= OUTW)
    drop = B * OUTW + np.arange(B * TOT).reshape(B, R, WREG)
    asm_idx = torch.as_tensor(np.where(dead, drop, slot).reshape(-1),
                              device=dev)
    asm_zero = torch.zeros(B * (OUTW + TOT), dtype=torch.float32,
                           device=dev)
    bufs_flat = bufs.reshape(-1)
    works = {"pitch_corr": pitch_work, "pitch_corr L=220": pitch220_work,
             "compose": compose_work, "compact": compact_work,
             f"compact NBLK={NBLK_WIDE}": wide_work,
             "compact adversarial": adv_work,
             "assemble": assemble_work,
             "assemble adversarial": asm_adv_work,
             "assemble scalar path": odd_work}
    _, sil_lens, sil_remove = ins["silence"]
    for tag in SILENCE_CASES:
        for nblk in (NBLK, NBLK_WIDE):
            works[silence_case(tag, nblk)] = silence_bound(
                np, sil_lens, sil_remove, nblk)
    for tag in ("", " B=1"):
        reg = ins[f"regions{tag}"]
        works["contour_zones" + tag] = contour_bound(np, reg)
        works["region_post" + tag] = region_post_bound(np, reg)
    libraries = {
        "pitch_corr": pitch_conv(torch, seg, ana),
        "pitch_corr L=220": pitch_conv(torch, seg, t["ana220"]),
        "compact": lambda: (bufs.gather(1, compact_idx),),
        f"compact NBLK={NBLK_WIDE}": lambda: (bufs.gather(1, wide_idx),),
        "compact adversarial": lambda: (bufs.gather(1, adv_idx),),
        "assemble": lambda: (torch.index_add(asm_zero, 0, asm_idx, bufs_flat)
                             [:B * OUTW].reshape(B, OUTW),)}
    for tag, (speed, hop, out_size, rows) in WSOLA_CASES.items():
        sent, sq, counts, nrun = t[tag]
        nr = nrun.cpu().numpy()
        cnt = ins["wsola"][1][rows]
        searched = {}
        tw.wsola_frames_plain(sent, sq, counts, nrun, hop, out_size,
                              searched=searched)
        dec = (sent, sq, counts, nrun, tw.max_steps_for(SMAX, out_size, hop))
        work = bound(
            2 * 4 * np.minimum(cnt, SMAX).astype(np.int64).sum()
            + 4 * 512 + 2 * 4 * len(cnt) * out_size,
            wsola_ops(searched, nr))
        # The decide launch alone, and the chain's latency floor: its
        # dependent steps with the window already in shared memory.
        work.update(speed=speed, hop=hop, out_size=out_size,
                    max_nrun=int(nr.max()), frames=int(nr.sum()),
                    candidates=searched,
                    decide_ms=time_ms(
                        lambda dec=dec: hopper.wsola.decide(*dec), 10),
                    floor_ms=time_ms(
                        lambda dec=dec: hopper.wsola.chain_floor(*dec), 10))
        works[f"wsola_frames {tag}"] = work

    results = {}
    for name, (out, lens) in ins["pack"].items():
        wire = PACK_CASES.get(name, (0, 0, True))[2]
        classes = None
        if wire:
            classes = hopper.pack_encode.pack_encode_plain(
                *t["pack"][name], True)[1].cpu().numpy()
        works[name] = pack_bound(np, lens, out.shape[1], classes)
    for tag, (_, cfmax, _, remove_dc) in UNIT_CASES.items():
        slots, lengths = ins["units"][tag], ins["bank"][2]
        works["unit_base" + tag] = unit_base_bound(
            np, lengths, slots, cfmax, t["units"][tag]["hw"], remove_dc)
        works["unit_contrib" + tag] = unit_contrib_bound(np, lengths, slots,
                                                         cfmax)
    # pack (wire off): one index_select with the source of every packed
    # position (masked_select would wait for its output's size).
    p_out, p_lens = t["pack"]["pack_encode wire off"]
    p_src = torch.nonzero((torch.arange(p_out.shape[1], device=dev)[None, :]
                           < p_lens[:, None]).reshape(-1))[:, 0]
    p_flat = p_out.reshape(-1)
    libraries["pack_encode wire off"] = lambda: (
        torch.index_select(p_flat, 0, p_src),)

    for name, case in kernel_cases(hopper, t).items():
        kern, plain, reps, plain_reps = case[:4]
        timed = case[4] if len(case) > 4 else kern
        timed_plain = case[5] if len(case) > 5 else plain
        equal, err, got = compare(torch, kern, plain)
        library = libraries.get(name)
        res = {"equal": equal, "max_abs_err": err,
               "ms": device_ms(timed, reps),
               "host_ms": time_ms(timed, reps),
               "plain_ms": time_ms(timed_plain, plain_reps),
               "shapes": [list(g.shape) for g in got], **works[name],
               "library_ms": None}
        if library is not None:
            res["library_ms"] = device_ms(library, reps)
            res["library_host_ms"] = time_ms(library, reps)
            res["library_equal"] = all(
                torch.equal(lib, g) for lib, g in zip(library(), got))
        say(f"kernel {name}", res)
        if not equal:
            raise RuntimeError(f"{name}: kernel differs from its plain "
                               f"version (max abs err {err})")
        results[name] = res
    return results


def make_voice(root: str) -> str:
    """The deterministic generated voice bank, built into voice.db."""
    from ctts_tpu_torch.testing.dryrun import generated_voice_db

    return generated_voice_db(root)


def oracle(db, config, text: str, speed: float):
    """The port's NumPy oracle for one text (no normalization rules)."""
    from ctts_tpu_torch.plan.compiler import compile_plan
    from ctts_tpu_torch.synth.oracle import execute_plan_oracle

    return execute_plan_oracle(compile_plan(db, text, config, None, speed),
                               db)


def held_to(np, got, ref, what: str) -> int:
    """`got` equals the oracle's `ref` in dtype and length and is within
    LSB_BOUND of it; returns the largest difference."""
    if got.dtype != np.int16 or got.shape != ref.shape:
        raise RuntimeError(f"{what}: length {got.shape} vs oracle "
                           f"{ref.shape}")
    d = int(np.abs(got.astype(np.int32)
                   - ref.astype(np.int32)).max(initial=0))
    if d > LSB_BOUND:
        raise RuntimeError(f"{what}: max |diff| {d} LSB vs the oracle")
    return d


def batch_texts(i: int) -> list:
    """Batch i of a stream: the 16 texts rotated by i, 7 times over, and
    16 more rows of text i: every batch holds all 16 texts (one bucket,
    one signature) but in other rows and other numbers, so that a batch
    overwritten by the next one would show."""
    rot = TEXTS[i:] + TEXTS[:i]
    return rot * (BATCH_MULT - 1) + [rot[0]] * len(TEXTS)


def varied_texts(i: int) -> list:
    """Batch i of the varied stream: as many texts as a stream batch,
    drawn with replacement (seeded by i) from the distinct texts of the
    120-utterance corpus and the bench texts. Batches differ in which
    buckets they fill and how many rows each bucket gets, so signatures
    come and go as with a server's mixed traffic."""
    import random

    from ctts_tpu_torch.testing.corpus import CORPUS

    pool = sorted({t for _, t, _ in CORPUS} | set(TEXTS))
    return random.Random(i).choices(pool, k=len(batch_texts(0)))


def check_oracle(np, db, config, batches, speed: float) -> int:
    """Every output of the stream batches (batch i holds batch_texts(i))
    is held to the oracle; returns the largest difference."""
    worst, refs = 0, {}
    for i, outs in enumerate(batches):
        texts = batch_texts(i)
        if len(outs) != len(texts):
            raise RuntimeError(f"batch {i}: {len(outs)} outputs for "
                               f"{len(texts)} texts")
        for text, out in zip(texts, outs):
            if text not in refs:
                refs[text] = oracle(db, config, text, speed)
            worst = max(worst, held_to(np, out, refs[text],
                                       f"{text!r} at {speed}"))
    return worst


def equal_outputs(np, got, want, what: str) -> None:
    """Two streams' outputs are equal bit for bit, batch by batch."""
    if len(got) != len(want):
        raise RuntimeError(f"{what}: {len(got)} batches, want {len(want)}")
    for b, (outs, ref) in enumerate(zip(got, want)):
        if len(outs) != len(ref):
            raise RuntimeError(f"{what}: batch {b} has {len(outs)} rows")
        for j, (o, r) in enumerate(zip(outs, ref)):
            if o.dtype != r.dtype or not np.array_equal(o, r):
                raise RuntimeError(f"{what}: batch {b} row {j} differs")


def eager_twin(bs):
    """`bs` with its shards run by the eager core (op by op, freshly
    staged) in place of the compiled one: the reference a graph is held
    to."""
    from ctts_tpu_torch.synth import compiled

    bs._run_core = compiled.run_eager
    return bs


def runs_since(before: dict) -> dict:
    """The compiled core's eager / capture / replay runs since `before`
    (a copy of compiled.runs)."""
    from ctts_tpu_torch.synth import compiled

    return {k: compiled.runs[k] - before.get(k, 0)
            for k in ("eager", "capture", "replay")}


def captures(bs) -> list:
    """The graphs captured for bs's cores: signature and kernel launches
    per replay of the prologue and epilogue, and per refine trip."""
    from ctts_tpu_torch.synth import compiled

    toks = {getattr(s.core, "_graph_token", None) for s in bs.shards}
    out = []
    for sig in compiled.signatures():
        if sig.core in toks:
            entry = compiled.captured(sig)
            out.append({"device": sig.device, "rows": dict(
                (n, shape) for n, _, shape in sig.layout)["speed"][0],
                "stretch": sig.dims.stretch, "hop": sig.dims.synth_hop,
                "wire": sig.wire,
                "launches_per_replay": dict(entry.launches),
                "launches_per_refine_trip": dict(entry.trip_launches)})
    return out


def profile_events(torch, run):
    """(run()'s result, the chrome-trace events of torch.profiler (CPU
    and CUDA) over it, the window event of run()'s host span)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function("ctts_window"):
                out = run()
            torch.cuda.synchronize()
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    events = trace.get("traceEvents", trace) if isinstance(trace, dict) \
        else trace
    window = [e for e in events if e.get("name") == "ctts_window"
              and e.get("ph") == "X"]
    return out, events, window[0] if window else None


def device_events(events) -> list:
    return [e for e in events if e.get("ph") == "X" and e.get("cat") in (
        "kernel", "gpu_memcpy", "gpu_memset")]


def traced_launches(torch, hopper, run, what: str):
    """Runs run() under torch.profiler with every wrapper count set to 0
    first. Counts, per kernel, the launches of each of its __global__
    functions (mod.GLOBALS) among the trace's kernels: the launches
    measured on the card, replays included. Raises when a function's
    trace count differs from the wrapper's count (for a graph, what its
    capture recorded times its replays). A run of replays alone whose
    trace holds fewer launches than counted of some functions and no
    more of any lost kernel records (the profiler drops one now and
    then): that is printed (trace_loss) and the run made again, at most
    TRACE_RETRIES times, each attempt held to the same equality. The
    records lost so far were those of the first counted kernels of the
    window (a one-sentence pass's first prologue: unit_base, pitch_corr),
    so each window starts with a replay of a graph of one uncounted
    kernel. Returns (run()'s result, the trace counts per kernel, the
    compiled core's eager / capture / replay runs)."""
    import re

    from ctts_tpu_torch.synth import compiled

    warm = torch.cuda.CUDAGraph()
    scratch = torch.zeros(1, device="cuda")
    with torch.cuda.stream(torch.cuda.Stream()):
        warm.capture_begin(capture_error_mode="thread_local")
        scratch.add_(1)
        warm.capture_end()
    torch.cuda.synchronize()

    def warmed():
        warm.replay()
        torch.cuda.synchronize()
        return run()

    for attempt in range(TRACE_RETRIES + 1):
        before = dict(compiled.runs)
        hopper.reset_launches()
        out, events, _ = profile_events(torch, warmed)
        counted = hopper.launch_counts()
        runs = runs_since(before)
        names = [e["name"] for e in device_events(events)
                 if e["cat"] == "kernel"]
        per = {m.KERNEL: {g: sum(1 for n in names
                                 if re.search(rf"\b{g}\b", n))
                          for g in m.GLOBALS}
               for m in hopper.MODULES}
        wrong = {k: p for k, p in per.items()
                 if any(c != counted[k] for c in p.values())}
        if not wrong:
            return out, {m.KERNEL: per[m.KERNEL][m.GLOBALS[0]]
                         for m in hopper.MODULES}, runs
        lost = all(c <= counted[k] for k, p in wrong.items()
                   for c in p.values())
        if (not lost or runs["eager"] or runs["capture"]
                or attempt == TRACE_RETRIES):
            k, p = next(iter(wrong.items()))
            raise RuntimeError(f"{what}: {k} counted {counted[k]} launches, "
                               f"the trace holds {p}")
        say("trace_loss", {"what": what, "attempt": attempt + 1,
                           "counted": {k: counted[k] for k in wrong},
                           "traced": wrong, "kernels_traced": len(names)})


def rows_rerun() -> int:
    """Rows run again so far at a wider silence table (compiled.widened:
    a region with more than NBLK kept segments)."""
    from ctts_tpu_torch.synth import compiled

    return sum(compiled.widened.values())


def no_rerun(before: int, what: str) -> int:
    """The rows run again since `before`; raises unless there are none
    (the default configuration never overflows the 32-slot table)."""
    n = rows_rerun() - before
    if n:
        raise RuntimeError(f"{what}: {n} row(s) ran again at a wider "
                           "silence table on the default path")
    return n


def stream_of(bs, n: int, speed: float) -> list:
    """The outputs of stream() over batches 0..n-1."""
    return list(bs.stream((batch_texts(i) for i in range(n)), speed=speed))


def serve(torch, np, hopper, ways: dict, speed: float,
          kernels: list) -> tuple:
    """stream() over N_BATCHES batches at one speed through each way,
    twice: the served BatchSynthesizer (graphs, the wire codec on),
    `plain` (graphs, wire=False) and their eager twins. The first pass
    is first-use set-up (a signature's first batch runs eagerly, its
    second is captured); in the second, every graph output equals its
    eager twin's bit for bit, wire on equals wire off, and the served
    outputs are held to the oracle. The launch counts are read from the
    profiler's trace of one more served 3-batch stream, served by
    replays alone and equal to the eager outputs, where every kernel in
    `kernels` must have launched as often as the wrappers count.
    Returns the results and the eager outputs."""
    served = ways["wire"]
    rerun0 = rows_rerun()
    for bs in ways.values():
        stream_of(bs, N_BATCHES, speed)
    batches = {key: stream_of(bs, N_BATCHES, speed)
               for key, bs in ways.items()}
    # The counted run: the served stream once more, its launches read
    # from the profiler's trace.
    counted, launches, runs = traced_launches(
        torch, hopper, lambda: stream_of(served, N_BATCHES, speed),
        f"the served stream at {speed}")

    equal_outputs(np, batches["wire"], batches["eager"],
                  f"speed {speed}: graph vs eager, wire on")
    equal_outputs(np, batches["plain"], batches["eager_plain"],
                  f"speed {speed}: graph vs eager, wire off")
    equal_outputs(np, batches["wire"], batches["plain"],
                  f"speed {speed}: wire on vs wire off")
    equal_outputs(np, counted, batches["eager"],
                  f"speed {speed}: the counted graph run vs eager")
    if runs["eager"] or runs["capture"] or runs["replay"] < N_BATCHES:
        raise RuntimeError(f"speed {speed}: the counted run was not served "
                           f"by replays alone: {runs}")
    worst = check_oracle(np, served.db, served.config, batches["wire"],
                         speed)
    missing = [k for k in kernels if launches[k] <= 0]
    if missing:
        raise RuntimeError(f"kernels not launched by the path at speed "
                           f"{speed}: {missing}")
    res = {"speed": speed, "batches": N_BATCHES,
           "sentences_per_batch": len(batch_texts(0)),
           "distinct_texts": len(TEXTS), "graph_equals_eager": True,
           "wire_equals_plain": True, "oracle_max_abs_diff": worst,
           "launches": launches, "compiled_runs": runs,
           "captures": captures(served) + captures(ways["plain"]),
           "rows_rerun": no_rerun(rerun0, f"the streams at {speed}")}
    return res, batches["eager"]


def serve_varied(np, served, eager, speed: float) -> dict:
    """stream() over N_VARIED batches of varied_texts through the served
    BatchSynthesizer (graphs, the wire codec on) and its eager twin in
    turns: graph, eager, eager, graph. The first graph pass meets the
    stream's signatures anew (a signature's first batch runs eagerly,
    its second is captured), the second replays; each pass's eager /
    capture / replay runs are counted. Every output equals the eager
    twin's bit for bit, and the eager outputs are held to the oracle."""
    from ctts_tpu_torch.synth import compiled

    outs, passes = {}, []
    for key, bs in (("graph", served), ("eager", eager),
                    ("eager", eager), ("graph", served)):
        before = dict(compiled.runs)
        got = list(bs.stream((varied_texts(i) for i in range(N_VARIED)),
                             speed=speed))
        if key in outs:
            equal_outputs(np, got, outs[key], f"varied at {speed}: "
                          f"{key} passes")
        outs[key] = got
        passes.append({"way": key, "compiled_runs": runs_since(before)})
    equal_outputs(np, outs["graph"], outs["eager"],
                  f"varied at {speed}: graph vs eager")
    refs, worst = {}, 0
    for i, got in enumerate(outs["eager"]):
        for text, out in zip(varied_texts(i), got):
            if text not in refs:
                refs[text] = oracle(served.db, served.config, text, speed)
            worst = max(worst, held_to(np, out, refs[text],
                                       f"{text!r} at {speed}"))
    return {"speed": speed, "batches": N_VARIED,
            "sentences_per_batch": len(varied_texts(0)),
            "distinct_texts": len(refs), "graph_equals_eager": True,
            "oracle_max_abs_diff": worst, "passes": passes,
            "graphs_captured": len(compiled.signatures())}


def run_slice(torch, np, hopper, root: str):
    """The serving path end to end on the card, held to the oracle:
    speed 1.0 (K1-K4), speed 1.5 and a synchronous batch at 0.5 (all
    five kernels), through the graphs and the eager core, with the wire
    codec on as served and off. Returns the results, the served
    BatchSynthesizer and its eager stream outputs per speed (phase 7
    holds the split to them)."""
    from ctts_tpu_torch.config import config_defaults
    from ctts_tpu_torch.db.reader import VoiceDatabase
    from ctts_tpu_torch.parallel.batch import BatchSynthesizer

    names = [m.KERNEL for m in hopper.MODULES]
    db = VoiceDatabase(make_voice(root))
    dev = torch.device("cuda")

    def make(**kw):
        return BatchSynthesizer(db, config_defaults(), device=dev,
                                dims_floor=FLOOR, **kw)

    ways = {"wire": make(), "plain": make(wire=False),
            "eager": eager_twin(make()),
            "eager_plain": eager_twin(make(wire=False))}
    served = ways["wire"]
    if not served.wire or ways["plain"].wire:
        raise RuntimeError("BatchSynthesizer on the card does not serve "
                           "with the wire codec by default")
    res, outputs = {}, {}
    res["1.0"], outputs[1.0] = serve(
        torch, np, hopper, ways, 1.0,
        [n for n in names if n not in STRETCH_KERNELS])
    say("slice", res["1.0"])
    res["1.5"], outputs[STRETCH_SPEED] = serve(
        torch, np, hopper, ways, STRETCH_SPEED, names)
    say("slice_stretch", res["1.5"])

    texts = batch_texts(0)
    rerun0 = rows_rerun()
    for _ in range(2):    # first-use set-up: the eager batch, the capture
        served.synthesize(texts, speed=SYNC_SPEED)
    outs = served.synthesize(texts, speed=SYNC_SPEED)
    traced, launches, runs = traced_launches(
        torch, hopper, lambda: served.synthesize(texts, speed=SYNC_SPEED),
        f"synthesize at {SYNC_SPEED}")
    equal_outputs(np, [traced], [outs], f"speed {SYNC_SPEED}: two replays")
    if runs["eager"] or runs["capture"] or not runs["replay"]:
        raise RuntimeError(f"speed {SYNC_SPEED}: not served by a replay: "
                           f"{runs}")
    worst = check_oracle(np, db, served.config, [outs], SYNC_SPEED)
    missing = [k for k in names if launches[k] <= 0]
    if missing:
        raise RuntimeError(f"kernels not launched at speed "
                           f"{SYNC_SPEED}: {missing}")
    equal_outputs(np, [outs], [ways["eager"].synthesize(
        texts, speed=SYNC_SPEED)], f"speed {SYNC_SPEED}: graph vs eager")
    res["0.5"] = {"speed": SYNC_SPEED, "sentences": len(texts),
                  "oracle_max_abs_diff": worst, "graph_equals_eager": True,
                  "launches": launches, "compiled_runs": runs,
                  "rows_rerun": no_rerun(rerun0,
                                         f"synthesize at {SYNC_SPEED}")}
    say("synthesize_sync", res["0.5"])
    for speed in (1.0, STRETCH_SPEED):
        rerun0 = rows_rerun()
        res[f"varied_{speed}"] = serve_varied(np, served, ways["eager"],
                                              speed)
        res[f"varied_{speed}"]["rows_rerun"] = no_rerun(
            rerun0, f"the varied stream at {speed}")
        say("slice_varied", res[f"varied_{speed}"])
    return res, served, outputs


# CLI drives of phase 6: (text, speed argument, flags).
CLI_CASES = [("olá mundo, tudo bem?", "1.0", []),
             ("o brasil é bonito", "0.5",
              ["--executor=torch", "--device=cuda"])]


def held_to_oracle(np, db, config, got, text: str, speed: float) -> int:
    return held_to(np, got, oracle(db, config, text, speed),
                   f"{text!r} at {speed}")


def run_entry_points(torch, np, hopper, root: str) -> dict:
    """Phase 6: the CLI (in subprocesses as a user types it, then
    through cli.main here for the launch counts) and CTTSEngine over
    the golden corpus, every output held to the oracle."""
    import filecmp
    import subprocess
    from collections import defaultdict

    from ctts_tpu_torch import cli
    from ctts_tpu_torch.config import config_defaults
    from ctts_tpu_torch.db.reader import VoiceDatabase
    from ctts_tpu_torch.models.engine import CTTSEngine
    from ctts_tpu_torch.synth import compiled
    from ctts_tpu_torch.testing.corpus import CORPUS
    from ctts_tpu_torch.utils.wav import read_wav

    work = os.path.join(root, "cli")
    os.makedirs(work)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")

    def run_cli(args):
        r = subprocess.run([sys.executable, "-m", "ctts_tpu_torch.cli"]
                           + args, cwd=work, env=env, capture_output=True,
                           text=True, timeout=600)
        if r.returncode != 0:
            raise RuntimeError(f"ctts_tpu_torch.cli {args[0]}: rc "
                               f"{r.returncode}\n{r.stdout}{r.stderr}")

    run_cli(["build", os.path.join(root, "dataset"), "cli.db"])
    dbp = os.path.join(work, "cli.db")
    if not filecmp.cmp(dbp, os.path.join(root, "voice.db"), shallow=False):
        raise RuntimeError("cli build: voice.db differs from the builder's")
    res = {}
    db, cfg = VoiceDatabase(dbp), config_defaults()
    cases = []
    cwd = os.getcwd()
    os.chdir(work)    # cli.main reads config.yaml from the working dir
    try:
        for i, (text, speed, flags) in enumerate(CLI_CASES):
            wav = f"sub{i}.wav"
            run_cli(["synth", "cli.db", text, wav, speed] + flags)
            got = read_wav(wav)
            case = {"text": text, "speed": float(speed), "flags": flags,
                    "samples": int(got.shape[0]),
                    "oracle_max_abs_diff": held_to_oracle(
                        np, db, cfg, got, text, float(speed))}
            hopper.reset_launches()
            with contextlib.redirect_stdout(io.StringIO()):
                rc = cli.main(["ctts", "synth", "cli.db", text,
                               f"in{i}.wav", speed] + flags)
            if rc != 0:
                raise RuntimeError(f"cli.main synth {text!r} failed")
            case["launches"] = hopper.launch_counts()
            if not np.array_equal(read_wav(f"in{i}.wav"), got):
                raise RuntimeError(f"cli.main and the subprocess differ "
                                   f"on {text!r}")
            want = [m.KERNEL for m in hopper.MODULES
                    if m.KERNEL not in STRETCH_KERNELS or speed != "1.0"]
            missing = [k for k in want if case["launches"][k] <= 0]
            if missing:
                raise RuntimeError(f"cli synth {text!r}: kernels not "
                                   f"launched: {missing}")
            cases.append(case)
        text = CLI_CASES[0][0]
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(["ctts", "synth", "cli.db", text, "native.wav",
                           "--executor=native"])
        if rc != 0:
            raise RuntimeError("cli synth --executor=native failed")
        res["native_oracle_max_abs_diff"] = held_to_oracle(
            np, db, cfg, read_wav("native.wav"), text, 1.0)
    finally:
        os.chdir(cwd)
    res["cli"] = cases

    groups = defaultdict(list)
    for _, text, speed in CORPUS:
        groups[speed].append(text)
    eng = CTTSEngine(dbp, device=torch.device("cuda"))
    rerun0 = rows_rerun()

    def corpus():
        return {sp: eng.synthesize_batch(texts, sp)
                for sp, texts in groups.items()}
    try:
        # First pass: every signature is new, so every batch runs
        # eagerly; the second (traced) captures them and replays.
        before = dict(compiled.runs)
        outs = corpus()
        first = runs_since(before)
        again, launches, runs = traced_launches(torch, hopper, corpus,
                                                "the corpus")
        for sp in groups:
            equal_outputs(np, [again[sp]], [outs[sp]],
                          f"corpus at {sp}: second pass vs first")
        worst = max(held_to_oracle(np, db, cfg, o, t, sp)
                    for sp, texts in groups.items()
                    for t, o in zip(texts, outs[sp]))
        if not eng._batcher.wire:
            raise RuntimeError("CTTSEngine's batch path is not the served "
                               "one (wire codec off)")
    finally:
        eng.close()
    missing = [m.KERNEL for m in hopper.MODULES if launches[m.KERNEL] <= 0]
    if missing or first["capture"] or first["replay"] or not runs["capture"]:
        raise RuntimeError(f"corpus: kernels not launched: {missing}, or "
                           f"the passes ran {first} and {runs}")
    res["corpus"] = {"utterances": sum(len(v) for v in outs.values()),
                     "held_to_oracle": sum(len(v) for v in outs.values()),
                     "speeds": {str(k): len(v) for k, v in groups.items()},
                     "oracle_max_abs_diff": worst, "compiled_runs": first,
                     "second_pass": {"compiled_runs": runs,
                                     "launches": launches},
                     "rows_rerun": no_rerun(rerun0, "the corpus")}
    res["demo_page"] = run_demo_page(np, work, env, dbp, db, cfg)
    say("entry_points", res)
    return res


def run_demo_page(np, work: str, env: dict, dbp: str, db, cfg) -> dict:
    """tools/torch_generate_samples.py as a user runs it: no flags (the
    torch executor on the card), in a subprocess, over the corpus; every
    WAV held to the oracle and listed on its page."""
    import subprocess

    from ctts_tpu_torch.constants import MAX_SPEED, MIN_SPEED
    from ctts_tpu_torch.testing.corpus import CORPUS
    from ctts_tpu_torch.utils.wav import read_wav

    out = os.path.join(work, "samples")
    r = subprocess.run([sys.executable, os.path.join(
        REPO, "tools", "torch_generate_samples.py"), dbp, out], cwd=work,
        env=env, capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise RuntimeError(f"torch_generate_samples.py: rc {r.returncode}"
                           f"\n{r.stdout[-2000:]}{r.stderr[-4000:]}")
    with open(os.path.join(out, "index.html"), encoding="utf-8") as f:
        page = f.read()
    worst = 0
    for fname, text, speed in CORPUS:
        if f'src="audio/{fname}"' not in page:
            raise RuntimeError(f"demo page: {fname} is not listed")
        speed = min(max(float(np.float32(speed)), MIN_SPEED), MAX_SPEED)
        worst = max(worst, held_to_oracle(
            np, db, cfg, read_wav(os.path.join(out, "audio", fname)), text,
            speed))
    return {"utterances": len(CORPUS), "held_to_oracle": len(CORPUS),
            "oracle_max_abs_diff": worst,
            "tool_last_line": r.stdout.strip().splitlines()[-1]}


# One rank of the two-process exchange, both on cuda:0:
#   python -c GLOO_WORKER coordinator rank voice.db out.npz texts floor
# It serves its block of the texts through synthesize_across_hosts, its
# local rows equal to its slice of the gather; rank 0 saves the gathered
# outputs.
GLOO_WORKER = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist

coordinator, rank, dbp, outp = (sys.argv[1], int(sys.argv[2]), sys.argv[3],
                                sys.argv[4])
texts, floor = json.loads(sys.argv[5]), json.loads(sys.argv[6])
from ctts_tpu_torch.config import config_defaults
from ctts_tpu_torch.db.reader import VoiceDatabase
from ctts_tpu_torch.parallel.batch import BatchSynthesizer
from ctts_tpu_torch.parallel.multihost import (
    initialize, synthesize_across_hosts)

initialize(coordinator, 2, rank, timeout_s=240)
bs = BatchSynthesizer(VoiceDatabase(dbp), config_defaults(),
                      device=torch.device("cuda", 0), dims_floor=floor)
for _ in range(2):    # first-use set-up: the eager batch, the capture
    synthesize_across_hosts(bs, texts, return_local=True)
outs = synthesize_across_hosts(bs, texts)
idx, local = synthesize_across_hosts(bs, texts, return_local=True)
for i, o in zip(idx, local):
    assert np.array_equal(o, outs[i]), i
loaded = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
                or m == "ctts_tpu" or m.startswith("ctts_tpu."))
assert not loaded, loaded
if rank == 0:
    np.savez(outp, *outs)
print("RESULT " + json.dumps({"rank": rank, "rows": len(idx)}), flush=True)
dist.destroy_process_group()
"""


def check_cross_device(torch, np, hopper) -> dict:
    """The kernel library's runtime takes the device that
    torch.cuda.device makes current, on every card; with two or more
    cards, phase 4's kernels on cuda:1 tensors with cuda:0 current equal
    their plain versions (comparisons: nothing is counted)."""
    n = torch.cuda.device_count()
    current = {}
    for d in range(n):
        with torch.cuda.device(d):
            current[d] = hopper.build.current_device()
    if any(current[d] != d for d in current):
        raise RuntimeError(f"the kernel library's current device does not "
                           f"follow torch.cuda.device: {current}")
    res = {"devices": n, "library_current_device": current}
    if n < 2:
        print("multi-device: phase 4's kernels on cuda:1 with cuda:0 "
              "current: not run, one CUDA device is visible", flush=True)
        return dict(res, cross_device_run=False)
    counts = hopper.launch_counts()
    t = kernel_tensors(torch, kernel_inputs(np), torch.device("cuda", 1))
    errs = {}
    with torch.cuda.device(0):
        for name, (kern, plain, _, _) in kernel_cases(hopper, t).items():
            equal, errs[name], _ = compare(torch, kern, plain)
            if not equal:
                raise RuntimeError(f"{name} on cuda:1 with cuda:0 current "
                                   f"differs from its plain version")
    for m in hopper.MODULES:
        m.launches = counts[m.KERNEL]
    del t
    torch.cuda.empty_cache()
    return dict(res, cross_device_run=True, max_abs_err=errs)


def split_streams(torch, np, hopper, ways, want, speed: float,
                  kernels: list) -> dict:
    """stream() over N_BATCHES batches at one speed through each
    BatchSynthesizer of `ways` (the unsplit served one, and per mesh its
    graphs with the codec on and off and its eager twin), twice: the
    first pass is first-use set-up, and every output of the second
    equals `want` (phase 5's eager stream, equal to its graphs) bit for
    bit. The launch counts come from the profiler's trace of one more
    3-batch stream a way (traced_launches; graphs: replays alone), where
    every kernel in `kernels` must have launched."""
    for bs in ways.values():
        stream_of(bs, N_BATCHES, speed)
    got = {key: stream_of(bs, N_BATCHES, speed) for key, bs in ways.items()}
    counted, launches, runs = {}, {}, {}
    for key, bs in ways.items():
        counted[key], launches[key], runs[key] = traced_launches(
            torch, hopper, lambda: stream_of(bs, N_BATCHES, speed),
            f"{key} at {speed}")

    res = {"speed": speed, "batches": N_BATCHES,
           "sentences_per_batch": len(batch_texts(0))}
    for key, bs in ways.items():
        equal_outputs(np, got[key], want,
                      f"{key} at {speed} vs the unsplit eager stream")
        equal_outputs(np, counted[key], want,
                      f"{key} at {speed}, counted, vs the unsplit eager")
        graph = "eager" not in key
        if graph and (runs[key]["eager"] or runs[key]["capture"]):
            raise RuntimeError(f"{key} at {speed}: the counted run was not "
                               f"served by replays alone: {runs[key]}")
        missing = [k for k in kernels if launches[key][k] <= 0]
        if missing:
            raise RuntimeError(f"{key} at {speed}: kernels not launched: "
                               f"{missing}")
        res[key] = {"shards": [str(s.device) for s in bs.shards],
                    "graph": graph, "equal_to_unsplit_eager": True,
                    "launches": launches[key], "compiled_runs": runs[key]}
    return res


def run_exchange(np, root: str, dbp: str, want: list) -> dict:
    """Two processes over gloo on the card serve one bench batch through
    synthesize_across_hosts; process 0's gather must equal `want` (the
    unsplit served output of that batch) bit for bit."""
    import socket
    import subprocess

    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    texts = batch_texts(0)
    outp = os.path.join(root, "exchange.npz")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, "-c", GLOO_WORKER, f"127.0.0.1:{port}", str(rank),
         dbp, outp, json.dumps(texts), json.dumps(FLOOR)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in (0, 1)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=400)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"exchange worker: rc {p.returncode}\n"
                               f"{log[-4000:]}")
    ranks = [json.loads(line[len("RESULT "):]) for log in logs
             for line in log.splitlines() if line.startswith("RESULT ")]
    with np.load(outp) as z:
        got = [z[f"arr_{i}"] for i in range(len(z.files))]
    if len(got) != len(want) or any(
            a.dtype != b.dtype or not np.array_equal(a, b)
            for a, b in zip(got, want)):
        raise RuntimeError("gloo exchange: process 0's gather differs from "
                           "the unsplit served output")
    return {"processes": 2, "device": "cuda:0 (both)", "texts": len(texts),
            "equal_to_unsplit_served": True, "ranks": ranks}


def run_bundle(torch, np, root: str, db) -> dict:
    """Save the voice bundle, load it on the card, and synthesize one
    sentence with it and with DeviceVoice: equal tensors and samples."""
    from ctts_tpu_torch.config import config_defaults
    from ctts_tpu_torch.db.bundle import VoiceBundle, save_voice_bundle
    from ctts_tpu_torch.plan.compiler import compile_plan
    from ctts_tpu_torch.synth.device import DeviceVoice, execute_plan_torch

    path = os.path.join(root, "voice_bundle.npz")
    dev = torch.device("cuda")
    save_voice_bundle(db, path)
    bundle = VoiceBundle(path, dev)
    voice = DeviceVoice(db, device=dev)
    for name in ("bank", "lengths", "gains"):
        if not torch.equal(getattr(bundle, name), getattr(voice, name)):
            raise RuntimeError(f"bundle: {name} differs from DeviceVoice's")
    text = "olá mundo, tudo bem?"
    plan = compile_plan(db, text, config_defaults(), None, 1.0)
    got = execute_plan_torch(plan, db, bundle)
    want = execute_plan_torch(plan, db, voice)
    if got.dtype != want.dtype or not np.array_equal(got, want):
        raise RuntimeError("bundle: the sentence differs from DeviceVoice's")
    return {"text": text, "samples": int(got.shape[0]),
            "equal_to_device_voice": True, "bytes": os.path.getsize(path),
            "units": int(bundle.bank.shape[0])}


def run_multi_device(torch, np, hopper, root: str, served,
                     outputs: dict) -> dict:
    """Phase 7: device routing across cards, the row split's streams at
    1.0 and 1.5 through make_mesh() and [cuda:0, cuda:0] beside the
    unsplit served stream, dryrun_multigpu on both meshes, the
    two-process gloo exchange and the voice bundle."""
    from ctts_tpu_torch.parallel import BatchSynthesizer, make_mesh
    from ctts_tpu_torch.testing.dryrun import dryrun_multigpu

    res = {"cross_device": check_cross_device(torch, np, hopper)}
    say("multi_device_kernels", res["cross_device"])
    dbp = os.path.join(root, "voice.db")
    cuda0 = torch.device("cuda", 0)
    meshes = {"mesh_all_cards": make_mesh(),
              "mesh_cuda0_x2": make_mesh([cuda0, cuda0])}
    ways = {"unsplit": served}
    for key, mesh in meshes.items():
        def make(**kw):
            return BatchSynthesizer(served.db, served.config, mesh=mesh,
                                    dims_floor=FLOOR, **kw)
        ways[key] = make()
        if not ways[key].wire:
            raise RuntimeError(f"{key}: the wire codec is off")
        ways[key + "_plain"] = make(wire=False)
        ways[key + "_eager"] = eager_twin(make())
    names = [m.KERNEL for m in hopper.MODULES]
    res["1.0"] = split_streams(torch, np, hopper, ways, outputs[1.0], 1.0,
                               [n for n in names
                                if n not in STRETCH_KERNELS])
    say("multi_device_stream", res["1.0"])
    res["1.5"] = split_streams(torch, np, hopper, ways,
                               outputs[STRETCH_SPEED], STRETCH_SPEED, names)
    say("multi_device_stream_stretch", res["1.5"])
    del ways
    res["dryrun"] = {key: dryrun_multigpu(mesh.devices, dbp)
                     for key, mesh in meshes.items()}
    say("multi_device_dryrun", res["dryrun"])
    res["exchange"] = run_exchange(np, root, dbp, outputs[1.0][0])
    say("multi_device_exchange", res["exchange"])
    res["bundle"] = run_bundle(torch, np, root, served.db)
    say("multi_device_bundle", res["bundle"])
    return res


# Phase 8. The one-sentence path: CTTSEngine.synthesize over the bench
# texts at these speeds.
SENTENCE_SPEEDS = (1.0, SYNC_SPEED)


@contextlib.contextmanager
def eager_sentences():
    """execute_plan_torch runs the eager core while installed (the
    reference its graphs are held to)."""
    from ctts_tpu_torch.synth import compiled

    run = compiled.run_batch
    compiled.run_batch = compiled.run_eager
    try:
        yield
    finally:
        compiled.run_batch = run


def run_one_sentence(torch, np, hopper, dbp: str) -> dict:
    """Phase 8: CTTSEngine.synthesize of each bench text at 1.0 and 0.5,
    three passes on one engine: the first runs every signature eagerly,
    the second captures, the third (traced: every kernel's trace count
    equals what its graphs recorded times their replays, K6 at 0.5
    included) replays only. Passes 2-3 equal pass 1 bit for bit, and
    pass 1 equals the eager core and is held to the oracle."""
    from ctts_tpu_torch.models.engine import CTTSEngine
    from ctts_tpu_torch.synth import compiled

    eng = CTTSEngine(dbp, device=torch.device("cuda"))
    rerun0 = rows_rerun()

    def one_pass():
        return [[eng.synthesize(t, sp) for t in TEXTS]
                for sp in SENTENCE_SPEEDS]
    try:
        passes, runs = [], []
        for _ in range(2):
            before = dict(compiled.runs)
            passes.append(one_pass())
            runs.append(runs_since(before))
        third, launches, runs3 = traced_launches(
            torch, hopper, one_pass, "the one-sentence replays")
        with eager_sentences():
            eager = one_pass()
        for i, got in enumerate((passes[1], third, eager)):
            equal_outputs(np, got, passes[0],
                          f"one sentence: pass {i + 2} vs pass 1"
                          if i < 2 else "one sentence: eager vs pass 1")
        n = len(TEXTS) * len(SENTENCE_SPEEDS)
        if runs3 != {"eager": 0, "capture": 0, "replay": n}:
            raise RuntimeError(f"one sentence: the third pass was not "
                               f"replays alone: {runs3}")
        missing = [m.KERNEL for m in hopper.MODULES
                   if launches[m.KERNEL] <= 0]
        if missing:
            raise RuntimeError(f"one sentence: kernels not launched by the "
                               f"replays: {missing}")
        worst = max(held_to_oracle(np, eng.db, eng.config, o, t, sp)
                    for sp, outs in zip(SENTENCE_SPEEDS, passes[0])
                    for t, o in zip(TEXTS, outs))
        graphs = len(compiled.signatures())
    finally:
        eng.close()
    return {"texts": len(TEXTS), "speeds": list(SENTENCE_SPEEDS),
            "passes_equal": True, "equal_to_eager": True,
            "oracle_max_abs_diff": worst,
            "compiled_runs": runs + [runs3],
            "launches_third_pass": launches,
            "launches_per_replay": {k: v / n for k, v in launches.items()},
            "graphs_captured": graphs,
            "rows_rerun": no_rerun(rerun0, "the one-sentence passes")}


# Phase 9. The configuration keys where the JAX package departs from the
# C reference (ROADMAP Queue C), each set alone, and the default: the
# speed-1.0 texts of tests/test_device_executor.py::CASES at these
# speeds. The port refuses min_silence_ms under 10 samples at lowering;
# crossfade_ms 200 makes CFMAX wider than the unit bank (compose then
# takes contributions CFMAX wide).
CONFIG_CELLS = [("default", {}),
                ("remove_dc_offset: 0", {"remove_dc_offset": False}),
                ("min_silence_ms: 0", {"min_silence_ms": 0.0}),
                ("fade_in_ms: 300", {"fade_in_ms": 300.0}),
                ("fade_out_ms: 400", {"fade_out_ms": 400.0}),
                ("word_pause_ms: 0", {"word_pause_ms": 0.0}),
                ("crossfade_ms: 200", {"crossfade_ms": 200.0}),
                ("silence_threshold: 0.5, min_silence_ms: 1",
                 {"silence_threshold": 0.5, "min_silence_ms": 1.0}),
                ("silence_threshold: 0.5, min_silence_ms: 2",
                 {"silence_threshold": 0.5, "min_silence_ms": 2.0}),
                ("silence_threshold: 0.3, min_silence_ms: 1",
                 {"silence_threshold": 0.3, "min_silence_ms": 1.0})]
CONFIG_REFUSED = {"min_silence_ms: 0"}
# Settings that leave more kept segments in a region than the 32-slot
# silence table holds: their rows run again at a wider table.
CONFIG_OVERFLOWS = {name for name, keys in CONFIG_CELLS
                    if "silence_threshold" in keys}
CONFIG_TEXTS = ["como vai", "que legal!", "como se chama?",
                "bom dia. tudo bem.", "oi xz oi"]
CONFIG_SPEEDS = (1.0, STRETCH_SPEED)


def run_config_cells(torch, np, hopper, dbp: str) -> dict:
    """Phase 9: for each CONFIG_CELLS setting and speed, CONFIG_TEXTS
    through BatchSynthesizer.synthesize (one batch in the bench's bucket,
    served: graphs and the wire codec) and through execute_plan_torch one
    sentence at a time (a voice's one core), three passes each, the
    graphs released before each setting: every signature's first
    sighting runs eagerly, its second is captured, the third pass is
    replays alone, as compiled.runs counts (texts that share a bucket
    share a signature, so one pass may hold all three). Every pass equals
    the eager core's output (the eager twin, eager_sentences) bit for
    bit, and that is held to the oracle (equal lengths, <= LSB_BOUND). A
    refused value must raise ValueError naming its key, on both paths.
    Each cell records the fade passes of its signatures
    (plan_arrays.fade_passes: 0 for fades kept in their windows), the
    rows each pass ran again at a wider silence table and those tables'
    widths (compiled.widened): above 0 in every pass of the
    CONFIG_OVERFLOWS cells, 0 in the others. A fourth pass runs under
    traced_launches (the trace's counts equal the wrappers', the
    silence tables and K3 launched) and equals the eager core too."""
    from ctts_tpu_torch.config import config_defaults
    from ctts_tpu_torch.db.reader import VoiceDatabase
    from ctts_tpu_torch.parallel.batch import BatchSynthesizer
    from ctts_tpu_torch.plan.compiler import compile_plan
    from ctts_tpu_torch.synth import compiled
    from ctts_tpu_torch.synth.device import DeviceVoice, execute_plan_torch

    db = VoiceDatabase(dbp)
    dev = torch.device("cuda")
    kinds = ("eager", "capture", "replay")
    cells = []
    for name, keys in CONFIG_CELLS:
        compiled.release_compiled()
        voice = DeviceVoice(db, device=dev)
        cfg = config_defaults()
        for k, v in keys.items():
            setattr(cfg, k, v)
        if name in CONFIG_REFUSED:
            plan = compile_plan(db, CONFIG_TEXTS[0], cfg, None, 1.0)
            errors = []
            for call in (lambda: BatchSynthesizer(db, cfg, device=dev),
                         lambda: execute_plan_torch(plan, db, voice)):
                try:
                    call()
                except ValueError as e:
                    errors.append(str(e))
                else:
                    raise RuntimeError(f"{name}: not refused")
            if not all(k in e for e in errors for k in keys):
                raise RuntimeError(f"{name}: the refusal does not name "
                                   f"its key: {errors}")
            cells.append({"setting": name, "refused": errors[0]})
            continue
        bs = BatchSynthesizer(db, cfg, device=dev, dims_floor=FLOOR)
        twin = eager_twin(BatchSynthesizer(db, cfg, device=dev,
                                           dims_floor=FLOOR))
        for speed in CONFIG_SPEEDS:
            refs = [oracle(db, cfg, t, speed) for t in CONFIG_TEXTS]

            def sentences():
                return [execute_plan_torch(compile_plan(db, t, cfg, None,
                                                        speed), db, voice)
                        for t in CONFIG_TEXTS]

            def eager_of(run):
                with eager_sentences():
                    return run()
            ways = {"batch": (lambda: bs.synthesize(CONFIG_TEXTS,
                                                    speed=speed),
                              lambda: twin.synthesize(CONFIG_TEXTS,
                                                      speed=speed)),
                    "sentence": (sentences, lambda: eager_of(sentences))}
            for way, (run, eager_run) in ways.items():
                what = f"{name} {way} at {speed}"
                seen = set(compiled.signatures())
                outs, runs, reruns = [], [], []
                widths = set()
                for _ in kinds:
                    before = dict(compiled.runs)
                    wide = dict(compiled.widened)
                    outs.append(run())
                    runs.append(runs_since(before))
                    grew = {w: n - wide.get(w, 0)
                            for w, n in compiled.widened.items()
                            if n > wide.get(w, 0)}
                    reruns.append(sum(grew.values()))
                    widths |= set(grew)
                if (min(reruns) <= 0 if name in CONFIG_OVERFLOWS
                        else max(reruns) > 0):
                    raise RuntimeError(f"{what}: rows run again per pass "
                                       f"{reruns}")
                new = [sig for sig in compiled.signatures()
                       if sig not in seen]
                total = {k: sum(r[k] for r in runs) for k in kinds}
                if (runs[2]["eager"] or runs[2]["capture"]
                        or not runs[2]["replay"] or not new
                        or total["eager"] != len(new)
                        or total["capture"] != len(new)):
                    raise RuntimeError(f"{what}: runs {runs} for "
                                       f"{len(new)} new signatures")
                # A fourth pass (replays), its launches read from the
                # profiler's trace and held to the wrappers' counts.
                traced, launches, _ = traced_launches(
                    torch, hopper, run, f"{what}: the traced pass")
                missing = [k for k in ("silence_tables", "compact")
                           if launches[k] <= 0]
                if missing:
                    raise RuntimeError(f"{what}: kernels not launched by "
                                       f"the traced pass: {missing}")
                eager = eager_run()
                equal_outputs(np, outs + [traced],
                              [eager] * (len(kinds) + 1),
                              f"{what}: passes vs the eager core")
                worst = max(held_to(np, o, ref, f"{what}: {t!r}")
                            for t, o, ref in zip(CONFIG_TEXTS, eager, refs))
                cells.append({
                    "setting": name, "speed": speed, "way": way,
                    "oracle_max_abs_diff": worst, "passes_equal_eager": True,
                    "signatures": len(new), "compiled_runs": runs,
                    "traced_launches": launches,
                    "fade_passes": sorted({sig.fades for sig in new}),
                    "rows_rerun": reruns, "table_widths": sorted(widths)})
        bs = twin = voice = None
    compiled.release_compiled()
    return {"texts": CONFIG_TEXTS, "speeds": list(CONFIG_SPEEDS),
            "cells": cells}


LIBRARY_NONE = {
    "silence_tables": "none: no single PyTorch call computes the "
                      "kept-segment tables",
    "compose": "none: units are placed in sequence, each reading the "
               "last one's write",
    "contour_zones": "none: no single PyTorch call resamples, windows and "
                     "overlap-adds the pitch-contour frames",
    "region_post": "none: no single PyTorch call applies the energy ramp "
                   "and the sine-fade LUT's tail fade",
    "wsola_frames": "none: each frame's search reads the previous "
                    "frame's choice",
    "pack_encode": "none with the codec (served): no single PyTorch call "
                   "packs, delta-codes and plane-compacts the rows; without "
                   "it, one index_select packs them (the 'pack_encode "
                   "wire off' case of phase 4)",
    "unit_base": "none: no single PyTorch call gathers and quantizes the "
                 "bank rows and evaluates the crossfade LUT curves",
    "unit_contrib": "none: no single PyTorch call applies the DC shift, "
                    "the sine-fade LUT and the crossfade weights",
}


def main() -> int:
    if not os.path.isdir(os.path.join(REPO, "ctts_tpu_torch")):
        print("chip_smoke.py: ctts_tpu_torch/ not found next to this "
              "script; run it from a checkout", file=sys.stderr)
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
    from ctts_tpu_torch.synth import compiled

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
    if "--kernels-only" in sys.argv[1:]:
        print("chip_smoke.py: --kernels-only, phases 5-9 skipped",
              flush=True)
        return 0
    with tempfile.TemporaryDirectory() as root:
        sl, served, outputs = run_slice(torch, np, hopper, root)
        run_entry_points(torch, np, hopper, root)
        run_multi_device(torch, np, hopper, root, served, outputs)
        del served, outputs
        compiled.release_compiled()
        say("one_sentence", run_one_sentence(
            torch, np, hopper, os.path.join(root, "voice.db")))
        say("config_cells", run_config_cells(
            torch, np, hopper, os.path.join(root, "voice.db")))
    compiled.release_compiled()

    leaked = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith(("jax.", "ctts_tpu."))
                    or m == "ctts_tpu")
    if leaked:
        raise RuntimeError(f"the JAX package or jax was imported: {leaked}")
    kernels = []
    for mod in hopper.MODULES:
        name = mod.KERNEL
        if name == "wsola_decide":
            continue    # on the wsola line (decide_launches)
        # The wsola kernel belongs to the speed-1.5 path; its line
        # carries the speed-1.5 case of phase 4.
        k = kern[name] if name in kern else kern[f"{name} speed_1.5"]
        path = sl["1.5"] if name in STRETCH_KERNELS else sl["1.0"]
        kernels.append({"name": name, "route": "cuda",
                        "source": mod.SOURCE, "replaces": mod.REPLACES,
                        "launches": path["launches"][name],
                        "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                        "plain_ms": k["plain_ms"],
                        "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
                        "library_ms": k["library_ms"]})
        if name == "wsola_frames":
            kernels[-1]["decide_launches"] = path["launches"]["wsola_decide"]
    say("library_none", LIBRARY_NONE)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(env.gpu_name_and_power_limit(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
