#!/usr/bin/env python3
"""The served stream of one or more checkouts of the port, timed and
profiled alike on one card, their outputs compared bit for bit: what
the compiled batch core changes end to end.

    python3 tools/torch_stream_times.py [--root DIR]...

Each DIR (default: this checkout; give one several times to run it in
turns, e.g. --root A --root B --root B --root A) is the root of a
checkout whose ctts_tpu_torch is built and run in a process of its own;
the batches, the bucket floor and the measurements come from this
checkout's chip_smoke.py, so every tree is measured alike. For each
tree, at speed 1.0 and 1.5:
  - the repeated cell (chip_smoke.batch_texts: one bucket a batch): the
    served BatchSynthesizer (the wire codec on, as served; and
    wire=False) and, where the tree has the compiled core, its eager
    twin: steady audio-s/s of batches 2-3 (medians of 3 interleaved
    repeats), the host enqueue ms of a shard, and under torch.profiler
    the device kernel ms per batch and the idle share of the 3-batch
    stream and of batches 2-3;
  - the varied cell (chip_smoke.varied_texts: N_VARIED batches whose
    buckets and batch sizes change): the served BatchSynthesizer twice
    (its first pass meets every signature anew) and, where the tree has
    one, the eager twin twice, in turns, with audio-s/s of each pass
    and, with the compiled core, its eager / capture / replay runs.
Every output of a tree (repeated and varied, each way) is hashed batch
by batch; the trees' hashes must be equal, or the exit code is 1.
Prints one JSON line a tree, cell and way, then the comparison, then
the card's name and power limit. Needs one CUDA card.
"""

import argparse
import hashlib
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPEATS = 3


def digests(batches) -> list:
    """One sha1 a batch over its outputs' lengths and bytes, in order."""
    out = []
    for outs in batches:
        h = hashlib.sha1()
        for o in outs:
            h.update(str((o.dtype.str, o.shape)).encode())
            h.update(o.tobytes())
        out.append(h.hexdigest())
    return out


def worker(root: str) -> None:
    sys.path.insert(0, root)
    import numpy as np
    import torch

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from ctts_tpu_torch.config import config_defaults
    from ctts_tpu_torch.db.reader import VoiceDatabase
    from ctts_tpu_torch.ops import hopper
    from ctts_tpu_torch.parallel.batch import BatchSynthesizer

    try:
        from ctts_tpu_torch.synth import compiled
    except ImportError:
        compiled = None
    hopper.build.lib()
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        db = VoiceDatabase(cs.make_voice(tmp))

        def make(**kw):
            return BatchSynthesizer(db, config_defaults(), device=dev,
                                    dims_floor=cs.FLOOR, **kw)

        ways = {"served": make(), "served_plain": make(wire=False)}
        if compiled is not None:
            ways["eager"] = cs.eager_twin(make())
        for speed in (1.0, cs.STRETCH_SPEED):
            enqueue = {k: [] for k in ways}
            for key, bs in ways.items():
                cs.stream_of(torch, bs, cs.N_BATCHES, speed)   # set-up
                cs.timed_method(bs, "_enqueue_shard", enqueue[key])
            walls = {k: ([], []) for k in ways}
            got = {}
            for rep in range(REPEATS):
                for key in (ways if rep % 2 == 0 else list(ways)[::-1]):
                    walls[key][0].append(
                        cs.stream_of(torch, ways[key], 1, speed)[1])
                    got[key], wall = cs.stream_of(torch, ways[key],
                                                  cs.N_BATCHES, speed)
                    walls[key][1].append(wall)
            audio = [sum(o.shape[0] for o in outs) / cs.SAMPLE_RATE
                     for outs in got["served"]]
            for key, bs in ways.items():
                del bs._enqueue_shard
                w1, wn = (sorted(w) for w in walls[key])
                idle = cs.stream_idle(torch, bs, speed)
                idle.pop("top_kernels_ms_per_batch", None)
                print("stream " + json.dumps({
                    "root": root, "speed": speed, "cell": "repeated",
                    "way": key,
                    "steady_audio_s_per_wall_s": sum(audio[1:])
                    / (wn[REPEATS // 2] - w1[REPEATS // 2]),
                    "steady_each": [sum(audio[1:]) / (b - a) for a, b in
                                    zip(walls[key][0], walls[key][1])],
                    "enqueue_ms_median": float(np.median(enqueue[key]))
                    * 1e3,
                    "device": idle, "digests": digests(got[key])}),
                    flush=True)
            order = [("served", ways["served"])]
            if compiled is not None:
                order += [("eager", ways["eager"])] * 2
            order += [("served", ways["served"])]
            for i, (key, bs) in enumerate(order):
                runs = dict(compiled.runs) if compiled is not None else {}
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                outs = list(bs.stream((cs.varied_texts(b)
                                       for b in range(cs.N_VARIED)),
                                      speed=speed))
                wall = time.perf_counter() - t0
                audio = sum(o.shape[0] for b in outs for o in b) \
                    / cs.SAMPLE_RATE
                print("varied " + json.dumps({
                    "root": root, "speed": speed, "cell": "varied",
                    "way": key, "pass": i, "batches": cs.N_VARIED,
                    "audio_s": audio, "wall_s": wall,
                    "audio_s_per_wall_s": audio / wall,
                    "compiled_runs": {
                        k: compiled.runs[k] - runs.get(k, 0)
                        for k in ("eager", "capture", "replay")}
                    if compiled is not None else None,
                    "digests": digests(outs)}), flush=True)


def compare(lines: list) -> dict:
    """Every (speed, cell)'s batch hashes must be one list across trees
    and ways."""
    want, bad = {}, []
    for rec in lines:
        key = (rec["speed"], rec["cell"])
        if key not in want:
            want[key] = rec["digests"]
        elif rec["digests"] != want[key]:
            bad.append({k: rec[k] for k in ("root", "speed", "cell", "way")})
    return {"bit_equal_across_trees": not bad, "compared": len(lines),
            "cells": len(want), "differing": bad}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", action="append")
    ap.add_argument("--worker")
    args = ap.parse_args()
    if args.worker:
        worker(os.path.abspath(args.worker))
        return 0
    rc, lines = 0, []
    for root in args.root or [HERE]:
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--worker", os.path.abspath(root)],
                           stdout=subprocess.PIPE, text=True)
        sys.stdout.write(r.stdout)
        sys.stdout.flush()
        rc = rc or r.returncode
        lines += [json.loads(ln.split(" ", 1)[1])
                  for ln in r.stdout.splitlines()
                  if ln.startswith(("stream {", "varied {"))]
    cmp = compare(lines)
    print("compare " + json.dumps(cmp), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return rc or (0 if cmp["bit_equal_across_trees"] else 1)


if __name__ == "__main__":
    sys.exit(main())
