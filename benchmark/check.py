"""How `correct` is decided: the answers the timed path gave, held to the
benchmark's reference (benchmark/reference/), and the control.

After the window closes, the kept answers (harness.Keep: batches or
calls drawn from the seed, and answers of the corpus's longest text) are
compared with the reference's samples for their texts. The reference
speaks `check_texts` distinct texts of them at most: the longest, and
others drawn from the seed; every kept answer of those texts is
compared. The numbers, each with its limit:
  - failed: answers from the window's opening to the end of the drain
    that did not come as one row of int16 samples (limit 0);
  - length_mismatch: compared answers whose length is not the
    reference's (limit 0);
  - max_lsb: the largest difference of a sample from the reference's,
    in int16 steps, over every compared answer (the configuration's
    "check" limit);
  - compared: how many answers were compared (at least 1).
The control (control.py) puts the reference in the program's place,
its samples carried once in bfloat16, the nearest precision below the
float32 that the program's rows hold them in.
"""

from __future__ import annotations

import functools
import sys
import time

import numpy as np

from benchmark import generator, voice
from benchmark.reference import Reference


def pick_texts(texts, seed: int, n: int, longest: str) -> list:
    """The texts the reference speaks: `longest` where it is among
    `texts`, then others drawn from the seed, n in all at most."""
    others = sorted(t for t in set(texts) if t != longest)
    order = generator.rng(seed, generator.CHECK).permutation(len(others))
    head = [longest] if longest in texts else []
    return head + [others[i] for i in order[:max(n - len(head), 0)]]


def max_lsb(a: np.ndarray, b: np.ndarray) -> int:
    if a.size == 0:
        return 0
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


def reference(cfg_file: dict):
    """The configuration's reference: speak(text, speed) -> int16
    samples, each (text, speed) made once."""
    return functools.lru_cache(maxsize=None)(
        Reference(cfg_file["config"], voice.units()).synthesize)


def compare(cfg_file: dict, speed: float, answers: list, done: list,
            seed: int, n_texts: int, longest: str, speak=None) -> tuple:
    """(the numbers with their limits, what else the check saw).
    `speak`: the reference (reference(cfg_file) where None)."""
    t0 = time.perf_counter()
    chosen = pick_texts([t for t, _ in answers], seed, n_texts, longest)
    speak = speak or reference(cfg_file)
    want = {t: speak(t, speed) for t in chosen}
    compared = mismatch = worst = 0
    for text, got in answers:
        if text not in want:
            continue
        if not (isinstance(got, np.ndarray) and got.dtype == np.int16
                and got.ndim == 1):
            continue        # counted under failed
        compared += 1
        if got.shape != want[text].shape:
            mismatch += 1
        else:
            worst = max(worst, max_lsb(got, want[text]))
    failed = sum(int((lens < 0).sum()) for _, _, lens in done)
    numbers = {
        "failed": {"value": failed, "limit": 0},
        "length_mismatch": {"value": mismatch, "limit": 0},
        "max_lsb": {"value": worst,
                    "limit": cfg_file["check"]["max_lsb"]},
        "compared": {"value": compared, "limit": 1, "at_least": True},
    }
    info = {"check_texts": len(chosen), "check_longest_compared":
            any(t == longest for t, _ in answers),
            "check_s": time.perf_counter() - t0}
    return numbers, info


def correct(numbers: dict) -> bool:
    return all((n["value"] >= n["limit"]) if n.get("at_least")
               else (n["value"] <= n["limit"]) for n in numbers.values())


def report(numbers: dict, stream=None) -> None:
    """Each number beside its limit, one line each: the run's last lines
    on standard error."""
    stream = stream or sys.stderr
    for name, n in numbers.items():
        op = ">=" if n.get("at_least") else "<="
        print(f"check {name} {n['value']} {op} {n['limit']}", file=stream,
              flush=True)


def bfloat16(x: np.ndarray) -> np.ndarray:
    """int16 samples carried once in bfloat16 (round to nearest even),
    back to int16."""
    u = x.astype(np.float32).view(np.uint32)
    u = (u + np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1))) \
        & np.uint32(0xFFFF0000)
    f = u.view(np.float32)
    return np.clip(f, -32768, 32767).astype(np.int16)
