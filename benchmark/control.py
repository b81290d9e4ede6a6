"""The check's control: the reference put in the program's place, its
samples carried once in bfloat16, held by check.compare to the same
numbers and limits as a run.

    python3 benchmark/control.py --workload batch_1x --seed 7 [--seed 8 ...]

For each seed it answers the texts a run of the cell with that seed
keeps for the check (the window's first draws, as many answers as the
traffic's check_answers, and the longest text), passes the answers
through check.compare as a run's are, and prints one JSON line per seed
with the numbers and whether they pass. The control never passes: the
step from float32 to bfloat16 is the one the limit has to catch. The
benchmark's own runs do not run it; benchmark/tests/test_benchmark_run.py
runs it at the cell's own check size.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control_numbers(cell, seed: int) -> dict:
    """The check's verdict on the control's answers to one seed's texts
    (`cell`: a harness.Cell)."""
    from benchmark import check, generator

    traffic, where = cell.traffic, cell.traffic_dir
    per_item = int(traffic["batch"]) if traffic["loop"] == "stream" else 1
    items = itertools.islice(
        generator.draws(traffic, where, seed, generator.WINDOW),
        -(-int(traffic["check_answers"]) // per_item))
    texts = [t for item in items
             for t in (item if per_item > 1 else [item])]
    longest = max(generator.texts(traffic, where), key=len)
    speed = float(cell.config["speed"])
    n_texts = int(traffic["check_texts"])
    speak = check.reference(cell.config)
    # Only the texts the check speaks need an answer: the others are not
    # compared (compare picks the same texts again from these).
    chosen = set(check.pick_texts(texts + [longest], seed, n_texts, longest))
    answers = [(t, check.bfloat16(speak(t, speed)))
               for t in texts + [longest] if t in chosen]
    numbers, _ = check.compare(cell.config, speed, answers, [], seed,
                               n_texts, longest, speak)
    return {"seed": seed, "correct": check.correct(numbers),
            "check": numbers}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark.harness import Cell, load_json

    cell = Cell(load_json(os.path.join(ROOT, "BENCHMARK.json")),
                args.workload)
    for seed in args.seed:
        print(json.dumps({"workload": args.workload,
                          **control_numbers(cell, seed)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
