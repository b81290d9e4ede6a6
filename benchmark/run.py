"""The port's benchmark, one run of one cell on one CUDA card:

    python3 benchmark/run.py --workload batch_1x --seed 7 --seconds 20 --trace 0

Run from the root of a checkout. The cell, its configuration, traffic
and metrics are read from BENCHMARK.json and the files it names under
benchmark/ (harness.py). With --trace 0 the result's metrics are the
cell's end-to-end metrics, with --trace 1 its per-layer metrics, from a
torch.profiler trace of the window and the host calls the harness wraps.

Standard output: one line {"info": ...} with the run's counts and
medians, then the result as the last line: correct, attempted, failed,
metrics, device (breakdown with --trace 1) and, last, check: each number
compared with the reference beside its limit, as the last lines of
standard error repeat them. Exit 2 and no result without a CUDA card (or
with fewer than the cell asks for), 3 where a module of JAX or of the
JAX package was loaded; any other failure raises.

Build and kernel caches stay inside the checkout: the port's own
(ctts_tpu_torch/_build, its runtime's make) and, for any library that
reads them, TORCH_EXTENSIONS_DIR and TRITON_CACHE_DIR under .benchcache/,
where the generated voice is kept too.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _process_start() -> float:
    """The process's start on the perf_counter clock (Linux's
    /proc/self/stat; now, where that cannot be read)."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        age = (time.clock_gettime(time.CLOCK_BOOTTIME)
               - int(fields[19]) / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now
    return now - max(age, 0.0)


T0 = _process_start()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    with open(os.path.join(ROOT, "BENCHMARK.json"), encoding="utf-8") as f:
        spec = json.load(f)
    chips = {w["name"]: w["chips"] for w in spec["workloads"]}
    if args.workload not in chips:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    cache = os.path.join(ROOT, ".benchcache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")

    import torch

    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < chips[args.workload]:
        print(f"{args.workload}: needs {chips[args.workload]} CUDA "
              f"card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2

    sys.path.insert(0, ROOT)
    from benchmark.check import report
    from benchmark.harness import forbidden_modules, run_cell

    result = run_cell(ROOT, spec, args.workload, args.seed, args.seconds,
                      bool(args.trace), T0)
    found = forbidden_modules()
    if found:
        print("loaded in the measured process: " + ", ".join(found),
              file=sys.stderr)
        return 3
    print(json.dumps({"info": result.pop("info")}), flush=True)
    print(json.dumps(result), flush=True)
    report(result["check"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
