#!/usr/bin/env python3
"""Device times of the pitch_corr (K2) and assemble (K4) kernels of any
checkout of the port, at chip_smoke.py's phase-4 inputs, and of K2
against the analysis length.

    python3 tools/torch_kernel_times.py [--root DIR]

DIR (default: this checkout) is the root of a checkout whose
ctts_tpu_torch is built and timed; the inputs, the timers and the cases
come from this checkout's chip_smoke.py, so two trees are timed alike
(chip_smoke.py's own phase 4 of an older tree times only one call
bracketed by CUDA events, which for these kernels measures the host's
enqueue). Each case prints the kernel's device time (device_ms: calls
queued behind a spin kernel), its one-call time (time_ms) and whether
it equals the tree's plain version. Then, for n = 2048, 528 and 132 of
the pitch rows, every row at one analysis length L (0, 4, 60, 120,
220), K2's device time: what a row costs before its first multiply-add
(L = 0, 4), how the cost grows with L, and how both change as the card
fills (528 rows = 4 warps on each of 132 SMs, 2048 = 15.5). Needs one
CUDA card.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_times.py: needs a CUDA device", file=sys.stderr)
        return 2
    from ctts_tpu_torch.ops import hopper

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    hopper.build.lib()
    t = cs.kernel_tensors(torch, cs.kernel_inputs(np), torch.device("cuda"))
    for name, (kern, plain, _, _) in cs.kernel_cases(hopper, t).items():
        if not name.startswith(("pitch_corr", "assemble")):
            continue
        equal, _, _ = cs.compare(torch, kern, plain)
        print(f"times {name} " + json.dumps({
            "root": root, "equal": equal,
            "ms": cs.device_ms(kern, 50), "host_ms": cs.time_ms(kern, 20)}),
            flush=True)
    P = hopper.pitch
    for n in (2048, 528, 132):
        s = t["seg"][:n].contiguous()
        for L in (0, 4, 60, 120, 220):
            a = torch.full((n,), L, dtype=torch.int32, device="cuda")
            print(f"sweep pitch_corr n={n} L={L} " + json.dumps({
                "root": root,
                "ms": cs.device_ms(lambda: P.pitch_corr(s, a), 50)}),
                flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
