"""Hand-written Hopper (sm_90a) kernels of the serving path.

One module per Pallas kernel of ctts_tpu/ops/pallas: pitch, compose,
compact and assemble on every path, wsola (both WSOLA kernels) on the
speed != 1.0 path; and six stages the JAX package left to XLA on every
path: silence (the silence-removal tables), contour (the contour and
interrogative-fall zones), region_post (the energy ramp and the region
tail fade), pack_encode (the packed output and its wire encode) and
units (two kernels: unit_base, the bank pick and crossfade curves, and
unit_contrib, the per-unit contributions). Each holds the wrapper (the
CUDA kernel for a CUDA tensor, the plain PyTorch version for a CPU
tensor), the plain version itself or its import, a launch counter that
only a kernel launch increments, and GLOBALS, the __global__ functions
a launch runs; MODULES lists, per kernel, what holds these (units holds
one such record a kernel; wsola's module counts the emit, its
decide_kernel the decide, which the serving loop launches once a batch
over every stretch bucket). Under
CUDA graph capture a launch is recorded, not run: recorded_launches
takes such counts back, and each replay of the graph adds them
(synth/compiled.py); chip_smoke.py holds the counts to the GLOBALS a
profiler trace shows.
"""

from __future__ import annotations

from contextlib import contextmanager

from ctts_tpu_torch.ops.hopper import (
    assemble,
    compact,
    compose,
    contour,
    pack_encode,
    pitch,
    region_post,
    silence,
    units,
    wsola,
)

MODULES = (pitch, compose, silence, compact, contour, region_post,
           assemble, wsola, wsola.decide_kernel, pack_encode,
           units.base_kernel, units.contrib_kernel)


def reset_launches() -> None:
    for m in MODULES:
        m.launches = 0


def launch_counts() -> dict:
    return {m.KERNEL: m.launches for m in MODULES}


def add_launches(counts: dict) -> None:
    for m in MODULES:
        m.launches += counts.get(m.KERNEL, 0)


@contextmanager
def recorded_launches():
    """Yields a dict that receives, on exit, the launches the enclosed
    calls counted (those a graph capture records); the counters are set
    back to their values on entry."""
    before = launch_counts()
    recorded: dict = {}
    try:
        yield recorded
    finally:
        after = launch_counts()
        for m in MODULES:
            m.launches = before[m.KERNEL]
        recorded.update({k: after[k] - before[k] for k in after})
