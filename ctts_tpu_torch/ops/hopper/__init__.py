"""Hand-written Hopper (sm_90a) kernels of the serving path.

One module per Pallas kernel of ctts_tpu/ops/pallas: pitch, compose,
compact and assemble on every path, wsola (both WSOLA kernels) on the
speed != 1.0 path. Each holds the wrapper (the CUDA kernel for a CUDA
tensor, the plain PyTorch version for a CPU tensor), the plain version
itself or its import, and a launch counter that only a kernel launch
increments.
"""

from __future__ import annotations

from ctts_tpu_torch.ops.hopper import (
    assemble,
    compact,
    compose,
    pitch,
    wsola,
)

MODULES = (pitch, compose, compact, assemble, wsola)


def reset_launches() -> None:
    for m in MODULES:
        m.launches = 0


def launch_counts() -> dict:
    return {m.KERNEL: m.launches for m in MODULES}
