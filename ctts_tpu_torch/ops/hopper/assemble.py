"""Sentence assembly: CUDA kernel, plain version, launch count.

Counterpart of ctts_tpu/ops/pallas/assemble.py:72 assemble_regions,
batched over sentences: region rows overlap-add into the sentence
buffer at their cumsum offsets, in ascending region order, each row
contributing its first live_len samples (ctts.c:2951-3012).
"""

from __future__ import annotations

import torch

from ctts_tpu_torch.ops.hopper.build import check, launch

KERNEL = "assemble"
SOURCE = "ctts_tpu_torch/csrc/assemble.cu"
REPLACES = "ctts_tpu/ops/pallas/assemble.py:72"
# The __global__ functions one launch runs, each once (as a profiler
# trace names them).
GLOBALS = ("assemble_kernel",)

launches = 0


def assemble_plain(bufs, offsets, live_len, WREG: int, OUTW: int):
    """The unrolled region loop of ctts_tpu/synth/device.py:1621-1633:
    read the WREG-wide window at the offset, add the masked row, write
    it back."""
    B, R = offsets.shape
    sent = torch.zeros(B, OUTW + WREG, dtype=torch.float32,
                       device=bufs.device)
    iw = torch.arange(WREG, device=bufs.device)
    rows = bufs.reshape(B, R, WREG)
    for r in range(R):
        row = torch.where(iw < live_len[:, r, None], rows[:, r], 0.0)
        idx = offsets[:, r, None].long() + iw
        sent.scatter_(1, idx, sent.gather(1, idx) + row)
    return sent[:, :OUTW]


def assemble(bufs, offsets, live_len, WREG: int, OUTW: int):
    """bufs [B, R*WREG] f32; offsets, live_len [B, R] i32 ->
    [B, OUTW] f32 (OUTW = MARGIN + SMAX)."""
    global launches
    if bufs.device.type == "cpu":
        return assemble_plain(bufs, offsets, live_len, WREG, OUTW)
    if bufs.device.type != "cuda":
        raise ValueError(f"assemble: unsupported device {bufs.device}")
    B, R = offsets.shape
    dev = bufs.device
    check(bufs, "bufs", torch.float32, (B, R * WREG), dev)
    check(offsets, "offsets", torch.int32, (B, R), dev)
    check(live_len, "live_len", torch.int32, (B, R), dev)
    out = torch.empty(B, OUTW, dtype=torch.float32, device=dev)
    launch("ctts_assemble", dev, bufs.data_ptr(), offsets.data_ptr(),
           live_len.data_ptr(), out.data_ptr(), B, R, WREG, OUTW)
    launches += 1
    return out
