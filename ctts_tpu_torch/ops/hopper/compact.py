"""Silence-removal compaction: CUDA kernel, plain version, launch count.

Counterpart of ctts_tpu/ops/pallas/compact.py:89 compact_units, batched
over sentences: inside each region row of the flat [R*WREG] buffer,
segment s (< NBLK) with seg_len > 0 moves from starts[s] to dst[s]
(ctts.c:1634-1690); every other position keeps its content. The plain
version is ops/device_ops.py move_segments over the region rows. The
kernel (csrc/compact.cu) writes every output position once, from a
grid over region rows that does not grow with NBLK; the segments with
seg_len > 0 must have ascending, disjoint destinations, as silence
removal makes them.
"""

from __future__ import annotations

import torch

from ctts_tpu_torch.ops import device_ops as dops
from ctts_tpu_torch.ops.hopper.build import check, launch

KERNEL = "compact"
SOURCE = "ctts_tpu_torch/csrc/compact.cu"
REPLACES = "ctts_tpu/ops/pallas/compact.py:89"
GLOBALS = ("compact_kernel",)

# The widest table the kernel's shared memory holds (3 ints a slot).
MAX_NBLK = 16384

launches = 0


def compact_plain(bufs, starts, dst, seg_len, WREG: int):
    B, R, NBLK = starts.shape
    out = dops.move_segments(bufs.reshape(B * R, WREG),
                             starts.reshape(B * R, NBLK),
                             dst.reshape(B * R, NBLK),
                             seg_len.reshape(B * R, NBLK))
    return out.reshape(B, R * WREG)


def compact(bufs, starts, dst, seg_len, WREG: int):
    """bufs [B, R*WREG] f32; starts, dst, seg_len [B, R, NBLK] i32
    (region-local, MARGIN included) -> compacted [B, R*WREG]."""
    global launches
    if bufs.device.type == "cpu":
        return compact_plain(bufs, starts, dst, seg_len, WREG)
    if bufs.device.type != "cuda":
        raise ValueError(f"compact: unsupported device {bufs.device}")
    B, R, NBLK = starts.shape
    dev = bufs.device
    if not 0 < NBLK <= MAX_NBLK:
        raise ValueError(f"compact: NBLK {NBLK} outside [1, {MAX_NBLK}]")
    check(bufs, "bufs", torch.float32, (B, R * WREG), dev)
    for name, t in (("starts", starts), ("dst", dst), ("seg_len", seg_len)):
        check(t, name, torch.int32, (B, R, NBLK), dev)
    out = torch.empty_like(bufs)
    launch("ctts_compact", dev, bufs.data_ptr(), out.data_ptr(),
           starts.data_ptr(), dst.data_ptr(), seg_len.data_ptr(),
           B, R, WREG, NBLK)
    launches += 1
    return out
