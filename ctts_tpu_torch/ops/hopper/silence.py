"""Silence-removal tables: CUDA kernel, plain version, launch count.

The kept-segment tables of every region row (remove_silence_regions,
ctts.c:1634-1690), as SynthesisCore._seg_tables returns them. No Pallas
kernel computed them: on the TPU they were XLA ops, the seg_table pass
of ctts_tpu/synth/device.py:1276 around dops.silence_segments
(ctts_tpu/ops/device_ops.py:491). The plain version is that pass over
the region rows (ops/device_ops.py silence_segments, the remove mask,
MARGIN, dst and the overflow count); the kernel (csrc/silence.cu)
finds the same segments from silent runs, one block a region row.
"""

from __future__ import annotations

import torch

from ctts_tpu_torch.ops import device_ops as dops
from ctts_tpu_torch.ops.hopper.build import check, launch

KERNEL = "silence_tables"
SOURCE = "ctts_tpu_torch/csrc/silence.cu"
REPLACES = "ctts_tpu/synth/device.py:1276"
GLOBALS = ("silence_tables_kernel",)

# The widest table the kernel's shared memory holds (2 ints a slot).
MAX_NBLK = 16384

launches = 0


def silence_tables_plain(bufs, region_len, region_remove, threshold,
                         min_silence: int, nblk: int, MARGIN: int,
                         CONTW: int):
    B, R = region_len.shape
    WREG = bufs.shape[1] // R
    content = bufs.reshape(B * R, WREG)[:, MARGIN:MARGIN + CONTW]
    thr = threshold[:, None].expand(B, R).reshape(-1)
    length = region_len.reshape(-1)
    starts, seg_len, new_len, ovf = dops.silence_segments(
        content, length, thr, min_silence, nblk)
    remove = region_remove.reshape(-1)
    starts = torch.where(remove[:, None], starts, 0)
    seg_len = torch.where(remove[:, None], seg_len, 0)
    new_len = torch.where(remove, new_len, length.long())
    dst = MARGIN + torch.cumsum(seg_len, dim=-1) - seg_len
    ovf_count = (ovf & remove).reshape(B, R).sum(1).to(torch.int32)

    def table(x):
        return x.reshape(B, R, nblk).to(torch.int32).contiguous()

    return (table(starts + MARGIN), table(dst), table(seg_len),
            new_len.reshape(B, R), ovf_count)


def silence_tables(bufs, region_len, region_remove, threshold,
                   min_silence: int, nblk: int, MARGIN: int, CONTW: int):
    """bufs [B, R*WREG] f32 (region content at [MARGIN, MARGIN + CONTW)
    of each row); region_len [B, R] i32; region_remove [B, R] bool;
    threshold [B] f32 -> (starts, dst, seg_len [B, R, nblk] i32 with
    MARGIN included, new_len [B, R] i64, ovf_count [B] i32: the removed
    regions with more than nblk kept segments)."""
    global launches
    if bufs.device.type == "cpu":
        return silence_tables_plain(bufs, region_len, region_remove,
                                    threshold, min_silence, nblk, MARGIN,
                                    CONTW)
    if bufs.device.type != "cuda":
        raise ValueError(f"silence_tables: unsupported device {bufs.device}")
    B, R = region_len.shape
    WREG = bufs.shape[1] // R
    dev = bufs.device
    if not 0 < nblk <= MAX_NBLK:
        raise ValueError(f"silence_tables: nblk {nblk} outside "
                         f"[1, {MAX_NBLK}]")
    if MARGIN + CONTW > WREG:
        raise ValueError(f"silence_tables: MARGIN + CONTW {MARGIN + CONTW} "
                         f"past the region row's {WREG}")
    check(bufs, "bufs", torch.float32, (B, R * WREG), dev)
    check(region_len, "region_len", torch.int32, (B, R), dev)
    check(region_remove, "region_remove", torch.bool, (B, R), dev)
    check(threshold, "threshold", torch.float32, (B,), dev)
    # As silence_segments: keep_n samples of a run stay, and a run of
    # min_run or more loses the rest (min_run >= 11, which bounds the
    # gaps the kernel finds in 32 samples).
    keep_n = max(min_silence // 4, 10)
    min_run = max(max(min_silence, 1), keep_n + 1)
    starts = torch.empty((B, R, nblk), dtype=torch.int32, device=dev)
    dst = torch.empty_like(starts)
    seg_len = torch.empty_like(starts)
    new_len = torch.empty((B, R), dtype=torch.int64, device=dev)
    ovf_count = torch.empty((B,), dtype=torch.int32, device=dev)
    launch("ctts_silence_tables", dev, bufs.data_ptr(),
           region_len.data_ptr(), region_remove.data_ptr(),
           threshold.data_ptr(), starts.data_ptr(), dst.data_ptr(),
           seg_len.data_ptr(), new_len.data_ptr(), ovf_count.data_ptr(),
           B, R, WREG, MARGIN, CONTW, keep_n, min_run, nblk)
    launches += 1
    return starts, dst, seg_len, new_len, ovf_count
