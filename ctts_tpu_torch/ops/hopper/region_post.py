"""region_post: CUDA kernel, plain version, launch count.

The energy ramp of apply_phrase_intonation (ctts.c:2841-2865) and the
region tail fade (apply_fade_out, ctts.c:3028-3039) on every region row,
after the contour. No Pallas kernel computed them: on the TPU they were
XLA ops, the vmapped region_post of ctts_tpu/synth/device.py:1567-1593.
The plain version is the body of SynthesisCore._region_post around
dops.tail_fade_window, masked over all B*R*CONTW content samples; the
kernel (csrc/region_post.cu) touches only the samples a row ramps or
fades, one block a region row, in one pass.
"""

from __future__ import annotations

import torch

from ctts_tpu_torch.ops import device_ops as dops
from ctts_tpu_torch.ops.hopper.build import check, launch
from ctts_tpu_torch.ops.luts import sine_fade_table
from ctts_tpu_torch.ops.quant import q16

KERNEL = "region_post"
SOURCE = "ctts_tpu_torch/csrc/region_post.cu"
REPLACES = "ctts_tpu/synth/device.py:1567"
GLOBALS = ("region_post_kernel",)

F32 = torch.float32

launches = 0


def region_post_plain(bufs, comp_lens, offsets, contour, do_dsp, energy,
                      fade_after, MARGIN: int, CONTW: int, FADE2W: int):
    """Rows without an energy ramp keep their content, and a row with
    fade_after 0 writes its window back unchanged. The tail fade is
    min(F, B_r + length) long, B_r = offsets, as apply_fade_out makes it
    over the whole buffer; its part before the region is
    SynthesisCore._fades_before_regions'."""
    M, W = MARGIN, CONTW
    rows = bufs.reshape(-1, bufs.shape[-1])
    lens = comp_lens.reshape(-1)
    cnt = lens[:, None]
    c = contour.reshape(-1, 5)
    es, ee = c[:, 3:4], c[:, 4:5]
    content = rows[:, M:M + W]
    ic = torch.arange(W, device=bufs.device)
    te = ic.to(F32)[None, :] / torch.clamp(cnt - 1, min=1).to(F32)
    ramped = q16(content * (es + (ee - es) * te))
    on = (do_dsp & energy).reshape(-1, 1)
    apply = (ic[None, :] < cnt) & (cnt >= 100) & on
    content.copy_(torch.where(apply, ramped, content))
    dops.tail_fade_window(content, lens, fade_after.reshape(-1),
                          min(FADE2W, W), offsets.reshape(-1))
    return rows.reshape(bufs.shape)


def region_post(bufs, comp_lens, offsets, contour, do_dsp, energy,
                fade_after, MARGIN: int, CONTW: int, FADE2W: int):
    """bufs [B, R, WREG] f32 (content at [MARGIN, MARGIN + CONTW)),
    updated in place and returned; comp_lens, offsets [B, R] i64 (the
    lengths after silence removal, and the samples of the sentence
    before each region); contour [B, R, 5] f32 (es, ee at 3, 4); do_dsp,
    energy [B, R] bool; fade_after [B, R] i32; FADE2W the tail-fade
    window (it covers every min(fade_after, length))."""
    global launches
    if bufs.device.type == "cpu":
        return region_post_plain(bufs, comp_lens, offsets, contour, do_dsp,
                                 energy, fade_after, MARGIN, CONTW, FADE2W)
    if bufs.device.type != "cuda":
        raise ValueError(f"region_post: unsupported device {bufs.device}")
    B, R, WREG = bufs.shape
    dev = bufs.device
    if MARGIN < 0 or CONTW < 0 or MARGIN + CONTW > WREG:
        raise ValueError(f"region_post: MARGIN + CONTW {MARGIN + CONTW} "
                         f"past the region row's {WREG}")
    check(bufs, "bufs", F32, (B, R, WREG), dev)
    check(comp_lens, "comp_lens", torch.int64, (B, R), dev)
    check(offsets, "offsets", torch.int64, (B, R), dev)
    check(contour, "contour", F32, (B, R, 5), dev)
    check(do_dsp, "do_dsp", torch.bool, (B, R), dev)
    check(energy, "energy", torch.bool, (B, R), dev)
    check(fade_after, "fade_after", torch.int32, (B, R), dev)
    launch("ctts_region_post", dev, bufs.data_ptr(), comp_lens.data_ptr(),
           offsets.data_ptr(), contour.data_ptr(), do_dsp.data_ptr(),
           energy.data_ptr(), fade_after.data_ptr(),
           sine_fade_table(dev).data_ptr(), B * R, WREG, MARGIN, CONTW,
           min(FADE2W, CONTW))
    launches += 1
    return bufs
