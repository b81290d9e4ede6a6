"""Contour and interrogative-fall zones: CUDA kernel, plain version,
launch count.

The phrase-intonation pitch contour on each DSP region's content (the
rise segment of a split question) and the interrogative fall on the
question-final regions (apply_smooth_pitch_contour, ctts.c:2206-2273).
No Pallas kernel computed them: on the TPU they were XLA ops, the
compact frame workspace and the question-final while_loop of
ctts_tpu/synth/device.py:1324-1565. The plain version is the body of
SynthesisCore._contour around dops.contour_zones (frames of every
segment in a [B, K, 256] workspace, K = zone_slots(SMAX, 2R)); the
kernel (csrc/contour.cu) computes each output position from the two
frames that cover it, one block a region row.
"""

from __future__ import annotations

import torch

from ctts_tpu_torch.ops import device_ops as dops
from ctts_tpu_torch.ops.hopper.build import check, launch
from ctts_tpu_torch.ops.luts import hann

KERNEL = "contour_zones"
SOURCE = "ctts_tpu_torch/csrc/contour.cu"
REPLACES = "ctts_tpu/synth/device.py:1324"
GLOBALS = ("contour_zones_kernel",)

F32 = torch.float32

launches = 0


def contour_plain(bufs, comp_lens, contour, qfinal, do_dsp, active,
                  MARGIN: int, SMAX: int):
    """Per region, segment 0 is the contour and segment 1 the fall; a
    segment of a region that does not carry it gets count 0 and no
    slots."""
    B, R = bufs.shape[:2]
    cnt = comp_lens.long()
    c = contour
    rise = (cnt.to(F32) * 0.6).to(torch.int64)
    split = (rise > 100) & (cnt - rise > 100)
    split1 = qfinal & split
    fall = qfinal & do_dsp & active
    zero = torch.zeros_like(cnt)
    region = torch.arange(R, device=bufs.device).expand(B, R)

    def pair(a, b):        # [B, R] x 2 -> [B, 2R], region-major
        return torch.stack([a, b], 2).reshape(B, 2 * R)

    return dops.contour_zones(
        bufs, MARGIN, pair(region, region), pair(zero, rise),
        pair(torch.where(do_dsp, torch.where(split1, rise, cnt), 0),
             torch.where(fall & split, cnt - rise, 0)),
        pair(c[..., 0], c[..., 2]),
        pair(torch.where(split1, c[..., 2], c[..., 1]), c[..., 1]),
        dops.zone_slots(SMAX, 2 * R))


def contour_zones(bufs, comp_lens, contour, qfinal, do_dsp, active,
                  MARGIN: int, SMAX: int):
    """bufs [B, R, WREG] f32 (region content at MARGIN), updated in
    place and returned; comp_lens [B, R] i64 (the lengths after silence
    removal); contour [B, R, 5] f32 (ws, we, peak, es, ee); qfinal,
    do_dsp, active [B, R] bool. SMAX sizes the plain version's
    workspace."""
    global launches
    if bufs.device.type == "cpu":
        return contour_plain(bufs, comp_lens, contour, qfinal, do_dsp,
                             active, MARGIN, SMAX)
    if bufs.device.type != "cuda":
        raise ValueError(f"contour_zones: unsupported device {bufs.device}")
    B, R, WREG = bufs.shape
    dev = bufs.device
    if not 0 <= MARGIN < WREG:
        raise ValueError(f"contour_zones: MARGIN {MARGIN} outside the "
                         f"region row's {WREG}")
    check(bufs, "bufs", F32, (B, R, WREG), dev)
    check(comp_lens, "comp_lens", torch.int64, (B, R), dev)
    check(contour, "contour", F32, (B, R, 5), dev)
    for name, t in (("qfinal", qfinal), ("do_dsp", do_dsp),
                    ("active", active)):
        check(t, name, torch.bool, (B, R), dev)
    launch("ctts_contour_zones", dev, bufs.data_ptr(), comp_lens.data_ptr(),
           contour.data_ptr(), qfinal.data_ptr(), do_dsp.data_ptr(),
           active.data_ptr(), hann(dops.FR, dev).data_ptr(), B * R, WREG,
           MARGIN)
    launches += 1
    return bufs
