"""Unit placement (compose): CUDA kernel, plain version, launch count.

Counterpart of ctts_tpu/ops/pallas/compose.py:145 compose_units, batched
over sentences. Units k = 0..U-1 of each sentence are placed in order
into its flat [R*WREG] buffer at base_off[k] (ctts.c:3279-3358):
the crossfade prefix i < cf becomes
trunc(clip(trunc(cur * fo + x), -32768, 32767)) and the body up to
n_eff is copied. With `export`, each unit's pre-merge pitch segment
buf[off+cf-ana, +512) and energy tail buf[off+cf-CFMAX, off+cf) are
returned as well. Inactive slots (n_eff == 0) change nothing and
export zeros. The kernel computes each position of the buffer as the
walk over the units that cover it (csrc/compose.cu) and writes it once.
"""

from __future__ import annotations

import torch

from ctts_tpu_torch.ops.hopper.build import check, launch
from ctts_tpu_torch.ops.quant import q16, trunc16

KERNEL = "compose"
SOURCE = "ctts_tpu_torch/csrc/compose.cu"
REPLACES = "ctts_tpu/ops/pallas/compose.py:145"
GLOBALS = ("compose_kernel",)

SEGW = 512

launches = 0


def compose_plain(contrib, fo, base_off, cf_in, n_eff, ana, TOT: int,
                  export: bool):
    """Python loop over units, batched over sentences with gathers and
    scatters on the flat buffers."""
    B, U, UBUF = contrib.shape
    CFMAX = fo.shape[2]
    dev = contrib.device
    flat = torch.zeros(B, TOT, dtype=torch.float32, device=dev)
    seg = torch.zeros(B, U, SEGW, dtype=torch.float32, device=dev)
    tail = torch.zeros(B, U, CFMAX, dtype=torch.float32, device=dev)
    iu = torch.arange(UBUF, device=dev)
    isg = torch.arange(SEGW, device=dev)
    itl = torch.arange(CFMAX, device=dev)
    for k in range(U):
        n = n_eff[:, k].long()
        live = n > 0
        # Inactive slots read an in-bounds window and write it back.
        off = torch.where(live, base_off[:, k].long(), 2 * CFMAX)
        cf = cf_in[:, k].long()
        if export:
            s0 = torch.where(live, off + cf - ana[:, k].long(), 0)
            t0 = torch.where(live, off + cf - CFMAX, 0)
            seg[:, k] = torch.where(live[:, None],
                                    flat.gather(1, s0[:, None] + isg), 0.0)
            tail[:, k] = torch.where(live[:, None],
                                     flat.gather(1, t0[:, None] + itl), 0.0)
        widx = off[:, None] + iu
        cur = flat.gather(1, widx)
        x = contrib[:, k]
        mixed = q16(trunc16(cur[:, :CFMAX] * fo[:, k] + x[:, :CFMAX]))
        head = torch.where(itl < cf[:, None], mixed, x[:, :CFMAX])
        x = torch.cat([head, x[:, CFMAX:]], dim=1)
        flat.scatter_(1, widx, torch.where(iu < n[:, None], x, cur))
    return flat, seg, tail


def compose(contrib, fo, base_off, cf_in, n_eff, ana, TOT: int,
            export: bool):
    """contrib [B,U,UBUF], fo [B,U,CFMAX] f32; base_off, cf_in, n_eff,
    ana [B,U] i32 -> (buf [B,TOT], seg [B,U,512], tail [B,U,CFMAX]).
    Without `export`, seg and tail are zeros (on the card, read-only
    views of one zero)."""
    global launches
    if contrib.device.type == "cpu":
        return compose_plain(contrib, fo, base_off, cf_in, n_eff, ana, TOT,
                             export)
    if contrib.device.type != "cuda":
        raise ValueError(f"compose: unsupported device {contrib.device}")
    B, U, UBUF = contrib.shape
    CFMAX = fo.shape[2]
    dev = contrib.device
    check(contrib, "contrib", torch.float32, (B, U, UBUF), dev)
    check(fo, "fo", torch.float32, (B, U, CFMAX), dev)
    for name, t in (("base_off", base_off), ("cf_in", cf_in),
                    ("n_eff", n_eff), ("ana", ana)):
        check(t, name, torch.int32, (B, U), dev)
    buf = torch.empty(B, TOT, dtype=torch.float32, device=dev)
    if export:
        seg = torch.empty(B, U, SEGW, dtype=torch.float32, device=dev)
        tail = torch.empty(B, U, CFMAX, dtype=torch.float32, device=dev)
    else:
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        seg, tail = zero.expand(B, U, SEGW), zero.expand(B, U, CFMAX)
    launch("ctts_compose", dev, contrib.data_ptr(), fo.data_ptr(),
           base_off.data_ptr(), cf_in.data_ptr(), n_eff.data_ptr(),
           ana.data_ptr(), buf.data_ptr(), seg.data_ptr(), tail.data_ptr(),
           B, U, UBUF, CFMAX, TOT, int(export))
    launches += 1
    return buf, seg, tail
