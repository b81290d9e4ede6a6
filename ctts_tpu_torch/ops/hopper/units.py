"""The unit stage: two CUDA kernels, their plain versions, launch counts.

unit_base (once a batch): the bank pick base = q16(bank[uid] * gain)
with its head columns, the int sum of its body and the crossfade curves
fo, fi of each unit slot (prepare_base and the set-up of
make_contrib_fn, ctts_tpu/synth/device.py:761, :841-886). unit_contrib
(once a refine trip and once in the epilogue): the contributions
[B, U, W] that the compose kernel places, from the current heads: the
DC shift, the sine fade-in, the crossfade weighting and the masks
(contrib_fn, ctts_tpu/synth/device.py:887-918). No Pallas kernel
computed them: on the TPU they were XLA ops. The plain versions are
SynthesisCore's former _prepare_base and _make_contrib_fn, which pick
each curve from a table of the batch's distinct lengths (cf_values,
fade_values); the kernels (csrc/units.cu) evaluate it per unit, which
gives the same bits. Neither keeps base past its head columns: the
contributions recompute its body from the bank.

Widths: W = max(UBUF, CFMAX) (base is zero-padded to CFMAX where a
crossfade is wider than the bank), HW = max(CFMAX, min(PITCH_SPAN, W))
the head columns that head pitch and boundary_heads read.
"""

from __future__ import annotations

import torch

from ctts_tpu_torch.ops.hopper.build import Kernel, check, launch
from ctts_tpu_torch.ops.luts import (
    fade_in_gain,
    fade_in_table,
    fade_out_gain,
    fade_out_table,
    sine_fade_gain,
    sine_fade_table,
)
from ctts_tpu_torch.ops.quant import q16, trunc16

SOURCE = "ctts_tpu_torch/csrc/units.cu"
F32 = torch.float32


base_kernel = Kernel("unit_base", SOURCE, "ctts_tpu/synth/device.py:761",
                     ("unit_base_kernel",))
contrib_kernel = Kernel("unit_contrib", SOURCE,
                        "ctts_tpu/synth/device.py:887",
                        ("unit_contrib_kernel",))


def widths(ubuf: int, CFMAX: int, pitch_span: int) -> tuple:
    """(W, HW) of a bank of width ubuf."""
    W = max(ubuf, CFMAX)
    return W, max(CFMAX, min(pitch_span, W))


def _value_index(v: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Index of each v in the deduped value table (exactly one hit; the
    table's 0 padding never matches)."""
    return (v[..., None] == values).to(torch.int32).argmax(-1)


def _units(lengths, unit_id):
    uid = torch.clamp(unit_id.long(), min=0)
    active = unit_id >= 0
    return uid, active, torch.where(active, lengths[uid], 0).long()


def _base(bank, gains, uid, W: int):
    base = q16(bank[uid] * gains[uid][..., None])
    if W > bank.shape[1]:
        base = torch.nn.functional.pad(base, (0, W - bank.shape[1]))
    return base


def unit_base_plain(bank, gains, lengths, unit_id, unit_cf_in, cf_values,
                    CFMAX: int, HW: int, remove_dc: bool):
    """The crossfade curves are evaluated once per distinct length of
    the batch (cf_values) and picked per unit."""
    uid, _, n = _units(lengths, unit_id)
    W = max(bank.shape[1], CFMAX)
    base = _base(bank, gains, uid, W)
    it = torch.arange(CFMAX, device=bank.device).to(F32)
    cfv = cf_values.long()
    tmixv = it[None, :] * (1.0 / torch.clamp(cfv, min=1).to(F32))[:, None]
    pick = _value_index(torch.clamp(unit_cf_in.long(), min=1), cfv)
    if remove_dc:
        iu = torch.arange(W, device=bank.device)
        body = (iu >= CFMAX) & (iu < n[..., None])
        tail_total = torch.where(body, base, 0.0).to(torch.int32).sum(
            -1).to(torch.int32)
    else:
        tail_total = torch.zeros(unit_id.shape, dtype=torch.int32,
                                 device=bank.device)
    return (base[..., :CFMAX].clone(), base[..., :HW].clone(), tail_total,
            fade_out_gain(tmixv)[pick], fade_in_gain(tmixv)[pick])


def unit_base(bank, gains, lengths, unit_id, unit_cf_in, cf_values,
              CFMAX: int, HW: int, remove_dc: bool):
    """bank [N, UBUF] f32, gains [N] f32, lengths [N] i32 (each <=
    UBUF); unit_id, unit_cf_in [B, U] i32; cf_values [NCF] i32 (the
    batch's distinct max(cf_in, 1), 0-padded: the plain version's table)
    -> (heads [B, U, CFMAX], hcols [B, U, HW], tail_total [B, U] i32 (0
    without remove_dc), fo, fi [B, U, CFMAX]), f32 but tail_total."""
    if bank.device.type == "cpu":
        return unit_base_plain(bank, gains, lengths, unit_id, unit_cf_in,
                               cf_values, CFMAX, HW, remove_dc)
    if bank.device.type != "cuda":
        raise ValueError(f"unit_base: unsupported device {bank.device}")
    dev = bank.device
    N, UBUF = bank.shape
    B, U = unit_id.shape
    if not CFMAX <= HW <= max(UBUF, CFMAX):
        raise ValueError(f"unit_base: HW {HW} outside [CFMAX {CFMAX}, "
                         f"{max(UBUF, CFMAX)}]")
    check(bank, "bank", F32, (N, UBUF), dev)
    check(gains, "gains", F32, (N,), dev)
    check(lengths, "lengths", torch.int32, (N,), dev)
    check(unit_id, "unit_id", torch.int32, (B, U), dev)
    check(unit_cf_in, "unit_cf_in", torch.int32, (B, U), dev)
    heads = torch.empty((B, U, CFMAX), dtype=F32, device=dev)
    hcols = torch.empty((B, U, HW), dtype=F32, device=dev)
    tail_total = torch.empty((B, U), dtype=torch.int32, device=dev)
    fo = torch.empty_like(heads)
    fi = torch.empty_like(heads)
    launch("ctts_unit_base", dev, bank.data_ptr(), gains.data_ptr(),
           lengths.data_ptr(), unit_id.data_ptr(), unit_cf_in.data_ptr(),
           fade_out_table(dev).data_ptr(), fade_in_table(dev).data_ptr(),
           heads.data_ptr(), hcols.data_ptr(), tail_total.data_ptr(),
           fo.data_ptr(), fi.data_ptr(), B * U, UBUF, CFMAX, HW,
           int(remove_dc))
    base_kernel.launches += 1
    return heads, hcols, tail_total, fo, fi


def unit_contrib_plain(heads, bank, gains, lengths, unit_id, unit_cf_in,
                       unit_fade_in, tail_total, fi, fade_values,
                       fade_in_samples: int, remove_dc: bool):
    """Everything past the first CFMAX columns is base but for the
    scalar DC shift; with remove_dc off (a static branch) no DC is
    taken out; a fade-in longer than CFMAX also fades the body columns
    it covers. The fade-in curve is picked from fade_values."""
    CFMAX = heads.shape[-1]
    W = max(bank.shape[1], CFMAX)
    dev = heads.device
    uid, active_u, n_u = _units(lengths, unit_id)
    base = _base(bank, gains, uid, W)
    n = n_u[..., None]
    active = active_u[..., None]
    cf_in = unit_cf_in.long()[..., None]
    fade_in = unit_fade_in[..., None]
    iu = torch.arange(W, device=dev)
    ih = torch.arange(CFMAX, device=dev)
    body = (iu >= CFMAX) & (iu < n)

    # apply_fade_in fades min(fade_in_samples, n) samples of a unit.
    FW = min(-(-fade_in_samples // 128) * 128, W)
    ifw = torch.arange(FW, device=dev)
    fade = torch.clamp(n, max=fade_in_samples)                  # [B, U, 1]
    fv = fade_values.long()
    tfv = ifw.to(F32)[None, :] * (
        1.0 / torch.clamp(fv, min=1).to(F32))[:, None]
    fade_gain = sine_fade_gain(tfv)[
        _value_index(torch.clamp(fade[..., 0], min=1), fv)]
    in_fade = (ifw < fade) & (fade > 0)
    live_h = ih < n
    keep_h = live_h & active
    mix_h = (ih < cf_in) & ~fade_in
    body_live = body & active
    HF = min(FW, CFMAX)

    if remove_dc:
        head_total = torch.where(live_h, heads, 0.0).to(torch.int32).sum(-1)
        total = head_total + tail_total
        dc = torch.sign(total) * torch.div(
            torch.abs(total), torch.clamp(n[..., 0], min=1),
            rounding_mode="floor")
        dcf = dc.to(F32)[..., None]
        xh = torch.where(live_h, torch.clamp(heads - dcf, -32768.0,
                                             32767.0), heads)
        out = torch.where(body_live, torch.clamp(
            base - dcf, -32768.0, 32767.0), 0.0)
    else:
        xh = heads
        out = torch.where(body_live, base, 0.0)
    hf = xh[..., :HF]
    hf = torch.where(in_fade[..., :HF], trunc16(hf * fade_gain[..., :HF]), hf)
    xh = torch.where(fade_in, torch.cat([hf, xh[..., HF:]], -1), xh)
    xh = torch.where(mix_h, xh * fi, xh)
    xh = torch.where(keep_h, xh, 0.0)
    out[..., :CFMAX] = xh
    if FW > CFMAX:
        bf = out[..., CFMAX:FW]
        out[..., CFMAX:FW] = torch.where(
            in_fade[..., CFMAX:] & fade_in,
            trunc16(bf * fade_gain[..., CFMAX:]), bf)
    return out


def unit_contrib(heads, bank, gains, lengths, unit_id, unit_cf_in,
                 unit_fade_in, tail_total, fi, fade_values,
                 fade_in_samples: int, remove_dc: bool):
    """heads, fi [B, U, CFMAX] f32; bank, gains, lengths, unit_id,
    unit_cf_in as unit_base takes them; unit_fade_in [B, U] bool;
    tail_total [B, U] i32 (unit_base's); fade_values [NFV] i32 (the
    batch's distinct max(min(fade_in_samples, n), 1), 0-padded: the
    plain version's table) -> contrib [B, U, max(UBUF, CFMAX)] f32."""
    if heads.device.type == "cpu":
        return unit_contrib_plain(heads, bank, gains, lengths, unit_id,
                                  unit_cf_in, unit_fade_in, tail_total, fi,
                                  fade_values, fade_in_samples, remove_dc)
    if heads.device.type != "cuda":
        raise ValueError(f"unit_contrib: unsupported device {heads.device}")
    dev = heads.device
    N, UBUF = bank.shape
    B, U, CFMAX = heads.shape
    check(heads, "heads", F32, (B, U, CFMAX), dev)
    check(bank, "bank", F32, (N, UBUF), dev)
    check(gains, "gains", F32, (N,), dev)
    check(lengths, "lengths", torch.int32, (N,), dev)
    check(unit_id, "unit_id", torch.int32, (B, U), dev)
    check(unit_cf_in, "unit_cf_in", torch.int32, (B, U), dev)
    check(unit_fade_in, "unit_fade_in", torch.bool, (B, U), dev)
    check(tail_total, "tail_total", torch.int32, (B, U), dev)
    check(fi, "fi", F32, (B, U, CFMAX), dev)
    contrib = torch.empty((B, U, max(UBUF, CFMAX)), dtype=F32, device=dev)
    launch("ctts_unit_contrib", dev, heads.data_ptr(), bank.data_ptr(),
           gains.data_ptr(), lengths.data_ptr(), unit_id.data_ptr(),
           unit_cf_in.data_ptr(), unit_fade_in.data_ptr(),
           tail_total.data_ptr(), fi.data_ptr(),
           sine_fade_table(dev).data_ptr(), contrib.data_ptr(), B * U, UBUF,
           CFMAX, fade_in_samples, int(remove_dc))
    contrib_kernel.launches += 1
    return contrib
