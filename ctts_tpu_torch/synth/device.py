"""The synthesis core in PyTorch: plan arrays in, int16 audio out.

Counterpart of ctts_tpu/synth/device.py: `DeviceVoice` (:588) holds the
voice bank on the device, `SynthesisCore` runs build_core's pipeline
(:648-1652, the compose_refine=True branch, WSOLA for speed != 1.0) on
a batch of lowered plans, and `execute_plan_torch` (:1660) is the
single-sentence entry, a batch of one row through synth/compiled.py. The batch is an explicit leading dimension; the
JAX scans and while-loops are Python loops over batched tensors. The
Pallas kernels of the path are the Hopper kernels of ops/hopper (on a
CPU device their plain versions run).

The core is shape-static, as a traced JAX function is: `stage_inputs`
uploads a batch's host arrays first (one byte buffer, one copy), and
`SynthesisCore.forward` then runs three stages (a prologue, the refine
trip once per trip of the batch's refine depth, an epilogue), each a
sequence of ops whose shapes depend only on the bucket dims, the batch
size and the shared-table lengths, never on the values in the arrays,
and none reads back to the host. So synth/compiled.py can capture each
stage once per signature as a CUDA graph and replay it, the counterpart
of the JAX package's compiled programs.

Stage order (JAX line numbers): prepare_base and the set-up of
make_contrib_fn (761-886, one unit_base launch), with the DC/fade chain
of its contrib_fn (887-918, one unit_contrib launch) before each
compose; head pitch (1070-1084); the refine loop of
compose + boundary_heads (920-1030, 1212-1223); the final compose
(1223); in-region tail fades (1250-1268); silence tables (1276-1300);
compaction (1302-1320); contour, the interrogative fall and
region_post (1338-1595); assembly, q16 and the length mask (1599-1635);
WSOLA when the bucket stretches (1639-1646); int16 out (1650).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ctts_tpu_torch.db.reader import VoiceDatabase
from ctts_tpu_torch.ops import device_ops as dops
from ctts_tpu_torch.ops.exact import sqrt_rn
from ctts_tpu_torch.ops.hopper.assemble import assemble
from ctts_tpu_torch.ops.hopper.compact import compact
from ctts_tpu_torch.ops.hopper.contour import contour_zones
from ctts_tpu_torch.ops.hopper.region_post import region_post
from ctts_tpu_torch.ops.hopper.silence import silence_tables
from ctts_tpu_torch.ops.hopper.compose import compose
from ctts_tpu_torch.ops.hopper.units import unit_base, unit_contrib, widths
from ctts_tpu_torch.ops.luts import sine_fade_gain
from ctts_tpu_torch.ops.quant import q16, trunc16
from ctts_tpu_torch.ops.wsola import time_stretch
from ctts_tpu_torch.plan.compiler import SynthesisPlan
from ctts_tpu_torch.synth.plan_arrays import (
    PlanDims,
    bucket_dims,
    derive_dims,
    fill_device_plan,
    shared_plan_values,
    walk_plan,
)
from ctts_tpu_torch.utils import timing

F32 = torch.float32


def exact_gains(db: VoiceDatabase, target_rms: float) -> np.ndarray:
    """normalize_rms gains (ctts.c:1709-1727), exact on the host with
    f64 accumulation like the C's double (ctts_tpu/synth/device.py:599)."""
    n = db.unit_count
    gains = np.ones(n, np.float32)
    for i in range(n):
        s = db.unit_samples(i).astype(np.float64)
        if s.shape[0] == 0:
            continue
        rms = np.float32(np.sqrt(np.sum(s * s) / s.shape[0]))
        if rms < np.float32(1.0):
            continue
        g = np.float32(target_rms) / rms
        gains[i] = min(max(g, np.float32(0.1)), np.float32(3.0))
    return gains


class DeviceVoice:
    """Device-resident voice bank: padded units [N, UBUF] f32, lengths
    [N] i32 and exact RMS gains [N] f32 (ctts_tpu/synth/device.py:588).
    `lengths_np` keeps a host copy for the batch-global value tables."""

    def __init__(self, db: VoiceDatabase, target_rms: float = 3000.0,
                 device: Optional[torch.device] = None):
        units, lengths = db.to_device_arrays()
        self._set(units.astype(np.float32), lengths.astype(np.int32),
                  exact_gains(db, target_rms), device)

    @classmethod
    def from_numpy(cls, bank: np.ndarray, lengths: np.ndarray,
                   gains: np.ndarray,
                   device: Optional[torch.device] = None) -> "DeviceVoice":
        """From host arrays, e.g. a JAX DeviceVoice's np.asarray(...)."""
        voice = cls.__new__(cls)
        voice._set(np.asarray(bank, np.float32),
                   np.asarray(lengths, np.int32),
                   np.asarray(gains, np.float32), device)
        return voice

    def _set(self, bank, lengths, gains, device):
        if device is None:
            from ctts_tpu_torch.env import device as cuda_device

            device = cuda_device()
        self.bank = torch.tensor(bank, device=torch.device(device))
        # The bank's own device: "cuda" resolved to its index, so that
        # later calls do not follow whichever device is current then.
        self.device = self.bank.device
        self.lengths = torch.tensor(lengths, device=self.device)
        self.gains = torch.tensor(gains, device=self.device)
        self.lengths_np = lengths
        self.ubuf = bank.shape[1]

    def core(self) -> "SynthesisCore":
        """The voice's one SynthesisCore, made at first use and kept: the
        calls that share it share its compiled graphs' signatures."""
        core = getattr(self, "_core", None)
        if core is None:
            core = self._core = SynthesisCore(self)
        return core

    def replica(self, device: torch.device) -> "DeviceVoice":
        """This voice with its tensors copied to another device: the
        voice a mesh replicates on each of its devices
        (ctts_tpu/parallel/batch.py:254-258)."""
        voice = DeviceVoice.__new__(DeviceVoice)
        voice.bank = self.bank.to(device)
        voice.device = voice.bank.device
        voice.lengths = self.lengths.to(voice.device)
        voice.gains = self.gains.to(voice.device)
        voice.lengths_np = self.lengths_np
        voice.ubuf = self.ubuf
        return voice


class Staging:
    """Where each host array of a batch lies in one byte buffer: every
    array at an offset aligned to ALIGN bytes, in the order given. The
    layout (names, dtypes, shapes) is part of a compiled core's
    signature; `pack` fills a buffer, `views` reads typed tensors from
    a buffer of the same layout on any device."""

    ALIGN = 64

    def __init__(self, arrays: dict):
        fields, off = [], 0
        for name, v in arrays.items():
            a = np.asarray(v)
            fields.append((name, a.dtype, a.shape, off))
            off += -(-a.nbytes // self.ALIGN) * self.ALIGN
        self.fields = tuple(fields)
        self.nbytes = max(off, self.ALIGN)

    def key(self) -> tuple:
        return tuple((name, dt.str, shape)
                     for name, dt, shape, _ in self.fields)

    def pack(self, arrays: dict, out: np.ndarray) -> None:
        """Copy each array into out (uint8 [nbytes]) at its offset."""
        for name, dt, shape, off in self.fields:
            a = np.asarray(arrays[name])
            if a.dtype != dt or a.shape != shape:
                raise ValueError(f"staging {name}: {a.dtype} {a.shape}, "
                                 f"layout {dt} {shape}")
            out[off:off + a.nbytes] = np.ascontiguousarray(a).reshape(
                -1).view(np.uint8)

    def views(self, buf: torch.Tensor) -> dict:
        """Typed views of a staged byte buffer, one per array."""
        out = {}
        for name, dt, shape, off in self.fields:
            tdt = torch.from_numpy(np.empty(0, dt)).dtype
            n = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
            out[name] = buf[off:off + n].view(tdt).view(shape)
        return out

    def upload(self, arrays: dict, device: torch.device,
               out: Optional[torch.Tensor] = None) -> dict:
        """Pack `arrays` into one host byte buffer (pinned on a CUDA
        device, so the copy does not wait for the stream), copy it to
        `out` (a byte buffer of this layout on `device`) or to a new one,
        and return typed views of the device copy."""
        pinned = device.type == "cuda"
        host = torch.empty(self.nbytes, dtype=torch.uint8, pin_memory=pinned)
        self.pack(arrays, host.numpy())
        if out is None:
            out = host.to(device, non_blocking=pinned)
        else:
            out.copy_(host, non_blocking=pinned)
        return self.views(out)


def stage_inputs(arrays: dict, device: torch.device) -> dict:
    """Upload a batch's host arrays with one copy (Staging.upload)."""
    return Staging(arrays).upload(arrays, device)


def refine_depth(arrays: dict) -> int:
    """The batch's refine depth: the trips of its deepest row."""
    return int(np.max(arrays["refine_trips"], initial=0))


def check_zone_capacity(dims: PlanDims, arrays: dict) -> None:
    """The contour workspace holds a sentence's segments when its
    regions' lengths sum to at most SMAX (dops.zone_slots); the
    lowering guarantees it, and a batch that breaks it is refused."""
    total = np.asarray(arrays["region_len"]).reshape(
        np.shape(arrays["region_len"])[0], -1).astype(np.int64).sum(1)
    if total.size and int(total.max()) > dims.SMAX:
        raise ValueError(f"a row's regions hold {int(total.max())} samples, "
                         f"more than SMAX {dims.SMAX}")


def _excl_cumsum(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, dim=-1) - x


class SynthesisCore(nn.Module):
    """The synthesis core over a batch of lowered plans.

    forward(dims, ar, trips) takes the staged tensors of stage_inputs
    (the batch-stacked arrays of fill_device_plan / the native lowerer,
    [B, ...], and the batch-global value tables of shared_plan_values)
    and the batch's refine depth, and returns (out [B, OMAX] int16,
    out_len [B] i32, ovf [B] i32) on the voice's device (OMAX = SMAX
    unless the bucket stretches). It runs three stages: `prologue`,
    `refine_trip` `trips` times (the body of the vmapped while_loop,
    each row keeping its own trip count through a select), `epilogue`.
    What each stage launches depends only on the shapes of `ar` and on
    dims: every fade slot and every region run, and the rows that carry
    a contour or an energy ramp are masked or packed into zones on the
    device. Nothing reads back to the host."""

    def __init__(self, voice: DeviceVoice):
        super().__init__()
        self.register_buffer("bank", voice.bank)
        self.register_buffer("lengths", voice.lengths)
        self.register_buffer("gains", voice.gains)
        self.ubuf = voice.ubuf

    @torch.no_grad()
    def forward(self, dims: PlanDims, ar: dict, trips: int, fades: int = 0,
                nblk: int = dops.NBLK):
        st = self.prologue(dims, ar)
        for _ in range(trips):
            self.refine_trip(dims, st)
        return self.epilogue(dims, st, fades, nblk)

    @torch.no_grad()
    def prologue(self, dims: PlanDims, ar: dict) -> dict:
        """Bank pick, crossfade curves and head pitch: the state the
        refine trips update in place (its heads and trip counter). One
        unit_base (ops/hopper/units.py) makes the heads, the head
        columns hcols (the original heads and the pitch span), the int
        sum of each unit's body (tail_total) and the curves fo, fi; no
        [B, U, UBUF] base lives past it."""
        if not dims.compose_refine:
            raise NotImplementedError(
                "only the refine compose (compose_refine=True) is ported")
        ar = dict(ar)
        uid = ar["unit_id"].long()
        active = uid >= 0
        ar["_n"] = torch.where(active, self.lengths[torch.clamp(uid, min=0)],
                               0).long()
        _, HW = widths(self.ubuf, dims.CFMAX, dops.PITCH_SPAN)
        heads, hcols, tail_total, fo, fi = unit_base(
            self.bank, self.gains, self.lengths, ar["unit_id"],
            ar["unit_cf_in"], ar["cf_values"], dims.CFMAX, HW,
            dims.remove_dc)
        ar["_next_pitch"] = self._head_pitch(dims, ar, hcols)
        return {"ar": ar, "hcols": hcols, "fo": fo, "fi": fi,
                "tail_total": tail_total, "heads": heads,
                "it": torch.zeros((), dtype=torch.long, device=heads.device)}

    @torch.no_grad()
    def refine_trip(self, dims: PlanDims, st: dict) -> None:
        """One trip of the fixed-point compose: re-derive the unit heads
        from the exported analysis windows; a row whose own trip count
        is reached keeps its heads (the vmapped while_loop's select)."""
        ar, heads = st["ar"], st["heads"]
        _, seg, tail = self._compose(dims, ar, self._contrib(dims, st),
                                     st["fo"], True)
        new = self._boundary_heads(dims, ar, st["hcols"], seg, tail)
        live = st["it"] < ar["refine_trips"].long()
        heads.copy_(torch.where(live[:, None, None], new, heads))
        st["it"].add_(1)

    @torch.no_grad()
    def epilogue(self, dims: PlanDims, st: dict, fades: int = 0,
                 nblk: int = dops.NBLK):
        """The final compose and everything after it: (out, out_len,
        ovf). `fades` is plan_arrays.fade_passes of the batch: 0 fades
        each in-region window where it lies; n >= 1 runs the fades and
        the silence tables n times and applies the parts of the fades
        that reach back past their regions on the assembled sentence.
        `nblk` is the silence tables' width: ovf counts, per row, the
        regions with more kept segments than that (the row's audio is
        then not the reference's, and the caller runs it again at
        plan_arrays.seg_width)."""
        out, out_len, ovf = self.assembled(dims, st, fades, nblk)
        if dims.stretch:
            out, out_len = time_stretch(out, out_len, st["ar"]["speed"],
                                        dims.OMAX, dims.synth_hop)
        return out.to(torch.int16), out_len.to(torch.int32), ovf

    @torch.no_grad()
    def assembled(self, dims: PlanDims, st: dict, fades: int = 0,
                  nblk: int = dops.NBLK):
        """The epilogue up to WSOLA: the assembled sentences (out
        [B, SMAX] f32, out_len, ovf), which a stretching bucket's frame
        chain takes as its input."""
        ar = st["ar"]
        bufs, _, _ = self._compose(dims, ar, self._contrib(dims, st),
                                   st["fo"], False)
        if fades:
            tables = self._reaching_fades(dims, ar, bufs, fades, nblk)
        else:
            bufs = self._tail_fades(dims, ar, bufs)
            tables = self._seg_tables(dims, ar, bufs, nblk)
        starts, dst, seg_lens, comp_lens, ovf = tables
        bufs = compact(bufs, starts, dst, seg_lens, dims.WREG)
        bufs = bufs.reshape(-1, dims.R, dims.WREG)
        bufs = self._contour(dims, ar, bufs, comp_lens)
        new_lens, offsets, total_len = self._layout(ar, comp_lens)
        bufs = self._region_post(dims, ar, bufs, comp_lens, offsets)
        out, out_len = self._assemble(dims, ar, bufs, new_lens, offsets,
                                      total_len)
        if fades:
            out = self._fades_before_regions(dims, ar, out, comp_lens,
                                             offsets)
        return out, out_len, ovf

    # -- head pitch (device.py:1054-1084) ----------------------------------

    def _shift_rows(self, ar):
        """Candidate-slot picks of device.py:1054-1068: rows of a [B, U,
        ...] tensor at shift_slots, zeros for empty slots."""
        ss = ar["shift_slots"].long()
        live = ss >= 0
        si = torch.clamp(ss, min=0)
        bi = torch.arange(ss.shape[0], device=ss.device)[:, None]

        def pick(m):
            v = m[bi, si]
            mask = live.reshape(live.shape + (1,) * (v.dim() - 2))
            return torch.where(mask, v, torch.zeros((), dtype=v.dtype,
                                                    device=v.device))

        return ss, live, pick

    def _head_pitch(self, dims, ar, hcols):
        """Pitch of each candidate unit's head, scattered to [B, U]
        (non-candidates read 0; their smoothing gate is off)."""
        ss, live, pick = self._shift_rows(ar)
        B, NS = ss.shape
        cand = dops.estimate_pitch_batch(
            pick(hcols[:, :, :dops.PITCH_SPAN]).reshape(B * NS, -1),
            pick(ar["unit_analysis"]).reshape(-1)).reshape(B, NS)
        return self._scatter_slots(dims, ss, live, cand)

    @staticmethod
    def _scatter_slots(dims, ss, take, vals):
        """[B, NS, ...] candidate values back to [B, U, ...] at ss where
        `take`; zeros elsewhere."""
        B = ss.shape[0]
        tgt = torch.where(take, ss, dims.U)              # U: dummy slot
        out = torch.zeros((B, dims.U + 1) + vals.shape[2:], dtype=vals.dtype,
                          device=vals.device)
        idx = tgt.reshape(tgt.shape + (1,) * (vals.dim() - 2)).expand(
            vals.shape)
        out.scatter_(1, idx, vals)
        return out[:, :dims.U]

    # -- contributions (contrib_fn, device.py:887-918) ---------------------

    def _contrib(self, dims, st):
        """Per-unit contributions [B, U, W] from the current heads: one
        unit_contrib (ops/hopper/units.py) over the state that
        unit_base made."""
        ar = st["ar"]
        return unit_contrib(st["heads"], self.bank, self.gains, self.lengths,
                            ar["unit_id"], ar["unit_cf_in"],
                            ar["unit_fade_in"], st["tail_total"], st["fi"],
                            ar["fade_values"], dims.fade_in_samples,
                            dims.remove_dc)

    # -- placement (compose kernel, device.py:1086-1113) -------------------

    def _compose(self, dims, ar, contrib, fo, export):
        base_off = (ar["unit_region"] * dims.WREG + ar["unit_off"]).to(
            torch.int32)
        n_eff = ar["_n"].to(torch.int32)
        return compose(contrib.contiguous(), fo.contiguous(),
                       base_off.contiguous(),
                       ar["unit_cf_in"].to(torch.int32).contiguous(),
                       n_eff.contiguous(),
                       ar["unit_analysis"].to(torch.int32).contiguous(),
                       dims.R * dims.WREG, export)

    # -- boundary DSP (boundary_heads, device.py:920-1030) -----------------

    def _boundary_heads(self, dims, ar, hcols, seg, tail):
        """smooth_pitch_boundary + match_boundary_energy on the unit
        heads, from the exported pre-merge windows."""
        CFMAX = dims.CFMAX
        ss, live, pick = self._shift_rows(ar)
        B, NS = ss.shape
        prev_p = dops.estimate_pitch_batch(
            pick(seg[:, :, :dops.PITCH_SPAN]).reshape(B * NS, -1),
            pick(ar["unit_analysis"]).reshape(-1)).reshape(B, NS)
        next_p = pick(ar["_next_pitch"])
        sr_c = pick(ar["unit_shift_region"])
        voiced = (prev_p > 0) & (next_p > 0)
        ratio = next_p / torch.where(prev_p > 0, prev_p, 1.0)
        jump = (ratio > 1.15) | (ratio < 0.85)
        target = torch.where(ratio > 1.0, 1.0 + (ratio - 1.0) * 0.5,
                             1.0 - (1.0 - ratio) * 0.5)
        factor = target / torch.where(ratio != 0, ratio, 1.0)
        shifted = dops.pitch_shift_blend(
            pick(hcols[:, :, :CFMAX]).reshape(B * NS, CFMAX),
            sr_c.reshape(-1), factor.reshape(-1)).reshape(B, NS, CFMAX)
        use = live & voiced & jump & (sr_c > 0)
        shifted_u = self._scatter_slots(dims, ss, use, shifted)
        use_u = self._scatter_slots(dims, ss, use, use)

        it = torch.arange(CFMAX, device=hcols.device)
        head = hcols[:, :, :CFMAX]
        sr = ar["unit_shift_region"].long()[..., None]
        head = torch.where((it < sr) & use_u[..., None], shifted_u, head)

        blen = ar["unit_boundary_len"].long()
        blen_f = torch.clamp(blen, min=1).to(F32)
        tail_live = it >= (CFMAX - blen[..., None])
        prev_rms = sqrt_rn(
            torch.where(tail_live, tail * tail, 0.0).sum(-1) / blen_f)
        next_rms = sqrt_rn(
            torch.where(it < blen[..., None], head * head, 0.0).sum(-1)
            / blen_f)
        eratio = torch.clamp(
            prev_rms / torch.where(next_rms > 0, next_rms, 1.0), 0.5, 2.0)
        tgain = it.to(F32) / blen_f[..., None]
        egain = eratio[..., None] * (1.0 - tgain) + tgain
        do_boundary = ar["unit_smooth"] & (ar["unit_boundary"] > 0)
        do_energy = (do_boundary & (blen > 0) & (prev_rms >= 1.0)
                     & (next_rms >= 1.0))
        return torch.where((it < blen[..., None]) & do_energy[..., None],
                           q16(head * egain), head)

    # -- in-region tail fades (device.py:1238-1268) -------------------------

    def _tail_fades(self, dims, ar, bufs):
        """Punctuation fades as FADEW-wide window patches, in slot order,
        in place, where plan_arrays.fade_passes proved each stays in its
        window (fades = 0). An unused slot (fade_pos < 0, fade_len 0)
        writes its window back unchanged."""
        jf = torch.arange(dims.FADEW, device=bufs.device)
        for k in range(dims.FD):
            fpos = ar["fade_pos"][:, k].long()
            pos = dims.MARGIN + torch.clamp(fpos, min=0)
            flen = torch.minimum(ar["fade_len"][:, k].long(), pos)
            foff = ar["fade_region"][:, k].long() * dims.WREG + pos - dims.FADEW
            idx = foff[:, None] + jf
            win = bufs.gather(1, idx)
            rel = (jf[None, :] - (dims.FADEW - flen[:, None])).to(F32)
            t = (flen.to(F32)[:, None] - rel) * (
                1.0 / torch.clamp(flen, min=1).to(F32))[:, None]
            live = (fpos >= 0) & (flen > 0)
            in_fade = (jf[None, :] >= dims.FADEW - flen[:, None]) & live[:, None]
            bufs.scatter_(1, idx, torch.where(
                in_fade, trunc16(win * sine_fade_gain(t)), win))
        return bufs

    # -- fades that reach back past their regions (reference/ctts.c:
    #    3028-3039 on the whole buffer) --------------------------------------

    def _reaching_fades(self, dims, ar, bufs, passes, nblk):
        """The in-region fades and the silence tables when a fade may
        reach back past its region (plan_arrays.fade_passes >= 1). A fade
        at cursor c of region r is min(F, P) long, P = B_r + c the buffer
        it ends, B_r the audio before region r after its silence removal.
        Its part inside the region is applied here, before the region's
        silence removal as in the C; the part before the region is
        applied on the assembled sentence (_fades_before_regions). B_r is
        taken first from the lengths before silence removal, then from the
        silence tables of the pass before: pass k gets the k-th region
        whose fade depends on it right, and the last pass's tables are
        returned, with the most overflowing regions of any pass (a pass
        that overflows gives the next wrong lengths). Each pass but the
        last writes its windows back."""
        active = ar["region_active"]
        pause = torch.where(active, ar["region_pause"].long(), 0)
        lens = torch.where(active, ar["region_len"].long(), 0)
        base = _excl_cumsum(lens + pause)
        ovf = None
        for p in range(passes):
            saved = self._in_region_fades(dims, ar, bufs, base)
            tables = self._seg_tables(dims, ar, bufs, nblk)
            ovf = tables[4] if ovf is None else torch.maximum(ovf, tables[4])
            if p + 1 < passes:
                for idx, win in reversed(saved):
                    bufs.scatter_(1, idx, win)
                base = _excl_cumsum(
                    torch.where(active, tables[3].long(), 0) + pause)
        return tables[:4] + (ovf,)

    def _in_region_fades(self, dims, ar, bufs, base):
        """Each in-region fade's part inside its region, in slot order, in
        place, from B_r = base [B, R]; returns each slot's window index and
        its values before the fade."""
        M, FW = dims.MARGIN, min(dims.FADEW, dims.CONTW)
        jf = torch.arange(FW, device=bufs.device)
        saved = []
        for k in range(dims.FD):
            fpos = ar["fade_pos"][:, k].long()
            c = torch.clamp(fpos, min=0)
            r = ar["fade_region"][:, k].long()
            fade = torch.minimum(ar["fade_len"][:, k].long(),
                                 base.gather(1, r[:, None])[:, 0] + c)
            inside = torch.minimum(fade, c)
            j = torch.clamp(c - FW, min=0)[:, None] + jf          # in-region
            idx = (r * dims.WREG + M)[:, None] + j
            win = bufs.gather(1, idx)
            t = (c[:, None] - j).to(F32) * (
                1.0 / torch.clamp(fade, min=1).to(F32))[:, None]
            in_fade = ((j >= (c - inside)[:, None]) & (j < c[:, None])
                       & ((fpos >= 0) & (fade > 0))[:, None])
            bufs.scatter_(1, idx, torch.where(
                in_fade, trunc16(win * sine_fade_gain(t)), win))
            saved.append((idx, win))
        return saved

    def _fades_before_regions(self, dims, ar, sent, comp_lens, offsets):
        """The part of every fade that lies before its region's start, on
        the assembled sentence [B, SMAX], in op order: a region's
        in-region fades in slot order, then its tail fade, region by
        region. A fade ending at P = B_r + c (c its cursor, or the
        region's length after silence removal for the tail fade) covers
        [P - min(F, P), P); here [P - min(F, P), B_r)."""
        B, FD, R = sent.shape[0], dims.FD, dims.R
        dev = sent.device
        active = ar["region_active"]
        fpos = ar["fade_pos"].long()
        region = torch.cat([ar["fade_region"].long(),
                            torch.arange(R, device=dev).expand(B, R)], 1)
        end = torch.cat([torch.clamp(fpos, min=0), comp_lens.long()], 1)
        flen = torch.cat([
            torch.where(fpos >= 0, ar["fade_len"].long(), 0),
            torch.where(active, ar["region_fade_after"].long(), 0)], 1)
        rank = torch.cat([torch.arange(FD, device=dev).expand(B, FD),
                          torch.full((B, R), FD, device=dev)], 1)
        order = torch.argsort(region * (FD + 1) + rank, dim=1, stable=True)
        region, end, flen = (x.gather(1, order) for x in (region, end, flen))
        start = offsets.long().gather(1, region)                  # B_r
        P = start + end
        fade = torch.minimum(flen, P)
        W = min(dims.FADEW, dims.SMAX)
        jw = torch.arange(W, device=dev)
        for e in range(FD + R):
            ia = torch.clamp(start[:, e] - W, min=0)[:, None] + jw
            win = sent.gather(1, ia)
            t = (P[:, e, None] - ia).to(F32) * (
                1.0 / torch.clamp(fade[:, e], min=1).to(F32))[:, None]
            in_fade = ((ia >= (P - fade)[:, e, None])
                       & (ia < start[:, e, None]) & (fade[:, e, None] > 0))
            sent.scatter_(1, ia, torch.where(
                in_fade, trunc16(win * sine_fade_gain(t)), win))
        return sent

    # -- silence tables (device.py:1272-1300) -------------------------------

    def _seg_tables(self, dims, ar, bufs, nblk):
        """Kept-segment tables per region, nblk slots wide; returns
        (starts, dst, seg_len [B, R, nblk] i32 with MARGIN included,
        compacted lengths [B, R], overflow count [B])."""
        return silence_tables(bufs, ar["region_len"], ar["region_remove"],
                              ar["threshold"], dims.min_silence_samples,
                              nblk, dims.MARGIN, dims.CONTW)

    # -- contour + interrogative fall (device.py:1324-1565) -----------------

    def _contour(self, dims, ar, bufs, comp_lens):
        """Phrase-intonation pitch contour on each DSP region's content
        (the rise segment of a split question), and the interrogative
        fall on the question-final regions: one ctts_contour_zones
        launch (ops/hopper/contour.py; on the CPU its plain version, the
        zones of dops.contour_zones)."""
        return contour_zones(bufs, comp_lens,
                             ar["region_contour"].contiguous(),
                             ar["region_qfinal"].contiguous(),
                             ar["region_do_dsp"].contiguous(),
                             ar["region_active"].contiguous(),
                             dims.MARGIN, dims.SMAX)

    # -- region_post (device.py:1567-1593) ----------------------------------

    def _region_post(self, dims, ar, bufs, comp_lens, offsets):
        """Energy ramp (ctts.c:2841-2865) and the region tail fade on
        the rows that carry them: one ctts_region_post launch
        (ops/hopper/region_post.py; on the CPU its plain version, masked
        over every region row as the JAX package's vmapped region_post).
        The tail fade is min(F, B_r + length) long, B_r = offsets, as
        apply_fade_out makes it over the whole buffer; its part before
        the region is _fades_before_regions'."""
        return region_post(bufs, comp_lens, offsets,
                           ar["region_contour"].contiguous(),
                           ar["region_do_dsp"].contiguous(),
                           ar["region_energy"].contiguous(),
                           ar["region_fade_after"].contiguous(),
                           dims.MARGIN, dims.CONTW, dims.FADE2W)

    # -- assembly (device.py:1596-1635) -------------------------------------

    @staticmethod
    def _layout(ar, comp_lens):
        """(region lengths, region offsets in the sentence, sentence
        length) after silence removal."""
        active = ar["region_active"]
        new_lens = torch.where(active, comp_lens, 0)
        pauses = torch.where(active, ar["region_pause"].long(), 0)
        seg_lens = new_lens + pauses
        return new_lens, _excl_cumsum(seg_lens), seg_lens.sum(1)

    def _assemble(self, dims, ar, bufs, new_lens, offsets, total_len):
        active = ar["region_active"]
        live_len = torch.where(active, dims.MARGIN + new_lens, 0)
        B = bufs.shape[0]
        sent = assemble(bufs.reshape(B, dims.R * dims.WREG),
                        offsets.to(torch.int32).contiguous(),
                        live_len.to(torch.int32).contiguous(),
                        dims.WREG, dims.MARGIN + dims.SMAX)[:, dims.MARGIN:]
        ii = torch.arange(dims.SMAX, device=bufs.device)
        sent = q16(torch.where(ii[None, :] < total_len[:, None], sent, 0.0))
        return sent, total_len


def lower_sentence(plan: SynthesisPlan, db: VoiceDatabase,
                   voice: DeviceVoice) -> tuple:
    """(dims, arrays, shared tables) of one sentence as a batch of one
    row in its own bucket: the host half of execute_plan_torch."""
    w = walk_plan(plan, db)
    dplan = fill_device_plan(w, db, bucket_dims(derive_dims(w, db)))
    arrays = {k: np.asarray(v)[None] for k, v in dplan.arrays.items()}
    return dplan.dims, arrays, shared_plan_values(
        dplan.arrays, voice.lengths_np, dplan.dims)


def execute_plan_torch(plan: SynthesisPlan, db: VoiceDatabase,
                       voice: Optional[DeviceVoice] = None) -> np.ndarray:
    """Single-sentence entry: lower into a bucket, run, trim, int16
    (ctts_tpu/synth/device.py:1660 execute_plan_jax). The sentence runs
    through the compiled core (synth/compiled.py run_batch) as a batch
    of one row, on the voice's one core and without the wire codec, the
    counterpart of `_compiled_core` (ctts_tpu/synth/device.py:1654),
    JAX's lru_cache of one program per bucket: on a CUDA device a
    signature's first sentence runs eagerly, its second is captured as
    CUDA graphs and later ones replay them, so a process that speaks
    sentence after sentence replays one set of graphs per signature; a
    signature that never comes back (the CLI's one `synth` in a fresh
    process) pays no capture. On the CPU it runs eagerly. A sentence
    with a region of more kept segments than the silence table's 32
    runs again at a table wide enough for it (compiled.run_wide)."""
    from ctts_tpu_torch.synth import compiled

    if voice is None:
        voice = DeviceVoice(db, plan.target_rms)
    with timing.span("sentence.lower"):
        lowered = lower_sentence(plan, db, voice)
    packed, _, out_lens, ovf = compiled.run_batch(voice.core(), *lowered,
                                                  False)
    # The packed buffer holds the row's valid prefix: its length and the
    # overflow count come to the host in one copy.
    with timing.span("sentence.sync"):
        n, n_ovf = torch.cat([out_lens, ovf]).cpu().tolist()
    if n_ovf:
        return compiled.run_wide(compiled.run_batch, voice.core(), *lowered,
                                 1)[0]
    with timing.span("sentence.sync"):
        return packed[:n].cpu().numpy()
