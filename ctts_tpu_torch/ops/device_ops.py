"""PyTorch versions of the DSP stages the speed-1.0 core calls.

Counterparts of ctts_tpu/ops/device_ops.py, batched over a leading row
dimension instead of vmapped. What the JAX package restates for the TPU
(shifted-select resamples, top_k / hierarchical flag extraction,
while-loops of window moves, grouped conv correlations) is ported as
the computation it performs: gathers, cumsum ranks and exact int64
sums give the same bits. Numerics follow the reference's int16 lattice
(ops/quant.py); every multiply and add is a separate f32 op.
"""

from __future__ import annotations

from typing import Optional

import torch

from ctts_tpu_torch.constants import SAMPLE_RATE
from ctts_tpu_torch.ops.exact import sqrt_rn
from ctts_tpu_torch.ops.luts import hann, sine_fade_gain
from ctts_tpu_torch.ops.quant import q16, trunc16, wrap16

F32 = torch.float32

PITCH_MIN_LAG = SAMPLE_RATE // 400   # 55
PITCH_MAX_LAG = SAMPLE_RATE // 80    # 275
PITCH_ANALYSIS = SAMPLE_RATE // 100  # 220
PITCH_SPAN = PITCH_MAX_LAG + PITCH_ANALYSIS  # 495

# Kept segments per region of the default silence table
# (ctts_tpu/ops/device_ops.py:416). A region with more is counted as an
# overflow; its row is run again at a table wide enough for it
# (plan_arrays.seg_width).
NBLK = 32


def estimate_pitch_batch(segs: torch.Tensor,
                         counts: torch.Tensor) -> torch.Tensor:
    """Batched estimate_pitch (ctts.c:1899-1943) over segs [n, 495] with
    per-row live counts [n]; ctts_tpu/ops/device_ops.py:137. The
    correlation sums come from the pitch kernel (exact integers rounded
    once); the normalization, lag mask, earliest argmax and 0.3 voiced
    threshold follow here."""
    from ctts_tpu_torch.ops.hopper.pitch import pitch_corr

    counts = counts.to(torch.int32)
    max_lag = torch.clamp(counts // 2, max=PITCH_MAX_LAG)
    analysis_len = torch.clamp(counts - max_lag, max=PITCH_ANALYSIS)
    corr_all, e2_all = pitch_corr(segs.contiguous(), analysis_len)

    i = torch.arange(PITCH_ANALYSIS, device=segs.device)
    live = i[None, :] < analysis_len[:, None]
    base = torch.where(live, segs[:, :PITCH_ANALYSIS], 0.0).to(torch.int64)
    e1 = (base * base).sum(1).to(F32)

    lags = torch.arange(PITCH_MIN_LAG, PITCH_MAX_LAG + 1, device=segs.device)
    corr = corr_all[:, PITCH_MIN_LAG:]
    e2 = e2_all[:, PITCH_MIN_LAG:]
    norm = sqrt_rn(e1[:, None] * e2)
    pos = norm > 0
    corr = torch.where(pos, corr / torch.where(pos, norm, 1.0), corr)
    corr = torch.where(lags[None, :] <= max_lag[:, None], corr,
                       float("-inf"))
    best = torch.argmax(corr, dim=1)          # first maximum, like jnp
    best_corr = corr.gather(1, best[:, None])[:, 0]
    best_lag = lags[best].to(F32)
    # A tensor numerator: `scalar / tensor` is reciprocal-then-multiply.
    pitch = torch.where(best_corr > 0.3,
                        torch.full_like(best_lag, SAMPLE_RATE) / best_lag,
                        0.0)
    usable = ((counts >= 200) & (analysis_len > 0)
              & (max_lag >= PITCH_MIN_LAG))
    return torch.where(usable, pitch, 0.0)


def pitch_shift_blend(head: torch.Tensor, shift_region: torch.Tensor,
                      factor: torch.Tensor) -> torch.Tensor:
    """apply_pitch_shift + ramp blend on unit heads (ctts.c:1946-1976,
    2006-2021); ctts_tpu/ops/device_ops.py:313. head [n, H], the first
    shift_region [n] samples live, factor [n]. The resample reads
    head[idx], head[idx+1] by gather (the JAX package's drift-shifted
    selects pick the same samples)."""
    n, H = head.shape
    i = torch.arange(H, device=head.device)
    sr = shift_region.to(torch.int32)[:, None]
    f = factor[:, None]
    do_shift = (f >= 0.9) & (f <= 1.1) & (sr >= 100)
    new_count = (sr.to(F32) / torch.where(do_shift, f, 1.0)).to(torch.int32)
    src_pos = i.to(F32)[None, :] * f
    idx = src_pos.to(torch.int32)
    frac = src_pos - idx.to(F32)
    # Lanes with idx outside the head are never selected below.
    hpad = torch.cat([head, torch.zeros(n, 1, dtype=F32,
                                        device=head.device)], dim=1)
    ia = torch.clamp(idx, 0, H).long()
    a = hpad.gather(1, ia)
    b = hpad.gather(1, torch.clamp(ia + 1, max=H))
    lerp = a * (1.0 - frac) + b * frac
    have2 = idx + 1 < sr
    have1 = (~have2) & (idx < sr)
    resampled = torch.where(have2, trunc16(lerp),
                            torch.where(have1, a, 0.0))
    copy_count = torch.minimum(new_count, sr)
    shifted = torch.where(i[None, :] < copy_count, resampled, 0.0)
    shifted = torch.where(do_shift, shifted, head)
    t = i.to(F32)[None, :] / torch.where(sr > 0, sr, 1).to(F32)
    blended = trunc16(shifted * (1.0 - t) + head * t)
    return torch.where(i[None, :] < sr, blended, head)


def _first_flagged(flags: torch.Tensor, W: int,
                   nblk: int = NBLK) -> torch.Tensor:
    """Indices of the first nblk True positions per row, ascending,
    padded with W (the JAX top_k / hierarchical extraction)."""
    n = flags.shape[0]
    rank = torch.cumsum(flags.to(torch.int32), dim=1)
    take = flags & (rank <= nblk)
    slot = torch.where(take, rank - 1, nblk).long()
    out = torch.full((n, nblk + 1), W, dtype=torch.int64,
                     device=flags.device)
    pos = torch.arange(W, device=flags.device).expand(n, W)
    out.scatter_(1, slot, pos)   # only the dummy column sees duplicates
    out[:, nblk] = W
    return out[:, :nblk]


def silence_segments(buf: torch.Tensor, length: torch.Tensor,
                     threshold: torch.Tensor, min_silence: int,
                     nblk: int = NBLK):
    """Kept-segment tables of remove_silence_regions (ctts.c:1634-1690);
    ctts_tpu/ops/device_ops.py:491. buf [n, W], length [n], threshold
    [n] f32. Returns (starts [n, nblk], seg_len [n, nblk], new_len [n],
    overflow [n]) as int64/bool; regions that are all zero or empty
    keep everything (starts = seg_len = 0, new_len = length). A region
    with more than nblk kept segments overflows: its last slot then
    runs to the region's end (the JAX package's catch-all), and its
    audio is not the reference's."""
    n, W = buf.shape
    dev = buf.device
    i = torch.arange(W, device=dev)
    length = length.long()
    live = i[None, :] < length[:, None]

    absv = torch.abs(buf)
    max_amp = torch.where(live, absv, 0.0).amax(dim=1)
    abs_threshold = torch.trunc(max_amp * threshold.to(F32))
    silent = (absv <= abs_threshold[:, None]) & live

    keep_n = max(min_silence // 4, 10)
    kn1 = keep_n + 1
    M = max(min_silence, 1)
    zeros = torch.zeros(n, 1, dtype=torch.int64, device=dev)
    cs = torch.cat([zeros, torch.cumsum(silent.long(), dim=1)], dim=1)
    # prefix_ok[i]: the keep_n+1 positions ending at i are all silent.
    cs_l = torch.cat([torch.zeros(n, kn1, dtype=torch.int64, device=dev),
                      cs], dim=1)[:, 1:W + 1]
    prefix_ok = (cs[:, 1:] - cs_l) == kn1
    # long_run[i]: a fully silent M-window starts in [i-M+1, i].
    cs_r = torch.cat([cs, cs[:, -1:].expand(n, M)], dim=1)
    w_all = (cs_r[:, M:M + W] - cs[:, :W]) == M
    cw = torch.cat([zeros, torch.cumsum(w_all.long(), dim=1)], dim=1)
    cw_l = torch.cat([torch.zeros(n, M, dtype=torch.int64, device=dev),
                      cw], dim=1)[:, 1:W + 1]
    long_run = (cw[:, 1:] - cw_l) > 0

    keep = torch.where(silent, ~(long_run & prefix_ok), live)
    prev_keep = torch.cat([torch.zeros(n, 1, dtype=torch.bool, device=dev),
                           keep[:, :-1]], dim=1)
    next_keep = torch.cat([keep[:, 1:],
                           torch.zeros(n, 1, dtype=torch.bool, device=dev)],
                          dim=1)
    seg_start_flag = keep & ~prev_keep
    seg_end_flag = keep & ~next_keep

    starts = _first_flagged(seg_start_flag, W, nblk)
    ends = _first_flagged(seg_end_flag, W, nblk)
    valid = starts < W
    seg_len = torch.where(valid, ends - starts + 1, 0)
    n_segs = seg_start_flag.sum(dim=1)
    overflow = n_segs > nblk
    last_len = torch.clamp(length - starts[:, nblk - 1], min=0)
    seg_len[:, nblk - 1] = torch.where(overflow & valid[:, nblk - 1],
                                       last_len, seg_len[:, nblk - 1])
    new_len = seg_len.sum(dim=1)

    unchanged = (max_amp == 0.0) | (length == 0)
    starts = torch.where(unchanged[:, None], 0, starts)
    seg_len = torch.where(unchanged[:, None], 0, seg_len)
    new_len = torch.where(unchanged, length, new_len)
    return starts, seg_len, new_len, overflow & ~unchanged


def move_segments(buf: torch.Tensor, starts: torch.Tensor, dst: torch.Tensor,
                  seg_len: torch.Tensor) -> torch.Tensor:
    """Move buf[starts[s]:+len] -> out[dst[s]:+len] per row, reading
    from the unmodified input (destinations do not overlap); positions
    outside moved segments keep their content. The plain version of the
    compact kernel; ctts_tpu/ops/device_ops.py:581. Its work is the
    moved samples and one gather, whatever the table's width."""
    n, W = buf.shape
    S = starts.shape[1]
    dev = buf.device
    starts, dst, seg_len = (x.long().reshape(-1) for x in (starts, dst,
                                                           seg_len))
    moved = torch.where((seg_len > 0) & (starts != dst), seg_len, 0)
    # One lane per moved sample: its segment, and its place in it.
    seg = torch.repeat_interleave(torch.arange(n * S, device=dev), moved)
    at = torch.arange(seg.shape[0], device=dev) - (
        torch.cumsum(moved, 0) - moved)[seg]
    # src[p] = the input position whose sample lands at p.
    src = torch.arange(W, device=dev).repeat(n, 1)
    src[seg // S, dst[seg] + at] = starts[seg] + at
    return buf.gather(1, src)


FR, HOP = 256, 128   # contour frame and hop (ctts.c:2206-2273)


def _frame_contribs(read, pos, count, active, f_start, f_end):
    """The Hann-windowed, resampled contour frames at positions pos [N]
    of segments with the given count, active flag and pitch factors
    [N]: (contrib, normc) [N, FR], zero for the frames that do not run.
    read(rel) gives the samples at segment positions rel and rel + 1."""
    hann256 = hann(FR, pos.device)
    denom = (count - FR).to(F32)
    inv_count = torch.where(denom != 0, 1.0 / denom, float("inf"))
    frame_ok = (pos + FR <= count) & active
    t = pos.to(F32) * inv_count
    smooth_t = t * t * (3.0 - 2.0 * t)
    pf = f_start + (f_end - f_start) * smooth_t

    i = torch.arange(FR, device=pos.device)
    src = i.to(F32)[None, :] * pf[:, None]                         # [N, FR]
    idx = src.to(torch.int32)
    frac = src - idx.to(F32)
    in_range = idx + 1 < FR
    rel = pos[:, None] + idx
    a, b = read(rel)
    a = torch.where(rel < count[:, None], a, 0.0)
    sample = torch.where(in_range, a * (1.0 - frac) + b * frac, a)
    contrib = torch.where(frame_ok[:, None], trunc16(sample * hann256), 0.0)
    normc = torch.where(frame_ok[:, None], hann256, 0.0)
    return contrib, normc


def _ola(x: torch.Tensor) -> torch.Tensor:
    """50%-overlap OLA of frames x [n, K, FR] at hop HOP: block m of 128
    gets frame m's first half plus frame m-1's second half (at most two
    adds, so order is moot) -> [n, (K+1)*HOP]."""
    n, K = x.shape[:2]
    acc = torch.zeros(n, K + 1, HOP, dtype=F32, device=x.device)
    acc[:, :K] = x[:, :, :HOP]
    acc[:, 1:] = acc[:, 1:] + x[:, :, HOP:]
    return acc.reshape(n, (K + 1) * HOP)


def _ola_values(contrib, normc):
    """(normalized values, good mask) of the OLA of frames [n, K, FR]."""
    acc = wrap16(_ola(contrib))
    norm = _ola(normc)
    good = norm > 0.01
    return q16(acc / torch.where(good, norm, 1.0)), good


def contour_segment(content: torch.Tensor, seg_off: torch.Tensor,
                    count: torch.Tensor, f_start: torch.Tensor,
                    f_end: torch.Tensor, max_frames: int) -> torch.Tensor:
    """apply_smooth_pitch_contour (ctts.c:2206-2273) on
    content[seg_off : seg_off+count) per row; ctts_tpu/ops/device_ops.py
    :630 (_contour0) and :732 (contour_segment). content [n, W]; the
    other arguments [n]. 256-sample frames at hop 128 are resampled by
    a pitch factor ramping f_start -> f_end, Hann-windowed, overlap-added
    and normalized; reads past the segment end are 0 (the oracle's
    handling of the reference's heap overread, ctts.c:2251)."""
    n, W = content.shape
    dev = content.device
    K = max_frames
    count = count.long()
    seg_off = seg_off.long()
    active = (count >= 100) & (torch.abs(f_start - f_end) >= 0.01)
    pos = (torch.arange(K, device=dev) * HOP).expand(n, K).reshape(-1)

    def rows(v):
        return v[:, None].expand(n, K).reshape(-1)

    ext = torch.cat([content, torch.zeros(n, K * HOP + 4 * HOP, dtype=F32,
                                          device=dev)], dim=1).reshape(-1)
    # Frames that do not run can index anywhere (pf is unbounded there);
    # their lanes are masked, so clamp their reads to their own row.
    base = torch.arange(n, device=dev) * (W + K * HOP + 4 * HOP)
    span = W + K * HOP + 4 * HOP - 2

    def read(rel):
        at = rows(base)[:, None] + torch.clamp(
            rows(seg_off)[:, None] + rel, 0, span)
        return ext[at], ext[at + 1]

    contrib, normc = _frame_contribs(read, pos, rows(count), rows(active),
                                     rows(f_start), rows(f_end))
    val, good = _ola_values(contrib.reshape(n, K, FR),
                            normc.reshape(n, K, FR))

    # Merge back at seg_off under (j < count) & active & good.
    j = torch.arange(W, device=dev)[None, :] - seg_off[:, None]
    jc = torch.clamp(j, 0, (K + 1) * HOP - 1)
    m = ((j >= 0) & (j < count[:, None]) & active[:, None]
         & good.gather(1, jc))
    return torch.where(m, val.gather(1, jc), content)


def zone_slots(smax: int, segments: int) -> int:
    """Frame slots of one sentence's contour workspace: a segment of
    count samples takes ceil(count / HOP) of them, and the counts of a
    sentence's segments sum to at most its length, SMAX."""
    return smax // HOP + segments + 4


def contour_zones(rows: torch.Tensor, margin: int, region: torch.Tensor,
                  seg_off: torch.Tensor, count: torch.Tensor,
                  f_start: torch.Tensor, f_end: torch.Tensor,
                  K: int) -> torch.Tensor:
    """contour_segment over S segments of each sentence at once, in
    place: rows [B, R, WREG] hold the region rows (content at `margin`);
    segment s of sentence b is content[seg_off : seg_off+count) of row
    region[b, s], with pitch factors f_start -> f_end (all [B, S]).

    What ctts_tpu/synth/device.py:1324-1565 computes, with every shape
    fixed by (B, S, K): each active segment's frames go to a zone of
    consecutive slots of the sentence's K-slot workspace (ceil(count /
    HOP) slots: they cover its count samples, and the frame of the last
    one never runs, since its pos + FR > count, so no OLA block mixes
    two zones), the frames are resampled and overlap-added
    there, and the values are written back under contour_segment's
    (j < count) & active & good mask. Every read of a frame that runs
    stays inside its segment, so segments of one row whose ranges do
    not overlap (the rise and the interrogative fall) read the content
    as it was and may run together. Needs, per sentence, the sum of the
    active segments' ceil(count / HOP) to be at most K (zone_slots)."""
    B, R, WREG = rows.shape
    S = region.shape[1]
    dev = rows.device
    flat = rows.view(-1)
    count = count.long()
    active = (count >= 100) & (torch.abs(f_start - f_end) >= 0.01)
    slots = torch.where(active, (count + HOP - 1) // HOP, 0)
    zend = torch.cumsum(slots, 1)
    zoff = zend - slots
    base = ((torch.arange(B, device=dev)[:, None] * R + region.long())
            * WREG + margin + seg_off.long())                     # [B, S]

    # The segment of each slot (of each OLA block: K + 1 of them); S
    # where the slot lies past the last zone.
    blk = torch.arange(K + 1, device=dev).expand(B, K + 1).contiguous()
    seg = torch.searchsorted(zend, blk, right=True)
    in_zone = seg < S
    segc = torch.clamp(seg, max=S - 1)

    def at_slot(v):
        return v.gather(1, segc)

    local = (blk - at_slot(zoff)) * HOP            # block's segment position
    cnt = torch.where(in_zone, at_slot(count), 0)
    act = in_zone & at_slot(active)
    top = flat.shape[0] - 2

    def slots_of(v):
        return v[:, :K].reshape(-1)

    fbase = slots_of(at_slot(base))

    def read(rel):
        at = torch.clamp(fbase[:, None] + rel, 0, top)
        return flat[at], flat[at + 1]

    contrib, normc = _frame_contribs(
        read, slots_of(local), slots_of(cnt), slots_of(act),
        slots_of(at_slot(f_start)), slots_of(at_slot(f_end)))
    val, good = _ola_values(contrib.reshape(B, K, FR),
                            normc.reshape(B, K, FR))

    # Write back every OLA position of a zone under the merge mask;
    # masked lanes write back the value already at a margin sample of
    # the sentence's first row, which no lane changes.
    jr = local[:, :, None] + torch.arange(HOP, device=dev)      # [B, K+1, HOP]
    m = ((jr < cnt[:, :, None]) & act[:, :, None]
         & good.reshape(B, K + 1, HOP))
    dummy = torch.arange(B, device=dev) * (R * WREG)
    tgt = torch.where(m, at_slot(base)[:, :, None] + jr,
                      dummy[:, None, None])
    keep = flat[dummy][:, None, None]
    flat.scatter_(0, tgt.reshape(-1),
                  torch.where(m, val.reshape(B, K + 1, HOP), keep).reshape(-1))
    return rows


def tail_fade_window(buf: torch.Tensor, end: torch.Tensor,
                     fade_len: torch.Tensor, W2: int,
                     before: Optional[torch.Tensor] = None) -> torch.Tensor:
    """apply_fade_out on buf[..end) with the lookup confined to the
    W2-wide window ending at `end` (ctts.c:3028-3039);
    ctts_tpu/ops/device_ops.py:756. buf [n, W], end and fade_len [n];
    buf is updated in place (a row with fade_len 0 keeps its values).
    With `before` [n], the samples that precede each row in its buffer,
    the fade is min(fade_len, before + end) long, as apply_fade_out
    makes it over the whole buffer, and its part inside the row is
    applied (W2 must cover min(fade_len, end))."""
    n, W = buf.shape
    i2 = torch.arange(W2, device=buf.device)
    end = end.long()
    if before is None:
        fade = torch.clamp(torch.minimum(fade_len.long(), end), max=W2)
    else:
        fade = torch.minimum(fade_len.long(), end + before.long())
    start = end - fade
    woff = torch.clamp(end - W2, min=0)
    ia = woff[:, None] + i2                                     # [n, W2]
    win = buf.gather(1, ia)
    rel = (ia - start[:, None]).to(F32)
    t = (fade.to(F32)[:, None] - rel) * (
        1.0 / torch.clamp(fade, min=1).to(F32))[:, None]
    faded = trunc16(win * sine_fade_gain(t))
    in_fade = ((ia >= start[:, None]) & (ia < end[:, None])
               & (fade[:, None] > 0))
    return buf.scatter_(1, ia, torch.where(in_fade, faded, win))
