"""Host half of the device executor: plans lowered to dense arrays.

A jax-free copy of ctts_tpu/synth/device.py:59-645 (PlanDims,
bucket_dims, walk_plan, derive_dims, fill_device_plan,
build_device_plan, shared_plan_values) so the PyTorch port imports on a
host without JAX or ctts_tpu. Under the default configuration every
array and dimension it produces is equal to the JAX package's
(tests/test_torch_plan_arrays.py). Where the JAX package departs from
the C reference on a configuration key, the port follows the C
(tests/test_torch_config.py): the fade widths come from fade_out_ms,
not capped at the region margin; `fade_passes` tells the core when a
fade reaches back past its region; `split_keeps_fades` keeps a sentence
split from cutting through a fade; and `check_config` refuses the
min_silence_ms values where the C's silence removal is not defined.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ctts_tpu_torch.config import CTTSConfig
from ctts_tpu_torch.db.reader import VoiceDatabase
from ctts_tpu_torch.ops.device_ops import NBLK
from ctts_tpu_torch.ops.wsola import synthesis_hop_for_speed
from ctts_tpu_torch.plan.compiler import OpKind, SynthesisPlan, ms_to_samples
from ctts_tpu_torch.text.prosody import PhraseType, get_punctuation_pause_ms


@dataclasses.dataclass(frozen=True)
class PlanDims:
    """Static bucket dimensions; one core shape per value."""

    U: int        # unit slots
    R: int        # region slots
    FD: int       # in-region fade slots
    WREG: int     # region buffer width (margin + content + right pad)
    MARGIN: int   # left margin (= WIN + CFMAX)
    UBUF: int     # unit bank width
    WIN: int      # pitch-analysis window width
    CFMAX: int    # max crossfade samples
    SMAX: int     # sentence buffer width
    OMAX: int     # WSOLA output width
    CONTW: int    # region-content DSP width (contour/energy/tail work)
    FADEW: int    # in-region fade patch width (≥ max fade_out length)
    fade_in_samples: int
    min_silence_samples: int
    remove_dc: bool
    stretch: bool    # speed != 1.0: compile the WSOLA branch, OMAX > SMAX
    synth_hop: int   # static WSOLA synthesis hop (0 when not stretching)
    contour_drift: int  # ceil(256 * max_pitch_change) + 2 (resample bound)
    FADE2W: int = 128  # region tail-fade window width (≥ max fade_after)
    # Boundary-shift candidate slots: units whose host-known gates
    # (smooth & boundary>0 & prev_ok & n≥200 & shift_region>0) allow a
    # pitch shift. The tail-pitch search and shift/blend resample run on
    # these rows only (~16% of slots at the bench corpus) instead of all
    # U — the device-side gates (voiced & jump) are a subset.
    NSHIFT: int = 16
    # Compose variants of the JAX core (ctts_tpu/synth/device.py:88-101).
    # The torch core runs the fixed-point refine compose only and raises
    # on compose_refine=False; both fields stay so dims compare equal to
    # the JAX package's.
    compose_refine: bool = True
    exact_compose: bool = True


def _roundup(x: int, m: int = 128) -> int:
    return -(-x // m) * m


def _next_pow2(x: int, lo: int) -> int:
    n = lo
    while n < x:
        n *= 2
    return n


def _omax_for(smax: int, stretch: bool, synth_hop: int) -> int:
    """WSOLA output-buffer width for a bucket. Hop-aware: the output can
    hold at most num_frames·synth_hop + FRAME samples where num_frames ≤
    smax/128, so speed>1 buckets (hop<128) get buffers *smaller* than
    SMAX instead of the old worst-case 2·SMAX — shrinking the OLA scan
    carries and the device→host transfer ~3× at speed 1.5."""
    if not stretch:
        return smax
    omax = _roundup((smax // 128 + 2) * max(synth_hop, 1) + 512 + 2048)
    # Speeds in (0.99, 1.01) (hop 126-129) pass the input through
    # unstretched (ctts.c:3497-3503) — the buffer must hold SMAX.
    if synth_hop >= 126:
        omax = max(omax, _roundup(smax + 2048))
    return omax


def bucket_dims(d: PlanDims, floor: Optional[dict] = None) -> PlanDims:
    """Round dimensions up to coarse buckets so XLA specializations are
    shared across sentences (compile once per bucket, not per sentence).
    `floor` raises minimums (e.g. {"U": 32, "SMAX": 131072}) so a whole
    corpus lands in one bucket."""
    floor = floor or {}
    if "SMAX" in floor:
        # An explicit floor means the serving operator already chose
        # the bucket coarseness; honor it at 16384 granularity instead
        # of pow2-doubling past it (a 109k-sample corpus under a 131072
        # pow2 bucket paid ~12% dead padding in every SMAX-proportional
        # stage: pack, contour workspace, assembly, OMAX).
        smax = _roundup(max(d.SMAX, floor["SMAX"]), 16384)
    else:
        smax = _next_pow2(d.SMAX, 16384)
    # WIN/CFMAX derive from the plan's max crossfade, so short sentences
    # would otherwise land in their own buckets (MARGIN differs) and
    # fragment a batch into serial dispatches. Widening them is safe:
    # every analysis window / crossfade op masks by the actual lengths.
    win_b = _next_pow2(max(d.WIN, floor.get("WIN", 1024)), 1024)
    cfmax_b = _next_pow2(max(d.CFMAX, floor.get("CFMAX", 1024)), 1024)
    margin_b = win_b + cfmax_b
    # The row must still hold the (possibly larger) margin + content.
    wreg = _next_pow2(
        max(d.WREG, floor.get("WREG", 0), margin_b + d.CONTW), 16384
    )
    return dataclasses.replace(
        d,
        U=_next_pow2(max(d.U, floor.get("U", 0)), 8),
        R=_next_pow2(max(d.R, floor.get("R", 0)), 4),
        WIN=win_b,
        CFMAX=cfmax_b,
        MARGIN=margin_b,
        FD=_next_pow2(max(d.FD, floor.get("FD", 0)), 4),
        WREG=wreg,
        CONTW=min((_roundup(max(d.CONTW, floor["CONTW"]), 4096)
                   if "CONTW" in floor else
                   _next_pow2(max(d.CONTW, 0), 4096)),
                  wreg - margin_b),
        SMAX=smax,
        OMAX=_omax_for(smax, d.stretch, d.synth_hop),
        FADE2W=_next_pow2(max(d.FADE2W, floor.get("FADE2W", 0)), 128),
        # Floored at 16 so typical sentences (bench max: 11 candidates)
        # share one bucket; capped at the (bucketed) unit-slot count.
        NSHIFT=min(_next_pow2(max(d.NSHIFT, floor.get("NSHIFT", 16)), 8),
                   _next_pow2(max(d.U, floor.get("U", 0)), 8)),
    )


@dataclasses.dataclass
class DevicePlan:
    dims: PlanDims
    arrays: dict
    speed: float


def intonation_scalars(inton, word_index: int, total_words: int,
                       max_pitch_change: float):
    """Host scalar half of apply_phrase_intonation (ctts.c:2736-2840):
    returns (ws, we, peak, es, ee, qfinal, energy_active)."""
    f = np.float32

    def clamp(p):
        lo, hi = f(1.0) - f(max_pitch_change), f(1.0) + f(max_pitch_change)
        return f(min(max(f(p), lo), hi))

    denom = total_words - 1 if total_words > 1 else 1
    phrase_pos = f(word_index) / f(denom)
    is_final = word_index == total_words - 1
    is_penult = (word_index == total_words - 2) and total_words > 1

    peak_pos = f(inton.peak_position)
    p_start = f(inton.pitch_start)
    p_end = f(inton.pitch_end)
    p_peak = f(inton.pitch_peak)

    if phrase_pos <= peak_pos:
        t = phrase_pos / peak_pos
        t = t * t * (f(3.0) - f(2.0) * t)
        pf = p_start + (p_peak - p_start) * t
    else:
        t = (phrase_pos - peak_pos) / (f(1.0) - peak_pos)
        t = t * t * (f(3.0) - f(2.0) * t)
        pf = p_peak + (p_end - p_peak) * t
    pf = clamp(pf)

    ws = clamp(pf * f(0.98))
    we = clamp(pf * f(1.02))
    qfinal = False

    if inton.type == PhraseType.INTERROGATIVE and (is_final or is_penult):
        if is_final:
            ws = clamp(pf * f(0.95))
            we = clamp(p_end)
            qfinal = True
        else:
            ws = clamp(pf * f(0.98))
            we = clamp(pf * f(1.05))
    elif inton.type == PhraseType.EXCLAMATORY:
        if word_index == 0:
            ws = clamp(p_peak)
            we = clamp(pf)
        elif is_final:
            ws = clamp(pf)
            we = clamp(p_end)
        else:
            ws = clamp(pf * f(1.02))
            we = clamp(pf * f(0.98))
    elif inton.type == PhraseType.CONTINUATION and is_final:
        ws = clamp(pf * f(0.96))
        we = clamp(p_end)
    else:
        ws = clamp(pf * f(0.98))
        we = clamp(pf * f(1.02))
        if is_final:
            we = clamp(p_end)

    peak = clamp(p_peak)

    ef = f(inton.energy_factor)
    energy_active = abs(ef - f(1.0)) > f(0.01)
    es, ee = ef, ef
    if inton.type == PhraseType.EXCLAMATORY and word_index == 0:
        es, ee = ef * f(1.1), ef * f(0.95)

    return (float(ws), float(we), float(peak), float(es), float(ee),
            qfinal, bool(energy_active))



# silence removal keeps max(min_silence / 4, 10) samples of a run.
MIN_KEPT_SILENCE = 10
# The keys the plan compiler turns into sample counts (ms_to_samples).
DURATION_KEYS = ("crossfade_ms", "crossfade_vowel_ms",
                 "crossfade_s_ending_ms", "crossfade_r_ending_ms",
                 "word_pause_ms", "unknown_silence_ms", "fade_in_ms",
                 "fade_out_ms")


def check_config(config: CTTSConfig) -> None:
    """Refuse the configuration values the port cannot hold to the C.

    A duration of fewer than 0 samples: the C converts it to size_t
    (`(size_t)(ms * CTTS_SAMPLE_RATE / 1000.0f)`), which is undefined
    for a negative value, and the NumPy oracle then removes samples or
    fails; no output is the reference's. vowel_to_consonant_factor
    scales crossfade_ms, so a negative product is refused the same way.

    remove_silence_regions (reference/ctts.c:1634-1690) keeps
    max(min_silence / 4, 10) samples of every silent run of at least
    min_silence samples, moving them in place. With min_silence under 10
    samples a shorter run is "kept" at 10 samples: the C copies samples
    it has not read yet over ones it still has to, and writes past the
    end of the word, while the NumPy oracle lengthens the run from the
    input. The two disagree, so no output is the reference's; the port
    refuses those values where silence removal reads them."""
    for key in DURATION_KEYS:
        n = ms_to_samples(getattr(config, key))
        if n < 0:
            raise ValueError(
                f"{key}: {getattr(config, key)} is {n} samples; the port "
                f"supports {key} >= 0")
    v2c = float(np.float32(config.crossfade_ms)
                * np.float32(config.vowel_to_consonant_factor))
    if ms_to_samples(v2c) < 0:
        raise ValueError(
            f"vowel_to_consonant_factor: {config.vowel_to_consonant_factor}"
            f" makes a crossfade of {ms_to_samples(v2c)} samples; the port "
            "supports vowel_to_consonant_factor >= 0")
    if config.remove_word_silence and (
            ms_to_samples(config.min_silence_ms) < MIN_KEPT_SILENCE):
        raise ValueError(
            f"min_silence_ms: {config.min_silence_ms} is "
            f"{ms_to_samples(config.min_silence_ms)} samples; the port "
            f"supports min_silence_ms >= 0.4536 ({MIN_KEPT_SILENCE} "
            "samples at 22050 Hz, the run silence removal keeps), or "
            "remove_word_silence: 0")


def fade_widths(fade_out_samples: int) -> dict:
    """FADEW and FADE2W, the widths of the in-region and the region tail
    fade windows, from the configuration's fade_out length (every
    FADE_TAIL has that length). Under the default configuration they
    equal the JAX package's per-row widths; they are not capped at the
    region margin: the core clamps its windows to the rows."""
    return {"FADEW": _roundup(max(fade_out_samples, 1), 128),
            "FADE2W": _next_pow2(max(fade_out_samples, 1), 128)}


def split_keeps_fades(config: CTTSConfig) -> bool:
    """Whether a sentence split (plan/split.py) keeps every fade inside
    its row. The split cuts before a sentence-end pause, which then
    leads the next row; apply_fade_out fades the buffer's last
    fade_out_ms, so a fade of the next row stays inside it when that
    pause is at least as long as the fade (not so with word_pause_ms 0,
    or a fade longer than the pause)."""
    pause = min(ms_to_samples(get_punctuation_pause_ms(c, config.word_pause_ms))
                for c in b".!?")
    return ms_to_samples(config.fade_out_ms) <= pause


def fade_passes(dims: PlanDims, arrays: dict) -> int:
    """How the core applies a batch's fades (arrays stacked [B, ...]).

    apply_fade_out fades the last min(F, P) samples of the whole buffer,
    P samples long at that point (reference/ctts.c:3028-3039), and so
    reaches back past the start of the fade's region when F is longer
    than what the region holds before it. Returns 0 when the lowering
    proves every fade of the batch stays inside its region's window or
    reaches back only over the zeros of the pause before it (the case of
    the default configuration): the core then fades each window where
    it lies. Otherwise 1 + D: the core also applies the part of every
    fade that lies before its region, on the assembled sentence, in op
    order; and D is the most regions of a row whose in-region fade may
    be cut to the P before it, with P not known until the silence
    removal of earlier regions has run: the core runs the fades and the
    silence tables D + 1 times, each pass taking P from the one
    before."""
    active = np.asarray(arrays["region_active"]).astype(bool)
    pause = np.where(active, arrays["region_pause"], 0).astype(np.int64)
    lens = np.where(active, arrays["region_len"], 0).astype(np.int64)
    remove = np.asarray(arrays["region_remove"]).astype(bool) & active
    after = np.where(active, arrays["region_fade_after"], 0)
    # The zeros just before region r: the pause that closed region r-1.
    zeros = np.concatenate([np.zeros_like(pause[:, :1]), pause[:, :-1]], 1)
    first = np.arange(pause.shape[1])[None, :] == 0

    pos = np.asarray(arrays["fade_pos"]).astype(np.int64)
    flen = np.asarray(arrays["fade_len"]).astype(np.int64)
    reg = np.asarray(arrays["fade_region"]).astype(np.int64)
    live = (pos >= 0) & (flen > 0)
    c = np.maximum(pos, 0)
    before = np.take_along_axis(np.where(first, 0, zeros), reg, 1)
    in_window = ~live | (flen <= c + before)
    post_in_zeros = (after == 0) | first | (after <= zeros)
    # The in-region windows (unused slots too) end at the margin's end
    # at the earliest, so FADEW must fit the margin.
    if (dims.FADEW <= dims.MARGIN and in_window.all()
            and post_in_zeros.all()):
        return 0
    # B_r, the buffer before region r, is at least the pauses and the
    # lengths of the regions that remove no silence; it is known here
    # when no earlier region removes any.
    low = np.cumsum(pause + np.where(remove, 0, lens), 1) - (
        pause + np.where(remove, 0, lens))
    known = (np.cumsum(remove, 1) - remove) == 0
    cut = live & (flen > c + np.take_along_axis(low, reg, 1)) & \
        ~np.take_along_axis(known, reg, 1)
    # Regions with a cut slot, each counted once per row.
    hit = np.zeros(pause.shape, np.int64)
    np.add.at(hit, (np.arange(pos.shape[0])[:, None], reg), cut)
    return 1 + int((hit > 0).sum(1).max(initial=0))


def kept_segments_bound(length, min_silence: int):
    """The most kept segments silence removal can leave in a region of
    `length` samples (an int or an array of them), at min_silence
    samples: floor(length / (L + 1)) + 1, L = max(M, K + 1), with M =
    max(min_silence, 1) and K = max(min_silence // 4, 10).

    Proof, against remove_silence_regions (synth/dsp_np.py; reference/
    ctts.c:1634-1690). The region splits into maximal runs of silent and
    of loud samples. A silent run of r >= M samples keeps its first K
    and drops the other r - K (none when r <= K); every other run is
    kept whole. So the kept samples form segments separated by gaps, and
    each gap is the dropped tail of one silent run of r >= L samples,
    running to that run's end. Every segment but the first starts right
    after a gap, so with g the gaps followed by a kept sample there are
    at most g + 1 segments. The sample after such a gap ends the run, so
    it is loud: the g runs and their g loud followers are disjoint, and
    length >= g (L + 1). A region that is all zero or empty is kept
    whole (one segment or none). silence_segments classifies the samples
    the same way (its long_run and prefix_ok masks), so its count obeys
    the bound too. Since L >= M, the bound is at most floor((length + 1)
    / (M + 1)) + 1; it is reached by runs of L silent samples each
    followed by one loud sample."""
    m = max(min_silence, 1)
    run = max(m, max(min_silence // 4, MIN_KEPT_SILENCE) + 1)
    return np.asarray(length, np.int64) // (run + 1) + 1


def seg_width(dims: PlanDims, arrays: dict) -> int:
    """The silence-table width that holds every kept segment of a batch
    (arrays stacked [B, ...], or one plan's): the smallest power of two,
    at least NBLK = 32, not below kept_segments_bound of any active
    region that removes silence. The core runs every batch at 32 first;
    only the rows whose regions overflow that table run again at this
    width (compiled.run_wide)."""
    remove = (np.asarray(arrays["region_remove"]).astype(bool)
              & np.asarray(arrays["region_active"]).astype(bool))
    lens = np.where(remove, arrays["region_len"], 0)
    need = int(kept_segments_bound(lens, dims.min_silence_samples).max(
        initial=1))
    return _next_pow2(need, NBLK)


@dataclasses.dataclass
class WalkedPlan:
    """Host lowering intermediate: the plan walked into region/unit/fade
    records, before padding into dims-shaped arrays. Built once per plan
    (walk_plan) and reusable across dims (fill_device_plan) so the batch
    path does not lower every plan twice."""

    plan: SynthesisPlan
    units: list
    regions: list
    fades: list
    cf_max: int
    margin: int
    win: int
    cfmax: int
    max_region_len: int
    total_len: int
    stretch: bool
    synth_hop: int
    refine_trips: int = 0  # head-mod chain depth (fixed-point bodies)


def walk_plan(plan: SynthesisPlan, db: VoiceDatabase) -> WalkedPlan:
    """Walk a compiled plan's ops into region-relative unit/fade records
    (the dims-independent half of lowering)."""
    check_config(plan.config)
    unit_ids = {op.unit_idx for op in plan.ops if op.kind == OpKind.UNIT}
    unit_lens = {i: int(db.index[i]["sample_count"]) for i in unit_ids}

    cf_max = max([op.crossfade_samples for op in plan.ops
                  if op.kind == OpKind.UNIT] + [1])
    # 1024-sample (8x128 tile) alignment: Pallas DMA shapes must be
    # sublane-tile aligned.
    win = _roundup(max(2 * cf_max, 1024), 1024)
    cfmax = _roundup(cf_max, 1024)
    margin = win + cfmax

    # --- walk ops into regions -------------------------------------------
    units, regions, fades = [], [], []
    cur = {"len": 0, "do_dsp": False, "word_index": 0, "pause_after": 0,
           "fade_after": 0}
    cursor = 0
    # static running sentence length (pre-removal proxy); starts at the
    # plan's offset so sentence-split rows bake the same caps as unsplit
    buf_total = plan.buf_total0
    post_dsp = False

    def close_region():
        nonlocal cur, cursor, post_dsp
        cur["len"] = cursor
        regions.append(cur)
        cur = {"len": 0, "do_dsp": False, "word_index": 0, "pause_after": 0,
               "fade_after": 0}
        cursor = 0
        post_dsp = False

    for oi, op in enumerate(plan.ops):
        r = len(regions)
        if op.kind == OpKind.UNIT:
            n = unit_lens[op.unit_idx]
            if op.after_word_boundary or buf_total == 0:
                cf_in, fade_in = 0, True
            elif op.crossfade_samples == 0:
                cf_in, fade_in = 0, False
            else:
                cf_in = min(op.crossfade_samples, buf_total, n)
                fade_in = False
            off = cursor - cf_in
            boundary = op.crossfade_samples
            units.append({
                "id": op.unit_idx, "region": r, "off": off,
                "boundary": boundary, "cf_in": cf_in, "fade_in": fade_in,
                "smooth": op.smooth_boundary and buf_total > 0,
                "analysis": min(2 * boundary, buf_total // 2, n // 2),
                "boundary_len": min(boundary, buf_total, n),
                "shift_region": min(boundary, n // 4),
                "prev_ok": buf_total >= 200,
            })
            cursor = off + n
            buf_total += n - cf_in
        elif op.kind == OpKind.SILENCE:
            nxt = plan.ops[oi + 1] if oi + 1 < len(plan.ops) else None
            closes = nxt is not None and nxt.kind == OpKind.MARK_WORD
            if post_dsp or closes:
                # Trailing pause (word pause, or a sentence-end pause
                # right before the region closes): emit as an assembly
                # gap instead of in-region zeros — keeps sentence-final
                # regions (punctuation pauses are ~3x word pause) out of
                # the region-content width that sizes CONTW/WREG.
                cur["pause_after"] += op.n_samples
            else:
                cursor += op.n_samples
            buf_total += op.n_samples
        elif op.kind == OpKind.FADE_TAIL:
            if post_dsp:
                cur["fade_after"] = op.fade_samples
            else:
                fades.append((r, cursor, op.fade_samples))
        elif op.kind == OpKind.WORD_DSP:
            cur["do_dsp"] = True
            cur["word_index"] = op.word_index
            post_dsp = True
        elif op.kind == OpKind.MARK_WORD:
            close_region()
    close_region()

    max_region_len = max([r["len"] for r in regions] + [1])

    # Head-mod chain depth (static): the fixed-point compose needs
    # depth_k bodies before unit k's head is final. Only boundary-DSP
    # units (smooth & boundary>0) ever change their head across trips;
    # crossfade mixing is in-scan sequential and therefore exact within
    # each trip given correct heads. A modifying unit j perturbs
    # [off_j, off_j + m_j) (its mix + energy + pitch-shift reach); unit
    # k's analysis window is [off_k + cf_k - win, off_k + cf_k) in the
    # same region, so depth_k = 1 + max depth of modifying units visible
    # there. Conservative: runtime gates (`voiced`, RMS floors) can only
    # skip mods, never extend reach, so the trip count always suffices.
    depth_by_region: dict = {}
    refine_trips = 0
    for u in units:
        modifies = u["smooth"] and u["boundary"] > 0
        m = max(u["cf_in"], u["boundary_len"], u["shift_region"])
        lo = u["off"] + u["cf_in"] - win
        hi = u["off"] + u["cf_in"]
        d = 0
        if modifies:
            d = 1
            for off_j, m_j, d_j in depth_by_region.get(u["region"], []):
                if d_j > 0 and off_j + m_j > lo and off_j < hi:
                    d = max(d, 1 + d_j)
        depth_by_region.setdefault(u["region"], []).append(
            (u["off"], m, d)
        )
        refine_trips = max(refine_trips, d)

    stretch = bool(np.float32(plan.speed) != np.float32(1.0))
    synth_hop = synthesis_hop_for_speed(plan.speed) if stretch else 0
    total_len = sum(r["len"] + r["pause_after"] for r in regions)
    return WalkedPlan(
        plan=plan, units=units, regions=regions, fades=fades,
        cf_max=cf_max, margin=margin, win=win, cfmax=cfmax,
        max_region_len=max_region_len, total_len=total_len,
        stretch=stretch, synth_hop=synth_hop, refine_trips=refine_trips,
    )


def _shift_candidates(units, db) -> list:
    """Unit slots whose host-known gates allow a boundary pitch shift
    (the do_smooth gates of ctts.c:1990-2001 minus the device-side
    voiced/jump pitch tests)."""
    lens = db.index["sample_count"]
    return [
        k for k, u in enumerate(units)
        if u["smooth"] and u["boundary"] > 0 and u["prev_ok"]
        and u["shift_region"] > 0 and int(lens[u["id"]]) >= 200
    ]


def derive_dims(w: WalkedPlan, db: VoiceDatabase) -> PlanDims:
    """Minimal per-sentence static dimensions for a walked plan."""
    cfg = w.plan.config
    bank_w = _roundup(int(db.index["sample_count"].max()), 1024)
    smax = _roundup(max(w.total_len, 1024))
    return PlanDims(
        NSHIFT=max(_roundup(len(_shift_candidates(w.units, db)), 8), 8),
        U=max(len(w.units), 1),
        R=max(len(w.regions), 1),
        FD=max(len(w.fades), 1),
        WREG=_roundup(w.margin + w.max_region_len + bank_w + w.cfmax, 1024),
        MARGIN=w.margin,
        UBUF=bank_w,
        WIN=w.win,
        CFMAX=w.cfmax,
        SMAX=smax,
        OMAX=_omax_for(smax, w.stretch, w.synth_hop),
        CONTW=min(_next_pow2(max(w.max_region_len, 1024), 1024),
                  _roundup(w.margin + w.max_region_len + bank_w + w.cfmax,
                           1024) - w.margin),
        **fade_widths(w.plan.fade_out_samples),
        fade_in_samples=w.plan.fade_in_samples,
        min_silence_samples=w.plan.min_silence_samples,
        remove_dc=bool(cfg.remove_dc_offset),
        stretch=w.stretch,
        synth_hop=w.synth_hop,
        contour_drift=min(
            int(np.ceil(256 * abs(cfg.max_pitch_change))) + 2, 256
        ),
    )


def fill_device_plan(w: WalkedPlan, db: VoiceDatabase,
                     dims: PlanDims) -> DevicePlan:
    """Pad a walked plan into dims-shaped arrays (dims-dependent half)."""
    plan, units, regions, fades = w.plan, w.units, w.regions, w.fades
    cfg = plan.config
    bank_w = _roundup(int(db.index["sample_count"].max()), 1024)
    assert dims.stretch == w.stretch, "speed class must match the bucket"
    assert dims.synth_hop == w.synth_hop, \
        "synthesis hop must match the bucket"
    assert len(units) <= dims.U and len(regions) <= dims.R
    assert len(fades) <= dims.FD
    assert dims.MARGIN >= 2 * w.cf_max, "crossfade exceeds margin"
    assert dims.UBUF >= bank_w
    assert dims.CONTW >= w.max_region_len, "region exceeds CONTW"
    assert dims.CONTW <= dims.WREG - dims.MARGIN
    assert all(f[2] <= dims.FADEW for f in fades), "fade exceeds FADEW"

    a = {}
    a["unit_id"] = np.full(dims.U, -1, np.int32)
    for name, dt in [("unit_region", np.int32), ("unit_off", np.int32),
                     ("unit_boundary", np.int32), ("unit_cf_in", np.int32),
                     ("unit_fade_in", np.bool_), ("unit_smooth", np.bool_),
                     ("unit_analysis", np.int32),
                     ("unit_boundary_len", np.int32),
                     ("unit_shift_region", np.int32),
                     ("unit_prev_ok", np.bool_)]:
        a[name] = np.zeros(dims.U, dt)

    for k, u in enumerate(units):
        a["unit_id"][k] = u["id"]
        a["unit_region"][k] = u["region"]
        a["unit_off"][k] = u["off"] + dims.MARGIN
        a["unit_boundary"][k] = u["boundary"]
        a["unit_cf_in"][k] = u["cf_in"]
        a["unit_fade_in"][k] = u["fade_in"]
        a["unit_smooth"][k] = u["smooth"]
        a["unit_analysis"][k] = u["analysis"]
        a["unit_boundary_len"][k] = u["boundary_len"]
        a["unit_shift_region"][k] = u["shift_region"]
        a["unit_prev_ok"][k] = u["prev_ok"]

    a["region_len"] = np.zeros(dims.R, np.int32)
    a["region_do_dsp"] = np.zeros(dims.R, np.bool_)
    a["region_remove"] = np.zeros(dims.R, np.bool_)
    a["region_pause"] = np.zeros(dims.R, np.int32)
    a["region_fade_after"] = np.zeros(dims.R, np.int32)
    a["region_contour"] = np.tile(
        np.array([1, 1, 1, 1, 1], np.float32), (dims.R, 1)
    )
    a["region_qfinal"] = np.zeros(dims.R, np.bool_)
    a["region_energy"] = np.zeros(dims.R, np.bool_)
    a["region_active"] = np.zeros(dims.R, np.bool_)

    wc = plan.prosody.word_count
    for r, reg in enumerate(regions):
        a["region_len"][r] = reg["len"]
        a["region_active"][r] = True
        a["region_do_dsp"][r] = reg["do_dsp"]
        a["region_remove"][r] = (
            reg["do_dsp"] and cfg.remove_word_silence
            and reg["len"] > plan.min_silence_samples
        )
        a["region_pause"][r] = reg["pause_after"]
        a["region_fade_after"][r] = reg["fade_after"]
        if reg["do_dsp"] and wc > 0:
            ws, we, peak, es, ee, qfinal, eactive = intonation_scalars(
                plan.prosody.intonation, reg["word_index"], wc,
                cfg.max_pitch_change,
            )
            a["region_contour"][r] = [ws, we, peak, es, ee]
            a["region_qfinal"][r] = qfinal
            a["region_energy"][r] = eactive

    a["fade_region"] = np.zeros(dims.FD, np.int32)
    a["fade_pos"] = np.full(dims.FD, -1, np.int32)
    a["fade_len"] = np.zeros(dims.FD, np.int32)
    for k, (r, pos, flen) in enumerate(fades):
        a["fade_region"][k] = r
        a["fade_pos"][k] = pos
        a["fade_len"][k] = flen

    cands = _shift_candidates(units, db)
    assert len(cands) <= dims.NSHIFT, "shift candidates exceed NSHIFT"
    a["shift_slots"] = np.full(dims.NSHIFT, -1, np.int32)
    a["shift_slots"][: len(cands)] = cands

    a["threshold"] = np.float32(cfg.silence_threshold)
    a["speed"] = np.float32(plan.speed)
    a["refine_trips"] = np.int32(w.refine_trips)

    return DevicePlan(dims=dims, arrays=a, speed=plan.speed)


def build_device_plan(plan: SynthesisPlan, db: VoiceDatabase,
                      dims: Optional[PlanDims] = None) -> DevicePlan:
    """Lower a compiled plan to padded arrays. With `dims=None`, minimal
    per-sentence dimensions are derived; pass bucketed dims for batching.
    (Batch callers should walk_plan once and fill_device_plan per bucket.)"""
    w = walk_plan(plan, db)
    if dims is None:
        dims = derive_dims(w, db)
    return fill_device_plan(w, db, dims)


def shared_plan_values(arrays, bank_lens, dims: PlanDims) -> dict:
    """Batch-global distinct-value tables for the fade-curve selects in
    build_core (host-side; pass unbatched — in_axes=None — under vmap).

    The crossfade/fade-in gain curves depend only on one scalar each
    (crossfade length; min(fade_in_samples, unit length)), and a batch
    holds few distinct values of either — so the core evaluates the LUT
    curves once per distinct value and row-selects, instead of paying a
    full-width per-unit LUT gather (53 ms/batch-64). Values are stored
    max(·,1)-normalized and 0-padded to a multiple of 8 (0 never matches
    a normalized value, so padding rows select nothing).

    `arrays` may be a single plan's arrays or a stacked batch of them."""
    cf = np.maximum(np.asarray(arrays["unit_cf_in"]).reshape(-1), 1)
    cfv = np.unique(cf).astype(np.int32)
    uid = np.asarray(arrays["unit_id"]).reshape(-1)
    lens = np.asarray(bank_lens)
    n = np.where(uid >= 0, lens[np.maximum(uid, 0)], 0)
    fades = np.maximum(np.minimum(dims.fade_in_samples, n), 1)
    fv = np.unique(fades).astype(np.int32)

    def pad8(v):
        m = max(8, -(-len(v) // 8) * 8)
        out = np.zeros(m, np.int32)
        out[: len(v)] = v
        return out

    return {"cf_values": pad8(cfv), "fade_values": pad8(fv)}
