"""Reference-faithful NumPy DSP primitives.

Each function mirrors one C routine bit-for-bit where feasible:

- float work is done in float32 with the reference's operation *order*
  (sequential accumulations are reproduced with f32 cumsum, 4-way unrolled
  sums with grouped adds);
- double accumulations (RMS) use float64;
- float→int16 stores truncate toward zero with asymmetric clamping, as C
  `(int16_t)` casts do;
- int16 overflow in overlap-add accumulators wraps (two's complement), as
  gcc does.

Parity sources are cited per function (file:line into reference).
These primitives are the *oracle* used to validate the TPU executor; the
device implementations live in ctts_tpu_torch.ops.

Frozen copy of ctts_tpu_torch/synth/dsp_np.py for the benchmark's reference
(benchmark/reference/): only the imports differ, so that a later
change to the port cannot move what the benchmark compares with.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference.constants import FADE_LUT_SIZE, SAMPLE_RATE

F32 = np.float32
_PI = F32(3.14159265358979323846)


def trunc_i16(x: np.ndarray) -> np.ndarray:
    """C `(int16_t)float` after explicit clamping: truncate toward zero.
    Caller is responsible for the clamp where the C clamps."""
    return np.trunc(x).astype(np.int32).astype(np.int16)


def clamp_trunc_i16(x: np.ndarray) -> np.ndarray:
    """Clamp to [-32768, 32767] then truncate toward zero (the reference's
    usual store sequence)."""
    x = np.clip(x, F32(-32768.0), F32(32767.0))
    return trunc_i16(x)


def seq_f32_sum(products: np.ndarray) -> np.float32:
    """Sequential float32 accumulation (C `float acc; acc += x[i]`),
    reproduced exactly via f32 cumsum."""
    p = products.astype(F32, copy=False)
    if p.size == 0:
        return F32(0.0)
    return np.cumsum(p, dtype=F32)[-1]


def seq_f32_sum_axis(products: np.ndarray) -> np.ndarray:
    """Sequential f32 accumulation along the last axis, batched."""
    p = products.astype(F32, copy=False)
    if p.shape[-1] == 0:
        return np.zeros(p.shape[:-1], dtype=F32)
    return np.cumsum(p, axis=-1, dtype=F32)[..., -1]


# ---------------------------------------------------------------------------
# Fade lookup tables (ctts.c:52-101)
# ---------------------------------------------------------------------------

_t = np.arange(FADE_LUT_SIZE, dtype=F32) / F32(FADE_LUT_SIZE - 1)
FADE_OUT_LUT = (F32(0.5) * (F32(1.0) + np.cos(_PI * _t, dtype=F32))).astype(F32)
FADE_IN_LUT = (F32(0.5) * (F32(1.0) - np.cos(_PI * _t, dtype=F32))).astype(F32)
SINE_FADE_LUT = np.sin(_t * _PI * F32(0.5), dtype=F32).astype(F32)
del _t


def _lut_lookup(lut: np.ndarray, t: np.ndarray) -> np.ndarray:
    """fast_fade_* linear-interp lookup (ctts.c:76-101)."""
    t = t.astype(F32, copy=False)
    idx_f = t * F32(FADE_LUT_SIZE - 1)
    idx = idx_f.astype(np.int32)  # C (int) cast truncates toward zero
    hi = idx >= FADE_LUT_SIZE - 1
    lo = idx < 0
    idx_c = np.clip(idx, 0, FADE_LUT_SIZE - 2)
    frac = (idx_f - idx_c.astype(F32)).astype(F32)
    val = lut[idx_c] * (F32(1.0) - frac) + lut[idx_c + 1] * frac
    val = np.where(hi, lut[FADE_LUT_SIZE - 1], val)
    val = np.where(lo, lut[0], val)
    return val.astype(F32)


def fast_fade_out(t: np.ndarray) -> np.ndarray:
    return _lut_lookup(FADE_OUT_LUT, t)


def fast_fade_in(t: np.ndarray) -> np.ndarray:
    return _lut_lookup(FADE_IN_LUT, t)


def fast_sine_fade(t: np.ndarray) -> np.ndarray:
    return _lut_lookup(SINE_FADE_LUT, t)


# ---------------------------------------------------------------------------
# Basic sample processing
# ---------------------------------------------------------------------------


def remove_dc_offset(samples: np.ndarray) -> np.ndarray:
    """Mean-subtract with int64 truncating division (ctts.c:1568-1583)."""
    count = samples.shape[0]
    if count == 0:
        return samples
    total = int(np.sum(samples.astype(np.int64)))
    # C int64 division truncates toward zero; |mean| fits in int16.
    dc = abs(total) // count
    if total < 0:
        dc = -dc
    val = samples.astype(np.int32) - np.int32(dc)
    return np.clip(val, -32768, 32767).astype(np.int16)


def apply_fade_in(samples: np.ndarray, fade_samples: int) -> np.ndarray:
    """Quarter-sine fade-in via LUT (ctts.c:3015-3025)."""
    count = samples.shape[0]
    if fade_samples == 0 or count == 0:
        return samples
    fade_samples = min(fade_samples, count)
    inv = F32(1.0) / F32(fade_samples)
    i = np.arange(fade_samples, dtype=F32)
    gain = fast_sine_fade(i * inv)
    out = samples.copy()
    out[:fade_samples] = trunc_i16(samples[:fade_samples].astype(F32) * gain)
    return out


def apply_fade_out(samples: np.ndarray, fade_samples: int) -> np.ndarray:
    """Quarter-sine fade-out of the tail (ctts.c:3028-3039). Note t runs
    fade_samples→1 over the tail (never reaches exactly 0)."""
    count = samples.shape[0]
    if fade_samples == 0 or count == 0:
        return samples
    fade_samples = min(fade_samples, count)
    start = count - fade_samples
    inv = F32(1.0) / F32(fade_samples)
    i = np.arange(fade_samples, dtype=F32)
    t = (F32(fade_samples) - i) * inv
    gain = fast_sine_fade(t)
    out = samples.copy()
    out[start:] = trunc_i16(samples[start:].astype(F32) * gain)
    return out


def calculate_rms(samples: np.ndarray) -> np.float32:
    """RMS with double accumulation (ctts.c:1697-1706)."""
    count = samples.shape[0]
    if count == 0:
        return F32(0.0)
    s = samples.astype(np.float64)
    return F32(np.sqrt(np.sum(s * s) / count))


def normalize_rms(samples: np.ndarray, target_rms: float) -> np.ndarray:
    """Gain to target RMS, clamped 0.1-3.0 (ctts.c:1709-1727)."""
    count = samples.shape[0]
    if count == 0 or target_rms <= 0:
        return samples
    current = calculate_rms(samples)
    if current < F32(1.0):
        return samples
    gain = F32(target_rms) / current
    gain = min(max(gain, F32(0.1)), F32(3.0))
    return clamp_trunc_i16(samples.astype(F32) * gain)


def match_boundary_energy(
    prev_tail: np.ndarray, next_samples: np.ndarray, crossfade_samples: int
) -> np.ndarray:
    """Blend next's head gain from (prev_rms/next_rms) to 1.0
    (ctts.c:1730-1759). `prev_tail` must be the final `boundary_len`
    samples of the buffer; pass the whole buffer and this slices."""
    prev_count = prev_tail.shape[0]
    next_count = next_samples.shape[0]
    if crossfade_samples == 0 or prev_count == 0 or next_count == 0:
        return next_samples
    boundary_len = min(crossfade_samples, prev_count, next_count)
    prev_rms = calculate_rms(prev_tail[prev_count - boundary_len :])
    next_rms = calculate_rms(next_samples[:boundary_len])
    if prev_rms < F32(1.0) or next_rms < F32(1.0):
        return next_samples
    ratio = prev_rms / next_rms
    ratio = min(max(ratio, F32(0.5)), F32(2.0))
    i = np.arange(boundary_len, dtype=F32)
    t = i / F32(boundary_len)
    gain = ratio * (F32(1.0) - t) + F32(1.0) * t
    out = next_samples.copy()
    out[:boundary_len] = clamp_trunc_i16(
        next_samples[:boundary_len].astype(F32) * gain
    )
    return out


# ---------------------------------------------------------------------------
# Silence removal (ctts.c:1634-1690)
# ---------------------------------------------------------------------------


def remove_silence_regions(
    samples: np.ndarray, threshold: float, min_silence_samples: int
) -> np.ndarray:
    """Compact sub-threshold runs ≥ min_silence_samples down to
    max(min_silence_samples/4, 10) samples; returns the shortened array."""
    count = samples.shape[0]
    if count == 0:
        return samples
    abs_val = np.abs(samples.astype(np.int32))
    max_amp = int(abs_val.max())
    if max_amp == 0:
        return samples
    # (int16_t)(max_amp * threshold): float multiply then trunc (C int16 cast
    # of a float; max_amp*threshold ≤ 32767 so no clamp needed).
    abs_threshold = int(np.trunc(F32(max_amp) * F32(threshold)))

    silent = abs_val <= abs_threshold
    keep_n = max(min_silence_samples // 4, 10)

    # Run-length encode the silence mask.
    out_chunks = []
    i = 0
    # Find run boundaries vectorized.
    change = np.flatnonzero(np.diff(silent.astype(np.int8)))
    starts = np.concatenate(([0], change + 1))
    ends = np.concatenate((change + 1, [count]))
    for s, e in zip(starts, ends):
        if silent[s]:
            run = e - s
            if run >= min_silence_samples:
                out_chunks.append(samples[s : min(s + keep_n, count)])
            else:
                out_chunks.append(samples[s:e])
        else:
            out_chunks.append(samples[s:e])
    return np.concatenate(out_chunks) if out_chunks else samples[:0]


# ---------------------------------------------------------------------------
# Pitch estimation & smoothing (ctts.c:1899-2024)
# ---------------------------------------------------------------------------


def estimate_pitch(samples: np.ndarray) -> np.float32:
    """Normalized-autocorrelation pitch over 80-400 Hz; voiced iff
    corr > 0.3 (ctts.c:1899-1943).

    DECISION-EXACT contract (see cross_correlation): the lag sums are
    exact integers (f64) rounded to f32 once; the device computes the
    same integers via split-component convolutions
    (device_ops._pitch_from_segment), so the lag argmax and voiced
    threshold are bit-stable device-vs-oracle. The C's sequential f32
    accumulation agrees except on float near-ties (pinned by the golden
    corpus)."""
    count = samples.shape[0]
    if count < 200:
        return F32(0.0)

    min_lag = SAMPLE_RATE // 400  # 55
    max_lag = SAMPLE_RATE // 80   # 275
    if max_lag > count // 2:
        max_lag = count // 2

    analysis_len = SAMPLE_RATE // 100  # 220
    if analysis_len > count - max_lag:
        analysis_len = count - max_lag

    if analysis_len <= 0 or max_lag < min_lag:
        return F32(0.0)

    s = samples.astype(np.float64)
    lags = np.arange(min_lag, max_lag + 1)
    # Gather [n_lags, analysis_len] windows.
    base = s[:analysis_len]
    idx = lags[:, None] + np.arange(analysis_len)[None, :]
    shifted = s[idx]

    corr = (shifted @ base).astype(F32)
    e1 = np.full(corr.shape, F32(np.dot(base, base)), F32)
    e2 = np.einsum("ni,ni->n", shifted, shifted).astype(F32)

    norm = np.sqrt(e1 * e2, dtype=F32)
    corr = np.divide(corr, norm, out=corr.copy(), where=norm > 0)

    # C keeps the FIRST maximum under strict '>', starting from
    # best_corr = 0.0f — so a non-positive best means "unvoiced".
    best = int(np.argmax(corr))
    best_corr = corr[best]
    best_lag = int(lags[best])
    if best_corr > F32(0.3) and best_lag > 0:
        return F32(SAMPLE_RATE) / F32(best_lag)
    return F32(0.0)


def apply_pitch_shift(samples: np.ndarray, factor: np.float32) -> np.ndarray:
    """Linear-resample pitch shift for small adjustments
    (ctts.c:1946-1976)."""
    count = samples.shape[0]
    if factor < F32(0.9) or factor > F32(1.1) or count < 100:
        return samples
    new_count = int(F32(count) / factor)  # C size_t cast of f32 division
    i = np.arange(new_count, dtype=F32)
    src_pos = i * factor
    idx = src_pos.astype(np.int64)
    frac = (src_pos - idx.astype(F32)).astype(F32)
    temp = np.zeros(new_count, dtype=np.int16)
    ok2 = idx + 1 < count
    ok1 = (~ok2) & (idx < count)
    lerp_idx = np.minimum(idx, count - 1)
    lerp = (
        samples[lerp_idx].astype(F32) * (F32(1.0) - frac)
        + samples[np.minimum(lerp_idx + 1, count - 1)].astype(F32) * frac
    )
    temp[ok2] = trunc_i16(lerp[ok2])
    temp[ok1] = samples[np.minimum(idx, count - 1)][ok1]
    # (idx >= count would read uninitialized memory in C; we use 0.)
    copy_count = min(new_count, count)
    out = samples.copy()
    out[:copy_count] = temp[:copy_count]
    if copy_count < count:
        out[copy_count:] = 0
    return out


def smooth_pitch_boundary(
    buffer_tail: np.ndarray, next_samples: np.ndarray, boundary_samples: int
) -> np.ndarray:
    """Halve >15% pitch jumps by shifting the next unit's head
    (ctts.c:1979-2024). `buffer_tail` is the full current buffer (the C
    passes buf.data/buf.count)."""
    prev_count = buffer_tail.shape[0]
    next_count = next_samples.shape[0]
    if boundary_samples == 0 or prev_count < 200 or next_count < 200:
        return next_samples

    analysis_region = boundary_samples * 2
    if analysis_region > prev_count // 2:
        analysis_region = prev_count // 2
    if analysis_region > next_count // 2:
        analysis_region = next_count // 2

    prev_pitch = estimate_pitch(buffer_tail[prev_count - analysis_region :][:analysis_region])
    next_pitch = estimate_pitch(next_samples[:analysis_region])

    if prev_pitch > 0 and next_pitch > 0:
        ratio = next_pitch / prev_pitch
        if ratio > F32(1.15) or ratio < F32(0.85):
            if ratio > F32(1.0):
                target_ratio = F32(1.0) + (ratio - F32(1.0)) * F32(0.5)
            else:
                target_ratio = F32(1.0) - (F32(1.0) - ratio) * F32(0.5)
            shift_factor = target_ratio / ratio

            shift_region = boundary_samples
            if shift_region > next_count // 4:
                shift_region = next_count // 4
            if shift_region > 0:
                region = next_samples[:shift_region].copy()
                region = apply_pitch_shift(region, shift_factor)
                i = np.arange(shift_region, dtype=F32)
                t = i / F32(shift_region)
                blended = region.astype(F32) * (F32(1.0) - t) + next_samples[
                    :shift_region
                ].astype(F32) * t
                out = next_samples.copy()
                out[:shift_region] = trunc_i16(blended)
                return out
    return next_samples


# ---------------------------------------------------------------------------
# Smooth pitch contour (ctts.c:2194-2273)
# ---------------------------------------------------------------------------

PITCH_FRAME = 256
_hann_i = np.arange(PITCH_FRAME, dtype=F32)
HANNING_256 = (
    F32(0.5) * (F32(1.0) - np.cos(F32(2.0) * _PI * _hann_i / F32(PITCH_FRAME)))
).astype(F32)
del _hann_i


def apply_smooth_pitch_contour(
    samples: np.ndarray, start_factor: np.float32, end_factor: np.float32
) -> np.ndarray:
    """Frame-wise resampling OLA imposing a smoothstep pitch ramp
    (ctts.c:2206-2273). int16 accumulation wraps, per gcc behavior."""
    count = samples.shape[0]
    start_factor = F32(start_factor)
    end_factor = F32(end_factor)
    if count < 100 or abs(start_factor - end_factor) < F32(0.01):
        return samples

    frame = PITCH_FRAME
    hop = frame // 2

    temp = samples.copy()
    norm = np.zeros(count, dtype=F32)
    out = np.zeros(count, dtype=np.int16)

    if count == frame:
        inv_count = F32(np.inf)
    else:
        inv_count = F32(1.0) / F32(count - frame)

    i_idx = np.arange(frame, dtype=F32)
    for pos in range(0, count - frame + 1, hop):
        t = F32(pos) * inv_count
        smooth_t = t * t * (F32(3.0) - F32(2.0) * t)
        pitch_factor = start_factor + (end_factor - start_factor) * smooth_t

        src_idx = i_idx * pitch_factor
        idx = src_idx.astype(np.int64)
        frac = (src_idx - idx.astype(F32)).astype(F32)
        in_range = idx + 1 < frame
        # The C's else-branch reads temp[pos + idx] with idx possibly past
        # the frame end (ctts.c:2251), i.e. into *subsequent* samples; for
        # the final frame that can run past the buffer (heap garbage in C)
        # — we substitute 0 there, the only non-replicable UB.
        src_pos = np.minimum(pos + idx, count - 1)
        a = temp[src_pos].astype(F32)
        a = np.where(pos + idx < count, a, F32(0.0))
        b = temp[np.minimum(src_pos + 1, count - 1)].astype(F32)
        sample = np.where(in_range, a * (F32(1.0) - frac) + b * frac, a)

        contrib = trunc_i16(sample * HANNING_256)
        # int16 wrapping accumulate (C: int16_t += int16_t).
        seg = out[pos : pos + frame]
        out[pos : pos + frame] = (
            seg.astype(np.int32) + contrib.astype(np.int32)
        ).astype(np.int16)
        norm[pos : pos + frame] += HANNING_256

    good = norm > F32(0.01)
    val = out.astype(F32) / np.where(good, norm, F32(1.0))
    val = np.clip(val, F32(-32768.0), F32(32767.0))
    result = np.where(good, trunc_i16(val), temp)
    return result.astype(np.int16)


# ---------------------------------------------------------------------------
# Phrase intonation (ctts.c:2736-2866)
# ---------------------------------------------------------------------------


def _clamp_pitch_f32(p: np.float32, max_change: np.float32) -> np.float32:
    lo = F32(1.0) - max_change
    hi = F32(1.0) + max_change
    if p < lo:
        return lo
    if p > hi:
        return hi
    return F32(p)


def apply_phrase_intonation(
    samples: np.ndarray,
    inton,  # ctts_tpu_torch.text.prosody.PhraseIntonation
    word_index: int,
    total_words: int,
    max_pitch_change: float,
) -> np.ndarray:
    """Per-word contour + energy ramp (ctts.c:2736-2866).

    The scalar plumbing (phrase position, smoothstep, specials per phrase
    type) is reproduced in float32; the waveform work is delegated to
    apply_smooth_pitch_contour.
    """
    from benchmark.reference.prosody import PhraseType

    count = samples.shape[0]
    if count < 100 or total_words == 0:
        return samples

    mc = F32(max_pitch_change)
    denom = total_words - 1 if total_words > 1 else 1
    phrase_pos = F32(word_index) / F32(denom)
    is_final = word_index == total_words - 1
    is_penult = (word_index == total_words - 2) and (total_words > 1)

    peak_pos = F32(inton.peak_position)
    p_start = F32(inton.pitch_start)
    p_end = F32(inton.pitch_end)
    p_peak = F32(inton.pitch_peak)

    if phrase_pos <= peak_pos:
        t = phrase_pos / peak_pos
        t = t * t * (F32(3.0) - F32(2.0) * t)
        pitch_factor = p_start + (p_peak - p_start) * t
    else:
        t = (phrase_pos - peak_pos) / (F32(1.0) - peak_pos)
        t = t * t * (F32(3.0) - F32(2.0) * t)
        pitch_factor = p_peak + (p_end - p_peak) * t

    pitch_factor = _clamp_pitch_f32(pitch_factor, mc)

    word_start = _clamp_pitch_f32(pitch_factor * F32(0.98), mc)
    word_end = _clamp_pitch_f32(pitch_factor * F32(1.02), mc)

    out = samples
    skip_contour = False

    if inton.type == PhraseType.INTERROGATIVE and (is_final or is_penult):
        if is_final:
            word_start = _clamp_pitch_f32(pitch_factor * F32(0.95), mc)
            word_end = _clamp_pitch_f32(p_end, mc)
            rise = int(F32(count) * F32(0.6))
            if rise > 100 and count - rise > 100:
                peak = _clamp_pitch_f32(p_peak, mc)
                head = apply_smooth_pitch_contour(out[:rise], word_start, peak)
                tail = apply_smooth_pitch_contour(out[rise:], peak, word_end)
                out = np.concatenate([head, tail])
                skip_contour = True
        else:
            word_start = _clamp_pitch_f32(pitch_factor * F32(0.98), mc)
            word_end = _clamp_pitch_f32(pitch_factor * F32(1.05), mc)
    elif inton.type == PhraseType.EXCLAMATORY:
        if word_index == 0:
            word_start = _clamp_pitch_f32(p_peak, mc)
            word_end = _clamp_pitch_f32(pitch_factor, mc)
        elif is_final:
            word_start = _clamp_pitch_f32(pitch_factor, mc)
            word_end = _clamp_pitch_f32(p_end, mc)
        else:
            word_start = _clamp_pitch_f32(pitch_factor * F32(1.02), mc)
            word_end = _clamp_pitch_f32(pitch_factor * F32(0.98), mc)
    elif inton.type == PhraseType.CONTINUATION and is_final:
        word_start = _clamp_pitch_f32(pitch_factor * F32(0.96), mc)
        word_end = _clamp_pitch_f32(p_end, mc)
    else:
        word_start = _clamp_pitch_f32(pitch_factor * F32(0.98), mc)
        word_end = _clamp_pitch_f32(pitch_factor * F32(1.02), mc)
        if is_final:
            word_end = _clamp_pitch_f32(p_end, mc)

    if not skip_contour:
        out = apply_smooth_pitch_contour(out, word_start, word_end)

    # Energy ramp (ctts.c:2841-2865).
    energy_factor = F32(inton.energy_factor)
    if abs(energy_factor - F32(1.0)) > F32(0.01):
        e_start = energy_factor
        e_end = energy_factor
        if inton.type == PhraseType.EXCLAMATORY and word_index == 0:
            e_start = energy_factor * F32(1.1)
            e_end = energy_factor * F32(0.95)
        i = np.arange(count, dtype=F32)
        t = i / F32(count - 1)
        energy = e_start + (e_end - e_start) * t
        out = clamp_trunc_i16(out.astype(F32) * energy)

    return out


# ---------------------------------------------------------------------------
# Crossfade append (ctts.c:3279-3358)
# ---------------------------------------------------------------------------


def crossfade_mix(
    prev_tail: np.ndarray, next_head: np.ndarray
) -> np.ndarray:
    """Raised-cosine LUT crossfade of equal-length segments
    (ctts.c:3324-3345)."""
    n = prev_tail.shape[0]
    if n == 0:
        return prev_tail
    inv = F32(1.0) / F32(n)
    t = np.arange(n, dtype=F32) * inv
    prev_gain = fast_fade_out(t)
    next_gain = fast_fade_in(t)
    mixed = (
        prev_tail.astype(F32) * prev_gain + next_head.astype(F32) * next_gain
    )
    # C truncates the f32 sum to int32 then clamps (ctts.c:3337-3342).
    mixed_i = np.trunc(mixed).astype(np.int64)
    mixed_i = np.clip(mixed_i, -32768, 32767)
    return mixed_i.astype(np.int16)


# ---------------------------------------------------------------------------
# WSOLA time stretch (ctts.c:3378-3617)
# ---------------------------------------------------------------------------


def hanning_window(n: int) -> np.ndarray:
    """hanning(i, N) (ctts.c:1624-1626)."""
    i = np.arange(n, dtype=F32)
    return (F32(0.5) * (F32(1.0) - np.cos(F32(2.0) * _PI * i / F32(n)))).astype(F32)


def cross_correlation(sig1: np.ndarray, sig2: np.ndarray) -> np.float32:
    """Normalized correlation for the WSOLA search (ctts.c:3390-3429).

    DECISION-EXACT contract: the sums are computed as exact integers (f64
    — exact for int16 products over ≤1024 terms) and rounded to f32 once,
    instead of replicating the C's 4-way-unrolled f32 accumulation. The
    device computes the identical integers via hi/lo split matvecs
    (ops.exact), so WSOLA offset decisions are bit-stable device-vs-
    oracle. The C's rounded accumulation agrees except on float near-ties
    (none in the 120-utterance golden corpus, which pins oracle-vs-C)."""
    length = sig1.shape[0]
    if length == 0:
        return F32(0.0)
    a = sig1.astype(np.float64)
    b = sig2.astype(np.float64)
    sum_prod = F32(np.dot(a, b))
    sum_sq1 = F32(np.dot(a, a))
    sum_sq2 = F32(np.dot(b, b))

    denom = F32(np.sqrt(sum_sq1 * sum_sq2, dtype=F32))
    if denom < F32(1.0):
        return F32(0.0)
    return F32(sum_prod / denom)


def batched_cross_correlation(
    candidates: np.ndarray, target: np.ndarray
) -> np.ndarray:
    """cross_correlation vectorized over axis 0 of `candidates` (same
    decision-exact contract)."""
    n, length = candidates.shape
    if length == 0:
        return np.zeros(n, dtype=F32)
    s1 = candidates.astype(np.float64)
    s2 = target.astype(np.float64)
    sum_prod = (s1 @ s2).astype(F32)
    sum_sq1 = np.einsum("ni,ni->n", s1, s1).astype(F32)
    sum_sq2 = F32(np.dot(s2, s2)) * np.ones(n, F32)

    denom = np.sqrt(sum_sq1 * sum_sq2, dtype=F32)
    # C computes sum_prod/denom then discards it when denom < 1.0
    # (ctts.c cross_correlation); the masked divide returns the same
    # bits on kept lanes without the divide-by-zero RuntimeWarning.
    return np.divide(sum_prod, denom, out=np.zeros(n, F32),
                     where=denom >= F32(1.0))


def find_best_match_wsola(
    inp: np.ndarray,
    prev_frame: np.ndarray | None,
    overlap_len: int,
    nominal_pos: int,
    frame_size: int,
    max_shift: int,
) -> int:
    """Coarse(step 4)-then-fine correlation search (ctts.c:3436-3488)."""
    if prev_frame is None or overlap_len == 0:
        return 0
    input_count = inp.shape[0]
    target = prev_frame[frame_size - overlap_len :]

    def corr_at(offsets: np.ndarray, skip: int | None = None):
        best_c = F32(-2.0)
        best_o = 0
        valid = []
        for off in offsets:
            if skip is not None and off == skip:
                continue
            cand = nominal_pos + off
            if cand < 0 or cand + frame_size > input_count:
                continue
            valid.append(off)
        if not valid:
            return None, None
        cands = np.stack([inp[nominal_pos + o : nominal_pos + o + overlap_len]
                          for o in valid])
        corrs = batched_cross_correlation(cands, target)
        return valid, corrs

    best_corr = F32(-2.0)
    best_offset = 0
    coarse = np.arange(-max_shift, max_shift + 1, 4)
    valid, corrs = corr_at(coarse)
    if valid is not None:
        for off, c in zip(valid, corrs):
            if c > best_corr:
                best_corr = c
                best_offset = int(off)

    fine_start = max(best_offset - 3, -max_shift)
    fine_end = min(best_offset + 3, max_shift)
    fine = np.arange(fine_start, fine_end + 1)
    valid, corrs = corr_at(fine, skip=best_offset)
    if valid is not None:
        for off, c in zip(valid, corrs):
            if c > best_corr:
                best_corr = c
                best_offset = int(off)

    return best_offset


def time_stretch(inp: np.ndarray, speed_factor: float) -> np.ndarray:
    """WSOLA time stretch (ctts.c:3490-3617)."""
    speed = F32(speed_factor)
    speed = min(max(speed, F32(0.5)), F32(2.0))
    input_count = inp.shape[0]

    if abs(speed - F32(1.0)) < F32(0.01):
        return inp.copy()

    frame_size = 512
    analysis_hop = frame_size // 4  # 128
    overlap_len = frame_size - analysis_hop  # 384
    max_shift = int(F32(frame_size) * F32(0.25))  # 128

    synthesis_hop = int(F32(analysis_hop) / speed)
    if synthesis_hop < 1:
        synthesis_hop = 1

    num_frames = (
        (input_count - frame_size) // analysis_hop + 1
        if input_count > frame_size
        else 1
    )
    output_count = num_frames * synthesis_hop + frame_size + 1024

    out = np.zeros(output_count, dtype=np.int16)
    norm = np.zeros(output_count, dtype=F32)
    window = hanning_window(frame_size)

    prev_frame: np.ndarray | None = None
    nominal = 0
    synth_pos = 0
    actual_len = 0

    while nominal + frame_size <= input_count and synth_pos + frame_size <= output_count:
        offset = 0
        if prev_frame is not None:
            offset = find_best_match_wsola(
                inp, prev_frame, overlap_len, nominal, frame_size, max_shift
            )
        actual = nominal + offset
        if actual + frame_size > input_count:
            actual = input_count - frame_size

        frame = inp[actual : actual + frame_size]
        contrib = trunc_i16(frame.astype(F32) * window)
        seg = out[synth_pos : synth_pos + frame_size]
        out[synth_pos : synth_pos + frame_size] = (
            seg.astype(np.int32) + contrib.astype(np.int32)
        ).astype(np.int16)
        norm[synth_pos : synth_pos + frame_size] += window

        prev_frame = frame.copy()
        if synth_pos + frame_size > actual_len:
            actual_len = synth_pos + frame_size
        nominal += analysis_hop
        synth_pos += synthesis_hop

    good = norm[:actual_len] > F32(0.01)
    val = out[:actual_len].astype(F32) / np.where(good, norm[:actual_len], F32(1.0))
    val = np.clip(val, F32(-32768.0), F32(32767.0))
    normalized = np.where(good, trunc_i16(val), out[:actual_len])
    result = normalized.astype(np.int16)

    # Trim trailing exact zeros (ctts.c:3612-3614).
    nz = np.flatnonzero(result)
    end = int(nz[-1]) + 1 if nz.size else 0
    return result[:end]
