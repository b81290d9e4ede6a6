"""NumPy oracle executor: runs a SynthesisPlan with the reference's exact
int16/float32 semantics.

This is the ground truth the TPU executor is validated against, and it is
itself validated sample-for-sample against the compiled C binary (see
tests/test_waveform_parity.py). Structure mirrors ctts_synthesize's buffer
pipeline (ctts.c:3623-3924) but consumes the precompiled plan instead of
re-walking the text.

Frozen copy of ctts_tpu_torch/synth/oracle.py for the benchmark's reference
(benchmark/reference/): only the imports differ, so that a later
change to the port cannot move what the benchmark compares with.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference.units import UnitTable as VoiceDatabase
from benchmark.reference.compiler import OpKind, SynthesisPlan
from benchmark.reference import dsp_np as dsp

F32 = np.float32


class SampleBuffer:
    """Growable int16 buffer (ctts.c:2986-3012)."""

    def __init__(self, initial_capacity: int):
        self.data = np.zeros(initial_capacity, dtype=np.int16)
        self.count = 0

    def _grow(self, needed: int) -> None:
        if self.count + needed <= self.data.shape[0]:
            return
        new_cap = self.data.shape[0] * 2
        while new_cap < self.count + needed:
            new_cap *= 2
        new_data = np.zeros(new_cap, dtype=np.int16)
        new_data[: self.count] = self.data[: self.count]
        self.data = new_data

    def append(self, samples: np.ndarray) -> None:
        self._grow(samples.shape[0])
        self.data[self.count : self.count + samples.shape[0]] = samples
        self.count += samples.shape[0]

    def append_silence(self, n: int) -> None:
        self._grow(n)
        self.data[self.count : self.count + n] = 0
        self.count += n

    def view(self) -> np.ndarray:
        return self.data[: self.count]


def _append_crossfade(
    buf: SampleBuffer,
    samples: np.ndarray,
    crossfade_samples: int,
    fade_in_samples: int,
    remove_dc: bool,
    after_word_boundary: bool,
) -> None:
    """buffer_append_crossfade (ctts.c:3279-3358)."""
    count = samples.shape[0]
    if count == 0:
        return

    first = buf.count == 0 or after_word_boundary
    src = samples
    if remove_dc or first:
        src = samples.copy()
        if remove_dc:
            src = dsp.remove_dc_offset(src)

    if first:
        # Copy is always made on this branch, so fade-in always applies.
        src = dsp.apply_fade_in(src, fade_in_samples)
        buf.append(src)
    elif crossfade_samples == 0:
        buf.append(src)
    else:
        actual = min(crossfade_samples, buf.count, count)
        if actual > 0:
            tail = buf.data[buf.count - actual : buf.count]
            buf.data[buf.count - actual : buf.count] = dsp.crossfade_mix(
                tail, src[:actual]
            )
        if count > actual:
            buf.append(src[actual:])


def execute_plan_oracle(plan: SynthesisPlan, db: VoiceDatabase) -> np.ndarray:
    """Execute a plan; returns int16 samples (exact C semantics)."""
    cfg = plan.config
    buf = SampleBuffer(22050 * 10)
    word_start = 0

    for op in plan.ops:
        if op.kind == OpKind.UNIT:
            unit = db.unit_samples(op.unit_idx).copy()
            unit = dsp.normalize_rms(unit, plan.target_rms)

            if op.smooth_boundary and buf.count > 0:
                boundary = op.crossfade_samples
                unit = dsp.smooth_pitch_boundary(buf.view(), unit, boundary)
                unit = dsp.match_boundary_energy(buf.view(), unit, boundary)

            _append_crossfade(
                buf,
                unit,
                op.crossfade_samples,
                plan.fade_in_samples,
                cfg.remove_dc_offset,
                op.after_word_boundary,
            )

        elif op.kind == OpKind.SILENCE:
            buf.append_silence(op.n_samples)

        elif op.kind == OpKind.WORD_DSP:
            if cfg.remove_word_silence and buf.count > word_start:
                word_samples = buf.count - word_start
                if word_samples > plan.min_silence_samples:
                    region = buf.data[word_start : buf.count].copy()
                    new = dsp.remove_silence_regions(
                        region, cfg.silence_threshold, plan.min_silence_samples
                    )
                    buf.data[word_start : word_start + new.shape[0]] = new
                    buf.count = word_start + new.shape[0]
            if buf.count > word_start:
                region = buf.data[word_start : buf.count]
                buf.data[word_start : buf.count] = dsp.apply_phrase_intonation(
                    region,
                    plan.prosody.intonation,
                    op.word_index,
                    plan.prosody.word_count,
                    cfg.max_pitch_change,
                )

        elif op.kind == OpKind.FADE_TAIL:
            if buf.count > 0 and op.fade_samples > 0:
                fade = min(op.fade_samples, buf.count)
                start = buf.count - fade
                tail = dsp.apply_fade_out(buf.view(), op.fade_samples)
                buf.data[start : buf.count] = tail[start:]

        elif op.kind == OpKind.MARK_WORD:
            word_start = buf.count

    result = buf.view().copy()

    # Time stretch for any speed != 1.0 (exact float compare, ctts.c:3907).
    if F32(plan.speed) != F32(1.0):
        result = dsp.time_stretch(result, plan.speed)

    return result
