"""Host-side sentence splitting of compiled plans.

The reference handles unbounded text with a grow-buffer whose prosody
state resets at sentence-end punctuation (ctts.c:3000-3012, 3763-3766).
The TPU equivalent (SURVEY.md §5.7): split one long plan into per-sentence
batch rows that share the standard bucket, execute them as independent
batch elements, and concatenate the outputs.

Byte-equality with the unsplit device path holds by construction:

- Rows are partitions of the *compiled op stream* (no recompilation), so
  unit choices, crossfades, word indices and prosody scalars are
  identical. The global ProsodyContext (word count, phrase type — the
  reference derives both from the whole raw text) is shared by reference.
- The split point is after the sentence-final FADE_TAIL and *before* the
  sentence-end pause: the pause leads the next row, so a crossfade that
  reaches back before its region start (unit shorter than the crossfade)
  lands in the same row's own pause zeros, exactly like the flat buffer.
- Each row carries buf_total0, the pre-removal running length at its
  start, so the baked analysis/boundary caps (walk_plan) match the
  unsplit walk bit-for-bit.

Splitting requires speed == 1.0: the reference applies WSOLA to the whole
final buffer, so stretch rows cannot be concatenated equivalently.

Copy of ctts_tpu/plan/split.py for the PyTorch port: only the package
name in its imports and module references differs, and the C
reference is cited by its relative path.
"""

from __future__ import annotations

import dataclasses

from ctts_tpu_torch.db.reader import VoiceDatabase
from ctts_tpu_torch.plan.compiler import OpKind, SynthesisPlan

import numpy as np


def split_plan(plan: SynthesisPlan, db: VoiceDatabase) -> list[SynthesisPlan]:
    """Partition a compiled plan at sentence boundaries into row plans.

    Returns [plan] unchanged when there is nothing to split (single
    sentence) or when speed != 1.0.
    """
    if bool(np.float32(plan.speed) != np.float32(1.0)):
        return [plan]

    # Row boundaries: index of the SILENCE (or MARK_WORD when the pause is
    # zero) following each sentence-end FADE_TAIL. The sentence-end
    # MARK_WORD is tagged by the compiler.
    cuts = []
    ops = plan.ops
    for i, op in enumerate(ops):
        if op.kind == OpKind.MARK_WORD and op.sentence_end:
            # Pattern emitted by the punct branch: FADE_TAIL [SILENCE]
            # MARK_WORD. Cut before the SILENCE if present, else before
            # this MARK_WORD.
            cut = i
            if i >= 1 and ops[i - 1].kind == OpKind.SILENCE:
                cut = i - 1
            cuts.append(cut)
    # Drop a trailing cut at/after the end-of-plan epilogue start (a
    # sentence end at the very end of text would create an empty row with
    # only the trailing WORD_DSP/FADE_TAIL — keep it attached instead).
    cuts = [c for c in cuts if c > 0]
    if not cuts:
        return [plan]

    bounds = [0] + cuts + [len(ops)]
    rows = []
    buf_total = plan.buf_total0
    unit_len_cache: dict[int, int] = {}

    def unit_len(idx: int) -> int:
        if idx not in unit_len_cache:
            unit_len_cache[idx] = int(db.index[idx]["sample_count"])
        return unit_len_cache[idx]

    for s, e in zip(bounds[:-1], bounds[1:]):
        if s == e:
            continue
        rows.append(dataclasses.replace(
            plan, ops=ops[s:e], buf_total0=buf_total
        ))
        # Advance the pre-removal running length over this row exactly
        # like walk_plan does.
        for op in ops[s:e]:
            if op.kind == OpKind.UNIT:
                n = unit_len(op.unit_idx)
                if (op.after_word_boundary or buf_total == 0
                        or op.crossfade_samples == 0):
                    cf_in = 0
                else:
                    cf_in = min(op.crossfade_samples, buf_total, n)
                buf_total += n - cf_in
            elif op.kind == OpKind.SILENCE:
                buf_total += op.n_samples

    # A text ending in sentence punctuation leaves a unit-less final row
    # (trailing pause + epilogue); merge it into the previous row rather
    # than spending a batch slot on silence.
    if len(rows) > 1 and not any(
        op.kind == OpKind.UNIT for op in rows[-1].ops
    ):
        tail = rows.pop()
        rows[-1] = dataclasses.replace(
            rows[-1], ops=rows[-1].ops + tail.ops
        )
    return rows if len(rows) > 1 else [plan]
