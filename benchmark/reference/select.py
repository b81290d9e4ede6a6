"""Greedy longest-match unit selection with one-step look-ahead and
Portuguese phonotactic scoring.

Parity sources: find_longest_match ctts.c:1357-1387;
find_best_match_with_lookahead ctts.c:1406-1554 (algorithm documented in
architecture.txt:394-434).

The selection consumes the fully-normalized byte string. Candidate scoring
mixes the PT syllable score with a coverage term; note the reference adds
*character* count of the current match to the *byte* length of the next
match (ctts.c:1511) — replicated as observable behavior.

Frozen copy of ctts_tpu_torch/plan/select.py for the benchmark's reference
(benchmark/reference/): only the imports differ, so that a later
change to the port cannot move what the benchmark compares with.
"""

from __future__ import annotations

from dataclasses import dataclass

from benchmark.reference.units import UnitTable as VoiceDatabase
from benchmark.reference.phonology import pt_reject_single_consonant, pt_syllable_score
from benchmark.reference.textutil import utf8_char_len

MAX_CANDIDATES = 64


def _char_prefix_end(text: bytes, pos: int, max_chars: int) -> int:
    """Byte offset after walking up to max_chars characters from pos."""
    end = pos
    n = len(text)
    c = 0
    while c < max_chars and end < n and text[end] != 0:
        end += utf8_char_len(text, end)
        c += 1
    return end


def _step_back_one_char(text: bytes, pos: int, end: int) -> int:
    """Move `end` back one UTF-8 character (ctts.c:1376-1383)."""
    prev_end = pos
    scan = pos
    while scan < end:
        prev_end = scan
        scan += utf8_char_len(text, scan)
        if scan >= end:
            break
    return prev_end


def find_longest_match(db: VoiceDatabase, text: bytes, pos: int,
                       max_chars: int) -> int:
    """Longest unit match at pos, in *bytes*; 0 if none (ctts.c:1357-1387).

    Quirk kept: the initial try length caps character count by the
    remaining *byte* count (ctts.c:1359-1360).
    """
    remaining = len(text) - pos
    try_chars = min(max_chars, remaining)
    end = _char_prefix_end(text, pos, try_chars)
    while end > pos:
        if db.find_unit(text[pos:end]) >= 0:
            return end - pos
        end = _step_back_one_char(text, pos, end)
    return 0


@dataclass
class _Candidate:
    byte_len: int
    char_count: int
    unit_idx: int
    next_match_len: int
    pt_score: int


def find_best_match_with_lookahead(
    db: VoiceDatabase, text: bytes, pos: int, max_chars: int,
    at_word_start: bool
) -> tuple[int, int]:
    """Returns (byte_len, unit_idx); (0, -1) when nothing matches
    (ctts.c:1406-1554)."""
    n = len(text)
    if pos >= n:
        return 0, -1

    remaining_chars = 0
    tmp = pos
    while tmp < n:
        remaining_chars += 1
        tmp += utf8_char_len(text, tmp)

    try_chars = min(max_chars, remaining_chars)

    candidates: list[_Candidate] = []
    end = _char_prefix_end(text, pos, try_chars)
    char_count = try_chars
    while end > pos and len(candidates) < MAX_CANDIDATES:
        chunk = text[pos:end]
        unit_idx = db.find_unit(chunk)
        if unit_idx >= 0 and not pt_reject_single_consonant(
            text, pos, char_count, at_word_start
        ):
            candidates.append(
                _Candidate(
                    byte_len=end - pos,
                    char_count=char_count,
                    unit_idx=unit_idx,
                    next_match_len=0,
                    pt_score=pt_syllable_score(chunk, char_count, at_word_start),
                )
            )
        end = _step_back_one_char(text, pos, end)
        char_count -= 1

    if not candidates:
        return 0, -1
    if len(candidates) == 1:
        return candidates[0].byte_len, candidates[0].unit_idx

    # Look-ahead: longest match at the next position (whitespace skipped;
    # ctts.c:1486-1495).
    for cand in candidates:
        next_pos = pos + cand.byte_len
        while next_pos < n and text[next_pos] in (0x20, 0x09, 0x0A):
            next_pos += 1
        if next_pos < n:
            cand.next_match_len = find_longest_match(db, text, next_pos, max_chars)

    # Selection: pt_score, then coverage (chars + next bytes), then
    # end-of-word tie-breaks (ctts.c:1509-1550).
    best = 0
    best_pt = candidates[0].pt_score
    best_total = candidates[0].char_count + candidates[0].next_match_len
    for i in range(1, len(candidates)):
        c = candidates[i]
        total = c.char_count + c.next_match_len
        if c.pt_score > best_pt:
            best, best_pt, best_total = i, c.pt_score, total
        elif c.pt_score == best_pt:
            if total > best_total:
                best, best_total = i, total
            elif total == best_total:
                b = candidates[best]
                best_at_end = b.next_match_len == 0
                curr_at_end = c.next_match_len == 0
                if best_at_end and not curr_at_end:
                    pass
                elif not best_at_end and curr_at_end:
                    best = i
                elif best_at_end and curr_at_end:
                    if c.char_count > b.char_count:
                        best = i
                else:
                    if c.next_match_len > b.next_match_len:
                        best = i

    return candidates[best].byte_len, candidates[best].unit_idx
