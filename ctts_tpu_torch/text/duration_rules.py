"""Duration-rule CSV loader (parity component 30, ctts.c:2279-2343).

The reference parses `duration_rules.csv` on every synthesis and prints a
load message, but the factors are never applied anywhere in the live
pipeline (`get_duration_factor` has no callers — SURVEY.md §2 dead code).
We reproduce the loader (and its observable stderr message) and expose
`get_duration_factor` for API completeness, intentionally leaving it
unused by synthesis, exactly like the reference.

Copy of ctts_tpu/text/duration_rules.py for the PyTorch port: only the package
name in its imports and module references differs, and the C
reference is cited by its relative path.
"""

from __future__ import annotations

import dataclasses
import re
import sys

MAX_DURATION_RULES = 128

_LINE_RE = re.compile(rb"^([^,]{1,31}),\s*(-?\d+)\s*,\s*(-?\d+)\s*,\s*([-+0-9.eE]+)")


@dataclasses.dataclass
class DurationRule:
    phoneme_type: bytes
    position: int  # 0=initial, 1=medial, 2=final
    stress: int    # 0=unstressed, 1=stressed
    duration_factor: float


class DurationRules:
    def __init__(self, rules: list[DurationRule]):
        self.rules = rules

    @classmethod
    def load(cls, csv_file: str, verbose: bool = True) -> "DurationRules":
        rules: list[DurationRule] = []
        try:
            f = open(csv_file, "rb")
        except OSError:
            return cls(rules)
        with f:
            for raw in f:
                if len(rules) >= MAX_DURATION_RULES:
                    break
                if raw[:1] in (b"#", b"\n", b"\r"):
                    continue
                m = _LINE_RE.match(raw)
                if not m:
                    continue
                try:
                    rules.append(
                        DurationRule(
                            phoneme_type=m.group(1),
                            position=int(m.group(2)),
                            stress=int(m.group(3)),
                            duration_factor=float(m.group(4)),
                        )
                    )
                except ValueError:
                    continue
        if rules and verbose:
            print(f"Loaded {len(rules)} duration rules", file=sys.stderr)
        return cls(rules)

    def get_duration_factor(self, phoneme_type: bytes, position: int,
                            stress: int) -> float:
        """First matching rule's factor, else 1.0 (ctts.c:2334-2343).
        NOTE: never called by synthesis — parity with the reference's dead
        code path."""
        for r in self.rules:
            if (r.phoneme_type == phoneme_type and r.position == position
                    and r.stress == stress):
                return r.duration_factor
        return 1.0
