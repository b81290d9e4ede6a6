"""The reference's voice: the unit recordings held in memory, looked up
as the voice database looks them up.

What compile_plan and execute_plan_oracle read of a voice
(find_unit, unit_text, unit_samples, max_unit_chars), built from the
recordings themselves rather than from a voice.db: texts lowercased as
the builder lowercases them (ctts_tpu_torch/db/builder.py:40-70),
units ordered by character count, descending, then by their bytes
(builder.py:73-76), and the first unit of a text found, as the
reader's lookup finds it (ctts_tpu_torch/db/reader.py:55-62).
"""

from __future__ import annotations

import numpy as np

from benchmark.reference.textutil import normalize_lowercase, utf8_strlen


class UnitTable:
    def __init__(self, recordings):
        """recordings: (index text, int16 samples) pairs."""
        units = []
        for text, samples in recordings:
            norm = normalize_lowercase(text.encode("utf-8"))
            units.append((utf8_strlen(norm), norm,
                          np.asarray(samples, dtype=np.int16)))
        units.sort(key=lambda u: (-u[0], u[1]))
        self._texts = [u[1] for u in units]
        self._samples = [u[2] for u in units]
        self.max_unit_chars = max((u[0] for u in units), default=0)
        self._lookup: dict[bytes, int] = {}
        for i, text in enumerate(self._texts):
            self._lookup.setdefault(text, i)

    def find_unit(self, text: bytes) -> int:
        return self._lookup.get(text, -1)

    def unit_text(self, idx: int) -> bytes:
        return self._texts[idx]

    def unit_samples(self, idx: int) -> np.ndarray:
        return self._samples[idx]
