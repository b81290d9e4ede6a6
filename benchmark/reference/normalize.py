"""Full text-normalization pipeline, in the reference's exact order
(ctts.c:3642-3655):

    raw text → expand_numbers → (CSV regex rules) → selective lowercase

No benchmark configuration has a rule file, so the rules step is not
copied (the port's text/rules.py); a configuration with rules would
bring a frozen copy of that file.

Prosody analysis reads the *raw* text separately (ctts.c:3640); see
ctts_tpu_torch.text.prosody.

Frozen copy of ctts_tpu_torch/text/normalize.py for the benchmark's reference
(benchmark/reference/): only the imports differ and the rules are left
out, so that a later change to the port cannot move what the benchmark
compares with.
"""

from __future__ import annotations

from benchmark.reference.numbers import expand_numbers
from benchmark.reference.textutil import normalize_lowercase


def normalize_pipeline(text: bytes) -> bytes:
    """Numbers → lowercase, with no rule file."""
    return normalize_lowercase(expand_numbers(text))
