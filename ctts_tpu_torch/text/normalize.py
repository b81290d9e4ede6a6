"""Full text-normalization pipeline, in the reference's exact order
(ctts.c:3642-3655):

    raw text → expand_numbers → CSV regex rules → selective lowercase

Prosody analysis reads the *raw* text separately (ctts.c:3640); see
ctts_tpu_torch.text.prosody.

Copy of ctts_tpu/text/normalize.py for the PyTorch port: only the package
name in its imports and module references differs, and the C
reference is cited by its relative path.
"""

from __future__ import annotations

from ctts_tpu_torch.text.numbers import expand_numbers
from ctts_tpu_torch.text.rules import NormalizationRules
from ctts_tpu_torch.utils.textutil import normalize_lowercase


def normalize_pipeline(text: bytes, rules: NormalizationRules | None) -> bytes:
    """Numbers → rules → lowercase. `rules=None` means no rule file."""
    expanded = expand_numbers(text)
    if rules is not None:
        expanded = rules.apply(expanded)
    return normalize_lowercase(expanded)
