"""Error codes and messages (parity: ctts.h:333-341, ctts.c:149-168).
Copy of ctts_tpu/utils/errors.py for the PyTorch port: only the package
name in its imports and module references differs, and the C
reference is cited by its relative path.
"""

from __future__ import annotations

OK = 0
ERR_INVALID_ARG = -1
ERR_FILE_NOT_FOUND = -2
ERR_FILE_READ = -3
ERR_FILE_WRITE = -4
ERR_INVALID_FORMAT = -5
ERR_OUT_OF_MEMORY = -6
ERR_INVALID_WAV = -7
ERR_VERSION = -8

_MESSAGES = [
    "Success",
    "Invalid argument",
    "File not found",
    "File read error",
    "File write error",
    "Invalid format",
    "Out of memory",
    "Invalid WAV file",
    "Version mismatch",
]


def strerror(error_code: int) -> str:
    """ctts_strerror (ctts.c:161-168)."""
    if error_code >= 0:
        return _MESSAGES[0]
    idx = -error_code
    if idx >= len(_MESSAGES):
        return "Unknown error"
    return _MESSAGES[idx]


class CTTSError(Exception):
    """Exception carrying a reference-compatible error code."""

    def __init__(self, code: int, detail: str = ""):
        self.code = code
        super().__init__(
            f"{strerror(code)}" + (f": {detail}" if detail else "")
        )
