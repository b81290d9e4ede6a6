"""CSV-driven regex pronunciation-rule engine, parity with the C reference.

The reference loads up to 256 `pattern,replacement` rules from
`normalization.csv`, converts portable `\\b` into POSIX `[[:<:]]`/`[[:>:]]`
word boundaries by context, compiles with POSIX ERE, and applies each rule
sequentially as a whole-string rewrite with `\\1..\\9` backreference support
(ctts.c:294-505).

This port compiles the converted patterns with Python `re` over *bytes*
(so `\\w`-style classes are ASCII-only, matching the C locale). POSIX
word-boundary brackets are emulated with lookaround. Known divergence:
POSIX regexec is leftmost-longest while Python is leftmost-first; the two
agree for every alternation-free pattern (all shipped rules) — documented
here for users who supply exotic rules.

PLATFORM FLAVORS. `[[:<:]]`/`[[:>:]]` are BSD extensions: on macOS the
converted patterns compile, but on Linux glibc regcomp REJECTS them, so
the reference binary silently drops every rule containing `\\b` (43 of the
50 shipped rules!) and keeps only the boundary-free seven. Because the
parity baseline on this machine is the glibc behavior, the loader takes a
`flavor` argument:

- "glibc" (default): reject `\\b` rules with the same warning — matches
  the C binary compiled on this (Linux) host, the benchmark target.
- "full": compile word boundaries properly — matches the reference's
  documented intent (and its macOS-built demo goldens).

Copy of ctts_tpu/text/rules.py for the PyTorch port: only the package
name in its imports and module references differs, and the C
reference is cited by its relative path.
"""

from __future__ import annotations

import re
import sys

MAX_NORM_RULES = 256
MAX_REPLACE_LEN = 256

# POSIX word characters in the C locale.
_W = b"0-9A-Za-z_"
_WORD_START = b"(?<![" + _W + b"])(?=[" + _W + b"])"
_WORD_END = b"(?<=[" + _W + b"])(?![" + _W + b"])"

# POSIX character classes → Python equivalents (ASCII, C locale).
_POSIX_CLASSES = {
    b"[:alpha:]": b"A-Za-z",
    b"[:digit:]": b"0-9",
    b"[:alnum:]": b"0-9A-Za-z",
    b"[:space:]": b" \\t\\n\\r\\f\\v",
    b"[:upper:]": b"A-Z",
    b"[:lower:]": b"a-z",
    b"[:punct:]": b"!-/:-@\\[-`{-~",
}


def convert_word_boundaries(pattern: bytes) -> bytes:
    """Portable `\\b` → `[[:<:]]` / `[[:>:]]` by following-char context
    (ctts.c:294-340): word-start iff the next char is alphanumeric, '[',
    or '('; word-end otherwise."""
    if b"\\b" not in pattern:
        return pattern
    out = bytearray()
    i = 0
    n = len(pattern)
    while i < n:
        if pattern[i] == 0x5C and i + 1 < n and pattern[i + 1] == ord("b"):
            nxt = pattern[i + 2] if i + 2 < n else 0
            if (
                (ord("a") <= nxt <= ord("z"))
                or (ord("A") <= nxt <= ord("Z"))
                or (ord("0") <= nxt <= ord("9"))
                or nxt in (ord("["), ord("("))
            ):
                out += b"[[:<:]]"
            else:
                out += b"[[:>:]]"
            i += 2
        else:
            out.append(pattern[i])
            i += 1
    return bytes(out)


def _posix_to_python(pattern: bytes) -> bytes:
    """Translate the POSIX-only constructs we emit/support to Python re."""
    pattern = pattern.replace(b"[[:<:]]", _WORD_START)
    pattern = pattern.replace(b"[[:>:]]", _WORD_END)
    for posix, py in _POSIX_CLASSES.items():
        pattern = pattern.replace(posix, py)
    return pattern


class NormRule:
    __slots__ = ("regex", "replace", "posix")

    def __init__(self, regex: "re.Pattern[bytes]", replace: bytes,
                 posix: bytes | None = None):
        self.regex = regex
        self.replace = replace
        # The word-boundary-converted POSIX form of the pattern (before
        # the Python-re translation) — what the native batch lowering
        # hands to regcomp (plan/native_lower.py ctl_set_rules).
        self.posix = posix


class NormalizationRules:
    """Loaded rule set; apply() mirrors ctts_apply_normalization
    (ctts.c:439-505)."""

    def __init__(self, rules: list[NormRule] | None = None):
        self.rules = rules or []

    @classmethod
    def load(cls, csv_file: str, verbose: bool = True,
             flavor: str = "glibc") -> "NormalizationRules":
        """Load rules from CSV (ctts.c:343-408). A missing file yields an
        empty rule set; invalid regexes are warned about and skipped.
        See the module docstring for `flavor`."""
        if flavor not in ("glibc", "full"):
            raise ValueError(f"unknown regex flavor: {flavor!r}")
        rules: list[NormRule] = []
        try:
            f = open(csv_file, "rb")
        except OSError:
            return cls(rules)
        with f:
            for raw in f:
                if len(rules) >= MAX_NORM_RULES:
                    break
                line = raw.rstrip(b"\r\n")
                if not line or line[0:1] == b"#":
                    continue
                comma = line.find(b",")
                if comma < 0:
                    continue
                pattern = line[:comma]
                replace = line[comma + 1 :][: MAX_REPLACE_LEN - 1]
                bounded = convert_word_boundaries(pattern)
                if flavor == "glibc" and (
                    b"[[:<:]]" in bounded or b"[[:>:]]" in bounded
                ):
                    # glibc regcomp rejects the BSD word-boundary brackets;
                    # the reference warns and drops the rule (ctts.c:385-391).
                    if verbose:
                        print(
                            f"Warning: Invalid regex pattern "
                            f"'{bounded.decode('utf-8', 'replace')}' "
                            f"(converted from "
                            f"'{pattern.decode('utf-8', 'replace')}')",
                            file=sys.stderr,
                        )
                    continue
                converted = _posix_to_python(bounded)
                try:
                    regex = re.compile(converted)
                except re.error:
                    print(
                        f"Warning: Invalid regex pattern "
                        f"'{converted.decode('utf-8', 'replace')}' (converted "
                        f"from '{pattern.decode('utf-8', 'replace')}')",
                        file=sys.stderr,
                    )
                    continue
                rules.append(NormRule(regex, replace, bounded))
        if rules and verbose:
            print(f"Loaded {len(rules)} normalization rules", file=sys.stderr)
        return cls(rules)

    def apply(self, text: bytes) -> bytes:
        """Sequential whole-string rewrite per rule, with the reference's
        backreference semantics, zero-length-match byte skip, and output
        cap (ctts.c:439-505)."""
        if not self.rules:
            return text

        buf_size = len(text) * 4 + 1024
        current = text
        for rule in self.rules:
            out = bytearray()
            remaining = buf_size - 1
            src = current
            while src and remaining > 0:
                m = rule.regex.search(src)
                if m is None:
                    rest = src[: min(len(src), remaining)]
                    out += rest
                    break
                before = src[: min(m.start(), remaining)]
                out += before
                remaining -= len(before)

                rep = _apply_replacement(rule.replace, src, m, remaining)
                out += rep
                remaining -= len(rep)

                end = m.end()
                src = src[end:]
                if end == 0:
                    # Zero-length match: the reference advances one byte
                    # without copying it (ctts.c:485).
                    src = src[1:]
            current = bytes(out)
        return current


def _apply_replacement(
    replace: bytes, src: bytes, m: "re.Match[bytes]", remaining: int
) -> bytes:
    """Replacement writer with `\\0..\\9` backrefs (ctts.c:411-436).
    Unmatched groups expand to nothing; other backslash pairs are copied
    verbatim; output is truncated to `remaining` bytes."""
    out = bytearray()
    i = 0
    n = len(replace)
    ngroups = m.re.groups
    while i < n and len(out) < remaining:
        c = replace[i]
        if c == 0x5C and i + 1 < n and 0x30 <= replace[i + 1] <= 0x39:
            group = replace[i + 1] - 0x30
            if group <= ngroups:
                try:
                    span = m.span(group)
                except IndexError:
                    span = (-1, -1)
                if span[0] >= 0:
                    piece = src[span[0] : span[1]]
                    out += piece[: remaining - len(out)]
            i += 2
        else:
            out.append(c)
            i += 1
    return bytes(out[:remaining])
