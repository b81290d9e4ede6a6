"""Brazilian-Portuguese number expansion with exact parity to the C
reference (ctts.c:523-681).

Digit runs are parsed into a 64-bit signed accumulator with C overflow
semantics (wraparound) and rendered with the reference's conjunction rules
("e" between hundreds/tens/units, "mil" without "um", cem/cento split,
bilhão/milhão singular forms).

Frozen copy of ctts_tpu_torch/text/numbers.py for the benchmark's reference
(benchmark/reference/): only the imports differ, so that a later
change to the port cannot move what the benchmark compares with.
"""

from __future__ import annotations

_UNITS_PT = [
    "", "um", "dois", "três", "quatro", "cinco",
    "seis", "sete", "oito", "nove", "dez",
    "onze", "doze", "treze", "quatorze", "quinze",
    "dezesseis", "dezessete", "dezoito", "dezenove",
]

_TENS_PT = [
    "", "", "vinte", "trinta", "quarenta", "cinquenta",
    "sessenta", "setenta", "oitenta", "noventa",
]

_HUNDREDS_PT = [
    "", "cento", "duzentos", "trezentos", "quatrocentos", "quinhentos",
    "seiscentos", "setecentos", "oitocentos", "novecentos",
]

_I64_MASK = (1 << 64) - 1


def _wrap_i64(n: int) -> int:
    """Two's-complement 64-bit wraparound (C `long` on LP64)."""
    n &= _I64_MASK
    return n - (1 << 64) if n >= (1 << 63) else n


def number_to_words_pt(n: int) -> str:
    """0-999 to words (ctts.c:541-575)."""
    if n == 0:
        return "zero"
    if n == 100:
        return "cem"

    h = n // 100
    t = (n % 100) // 10
    u = n % 10

    parts = []
    if h > 0:
        parts.append(_HUNDREDS_PT[h])
    if n % 100 > 0:
        if h > 0:
            parts.append(" e ")
        if n % 100 < 20:
            parts.append(_UNITS_PT[n % 100])
        else:
            parts.append(_TENS_PT[t])
            if u > 0:
                parts.append(" e ")
                parts.append(_UNITS_PT[u])
    return "".join(parts)


def full_number_to_words_pt(n: int) -> str:
    """Full number to words (ctts.c:578-639).

    Note the reference divides with C int truncation; for n < 0 it prefixes
    "menos" and negates. Billions/millions use `int` cast of the quotient,
    replicated here with 32-bit wrap for pathological magnitudes.
    """
    if n == 0:
        return "zero"

    out = []
    if n < 0:
        out.append("menos ")
        n = -n

    def _i32(v: int) -> int:
        v &= 0xFFFFFFFF
        return v - (1 << 32) if v >= (1 << 31) else v

    if n >= 1_000_000_000:
        billions = _i32(n // 1_000_000_000)
        out.append(number_to_words_pt(billions) if 0 <= billions <= 999 else "")
        out.append(" bilhão" if billions == 1 else " bilhões")
        n %= 1_000_000_000
        if n > 0:
            out.append(" e ")

    if n >= 1_000_000:
        millions = n // 1_000_000
        out.append(number_to_words_pt(millions))
        out.append(" milhão" if millions == 1 else " milhões")
        n %= 1_000_000
        if n > 0:
            out.append(" e ")

    if n >= 1000:
        thousands = n // 1000
        if thousands == 1:
            out.append("mil")
        else:
            out.append(number_to_words_pt(thousands))
            out.append(" mil")
        n %= 1000
        if n > 0:
            out.append(" e " if n < 100 else " ")

    if n > 0:
        out.append(number_to_words_pt(n))

    return "".join(out)


def expand_numbers(text: bytes) -> bytes:
    """Replace each ASCII digit run with its Portuguese words
    (ctts.c:642-681). Operates on bytes; everything else is copied through.
    """
    out = bytearray()
    i = 0
    n = len(text)
    while i < n:
        b = text[i]
        if 0x30 <= b <= 0x39:  # '0'..'9'
            num = 0
            while i < n and 0x30 <= text[i] <= 0x39:
                num = _wrap_i64(num * 10 + (text[i] - 0x30))
                i += 1
            out += full_number_to_words_pt(num).encode("utf-8")
        else:
            out.append(b)
            i += 1
    return bytes(out)
