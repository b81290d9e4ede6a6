"""int16 quantization semantics (ctts_tpu/ops/quant.py).

Values stay float32 on the reference's integer lattice: clamp to
[-32768, 32767] then truncate toward zero at every stage boundary.
"""

from __future__ import annotations

import torch

I16_MIN = -32768.0
I16_MAX = 32767.0


def q16(x: torch.Tensor) -> torch.Tensor:
    """Clamp + truncate toward zero; stays float32 but integer-valued."""
    return torch.trunc(torch.clamp(x, I16_MIN, I16_MAX))


def trunc16(x: torch.Tensor) -> torch.Tensor:
    """Truncate toward zero without clamping (for in-range casts)."""
    return torch.trunc(x)


def wrap16(x: torch.Tensor) -> torch.Tensor:
    """Two's-complement int16 wraparound of integer-valued floats
    (gcc's int16_t overflow in OLA accumulators). torch.remainder takes
    the divisor's sign, like jnp.mod."""
    return torch.remainder(x + 32768.0, 65536.0) - 32768.0
