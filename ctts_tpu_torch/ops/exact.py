"""Decision-bearing square root (ctts_tpu/ops/exact.py sqrt_rn).

The JAX package needs div_rn/sqrt_rn because XLA:TPU's f32 divide and
sqrt are ~1 ULP off round-to-nearest. PyTorch's f32 `/` is IEEE
correctly rounded on the CPU and on CUDA (PyTorch is not built with
fast-math), so the port divides with a plain `/` of two tensors (a
Python-scalar numerator is a reciprocal and a multiply: two
roundings). PyTorch's f32 sqrt is correctly rounded on CUDA but not on
the CPU, where the vectorized kernel misses on ~0.6% of values;
sqrt_rn takes the root in f64 and rounds once to f32, which is
correctly rounded on every device (f64 carries more than 2*24+2 bits,
so the double rounding is innocuous for sqrt). The hi/lo split helpers
(split_hi_lo, combine_exact, two_sum) are not ported: exact int64 sums
replace them.
"""

from __future__ import annotations

import torch


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 sqrt."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)
