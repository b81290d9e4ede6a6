"""The benchmark's reference: plain NumPy text -> plan -> samples.

Frozen copies of the port's host chain (text normalisation and number
expansion, unit selection, the plan compiler, the NumPy DSP and the
oracle executor with the C reference's int16/float32 semantics) over a
voice held in memory (units.py). It imports nothing of the port and
takes nothing the port made: the configuration's keys, the recordings
and the text are all it reads.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference.compiler import compile_plan
from benchmark.reference.config import CTTSConfig
from benchmark.reference.oracle import execute_plan_oracle
from benchmark.reference.units import UnitTable


class Reference:
    """One configuration's reference synthesizer."""

    def __init__(self, config_keys: dict, recordings):
        self.config = CTTSConfig(**config_keys)
        self.table = UnitTable(recordings)

    def synthesize(self, text: str, speed: float) -> np.ndarray:
        """int16 samples of `text` spoken at `speed`, no normalisation
        rules (the configuration's)."""
        plan = compile_plan(self.table, text, self.config, speed)
        return execute_plan_oracle(plan, self.table)
