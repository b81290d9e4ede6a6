"""High-level engine API, mirroring the reference's library surface
(ctts_init / ctts_synthesize / ctts_free; ctts.h:196-247) with the
port's executors underneath.

Counterpart of ctts_tpu/models/engine.py. The device path is the CUDA
card (ctts_tpu_torch.env.device(), which raises when there is none)
unless the caller passes a device, as the tests pass
torch.device("cpu"), or a mesh (parallel/mesh.py), over which the batch
path splits its rows.

Both paths run the compiled core of synth/compiled.py: `synthesize`
one sentence as a batch of one row on the engine's voice (one core, so
a sentence whose signature comes back replays its CUDA graphs, as the
JAX engine reuses `_compiled_core`), `synthesize_batch` through
BatchSynthesizer. On a card a signature's first call runs eagerly and
its second is captured; on the CPU both run eagerly. `close` drops the
engine's graphs.
"""

from __future__ import annotations

import itertools
from typing import Optional, Sequence

import numpy as np
import torch

from ctts_tpu_torch.config import CTTSConfig, config_defaults, load_config
from ctts_tpu_torch.constants import MAX_SPEED, MIN_SPEED
from ctts_tpu_torch.db.reader import VoiceDatabase
from ctts_tpu_torch.parallel.mesh import first_device
from ctts_tpu_torch.plan.compiler import SynthesisPlan, compile_plan
from ctts_tpu_torch.text.rules import NormalizationRules
from ctts_tpu_torch.utils import timing

EXECUTORS = ("torch", "oracle")


class CTTSEngine:
    """Voice database + config + executors.

    `executor`: "torch" (SynthesisCore on the device, the Hopper
    kernels on a CUDA device) or "oracle" (host NumPy, exact C
    semantics). Batched synthesis always uses the device path.
    """

    def __init__(
        self,
        database_file: str,
        config: Optional[CTTSConfig] = None,
        rules: Optional[NormalizationRules] = None,
        executor: str = "torch",
        mesh=None,
        device: Optional[torch.device] = None,
    ):
        if executor not in EXECUTORS:
            raise ValueError(f"executor {executor!r}: not one of "
                             f"{EXECUTORS}")
        self.db = VoiceDatabase(database_file)
        self.config = config or config_defaults()
        self.rules = rules
        self.executor = executor
        self.mesh = mesh
        self.device = device
        # The single-sentence path runs on the mesh's first device.
        self._device = first_device(mesh, device)
        self._voice = None
        self._batcher = None
        self.units_found = 0
        self.units_missing = 0
        # Request ids of the `sentence` spans (utils/timing.py).
        self._calls = itertools.count()

    @classmethod
    def from_files(cls, database_file: str, config_file: str = "config.yaml",
                   rules_file: str = "normalization.csv",
                   rule_flavor: str = "glibc", **kw) -> "CTTSEngine":
        return cls(
            database_file,
            config=load_config(config_file),
            rules=NormalizationRules.load(rules_file, verbose=False,
                                          flavor=rule_flavor),
            **kw,
        )

    # -- single utterance -------------------------------------------------

    def compile(self, text: str, speed: float = 1.0) -> SynthesisPlan:
        speed = min(max(speed, MIN_SPEED), MAX_SPEED)
        with timing.span("sentence.compile"):
            plan = compile_plan(self.db, text, self.config, self.rules,
                                speed)
        self.units_found = plan.units_found
        self.units_missing = plan.units_missing
        return plan

    def synthesize(self, text: str, speed: float = 1.0) -> np.ndarray:
        """Text → int16 samples at 22050 Hz, recorded as the span
        `sentence` of the engine's next call number."""
        with timing.span("sentence", next(self._calls)):
            return self._synthesize(text, speed)

    def _synthesize(self, text: str, speed: float) -> np.ndarray:
        plan = self.compile(text, speed)
        if self.executor == "torch":
            from ctts_tpu_torch.synth.device import (
                DeviceVoice,
                execute_plan_torch,
            )

            if self._voice is None:
                self._voice = DeviceVoice(self.db, plan.target_rms,
                                          self._device)
            return execute_plan_torch(plan, self.db, self._voice)
        from ctts_tpu_torch.synth.oracle import execute_plan_oracle

        return execute_plan_oracle(plan, self.db)

    # -- batched ----------------------------------------------------------

    def synthesize_batch(self, texts: Sequence[str],
                         speed: float = 1.0) -> list[np.ndarray]:
        from ctts_tpu_torch.parallel.batch import BatchSynthesizer

        if self._batcher is None:
            self._batcher = BatchSynthesizer(
                self.db, self.config, self.rules, mesh=self.mesh,
                device=self.device
            )
        return self._batcher.synthesize(texts, speed)

    # -- config setters (API parity: ctts_set_*, ctts.c:1313-1330) --------

    def set_crossfade(self, crossfade_ms: float) -> None:
        self.config.crossfade_ms = crossfade_ms

    def set_word_pause(self, pause_ms: float) -> None:
        self.config.word_pause_ms = pause_ms

    def set_unknown_silence(self, silence_ms: float) -> None:
        self.config.unknown_silence_ms = silence_ms

    def set_fades(self, fade_in_ms: float, fade_out_ms: float) -> None:
        self.config.fade_in_ms = fade_in_ms
        self.config.fade_out_ms = fade_out_ms

    def close(self) -> None:
        """Close the voice database and drop the graphs of both paths."""
        from ctts_tpu_torch.synth.compiled import release_compiled

        if self._voice is not None:
            release_compiled(self._voice.core())
        if self._batcher is not None:
            for shard in self._batcher.shards:
                release_compiled(shard.core)
        self.db.close()
