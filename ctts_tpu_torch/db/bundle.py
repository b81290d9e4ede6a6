"""Device voice bundle: the device-side counterpart of the compiled
voice.db.

Counterpart of ctts_tpu/db/bundle.py. The padded unit tensor, the unit
lengths and the host-computed RMS gains are kept as a versioned .npz, so
that bring-up skips the pad and gain pass (a per-unit f64 RMS over the
whole pool). `save_voice_bundle` is the JAX package's code and writes
the same file layout, so that either package reads the other's bundles;
`VoiceBundle` loads one into torch tensors on a device and stands where
a DeviceVoice does (SynthesisCore, execute_plan_torch).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ctts_tpu_torch.constants import MAGIC, SAMPLE_RATE, VERSION
from ctts_tpu_torch.db.reader import VoiceDatabase
from ctts_tpu_torch.synth.device import DeviceVoice

BUNDLE_VERSION = 1


def save_voice_bundle(db: VoiceDatabase, path: str,
                      target_rms: float = 3000.0) -> None:
    units, lengths = db.to_device_arrays()
    n = units.shape[0]
    gains = np.ones(n, np.float32)
    for i in range(n):
        s = db.unit_samples(i).astype(np.float64)
        if s.shape[0] == 0:
            continue
        rms = np.float32(np.sqrt(np.sum(s * s) / s.shape[0]))
        if rms < np.float32(1.0):
            continue
        g = np.float32(target_rms) / rms
        gains[i] = min(max(g, np.float32(0.1)), np.float32(3.0))

    texts = np.array([db.unit_text(i) for i in range(n)], dtype=object)
    np.savez_compressed(
        path,
        bundle_version=BUNDLE_VERSION,
        magic=MAGIC,
        db_version=VERSION,
        sample_rate=SAMPLE_RATE,
        target_rms=np.float32(target_rms),
        units=units,
        lengths=lengths,
        gains=gains,
        texts=texts,
        max_unit_chars=db.max_unit_chars,
    )


class VoiceBundle(DeviceVoice):
    """A loaded bundle: the DeviceVoice attributes (`device`, `bank`,
    `lengths`, `gains`, `lengths_np`, `ubuf`) on an explicit device
    (default: the CUDA card; raises without one), plus the bundle's
    metadata. A bundle of another version or database format raises."""

    def __init__(self, path: str, device: Optional[torch.device] = None):
        z = np.load(path, allow_pickle=True)
        if int(z["bundle_version"]) != BUNDLE_VERSION:
            raise ValueError(f"{path}: bundle version mismatch "
                             f"{int(z['bundle_version'])} != {BUNDLE_VERSION}")
        if int(z["magic"]) != MAGIC or int(z["db_version"]) != VERSION:
            raise ValueError(f"{path}: database format mismatch")
        self.sample_rate = int(z["sample_rate"])
        self.target_rms = float(z["target_rms"])
        self.max_unit_chars = int(z["max_unit_chars"])
        self.texts = [bytes(t) for t in z["texts"]]
        self._set(z["units"].astype(np.float32),
                  z["lengths"].astype(np.int32),
                  z["gains"].astype(np.float32), device)
