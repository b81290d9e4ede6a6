"""A dry run of the row split over a list of devices.

Counterpart of the JAX package's `dryrun_multichip` (__graft_entry__.py:
80-170): one synthesize over a mesh of the given devices, then the
serving loop (`stream`) over two batches whose row counts the mesh does
not divide, each held to the synthesize outputs for order and bits.
Where JAX makes virtual CPU devices, here the list may repeat a device
(`[cpu] * 4`, `[cuda:0, cuda:0]`).
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional, Sequence

import numpy as np

TEXTS = ["oi", "bom dia", "como vai", "tudo bem",
         "a rosa", "o rato", "sim", "claro"]
MORE = ["mais um", "fim agora", "ola de novo"]


def _ragged(rows: int, n: int) -> int:
    """`rows`, or one more where the mesh size n > 1 divides it."""
    return rows + 1 if n > 1 and rows % n == 0 else rows


def generated_voice_db(root: str) -> str:
    """Generate the deterministic voice dataset under `root` and build
    root/voice.db from it; returns its path."""
    from ctts_tpu_torch.db.builder import build_database
    from ctts_tpu_torch.db.dataset import generate_dataset

    ds = os.path.join(root, "dataset")
    generate_dataset(ds)
    path = os.path.join(root, "voice.db")
    build_database(os.path.join(ds, "letters", "wavs"),
                   os.path.join(ds, "letters", "letters.txt"),
                   os.path.join(ds, "syllables", "wavs"),
                   os.path.join(ds, "syllables", "sillabes.txt"),
                   path, verbose=False)
    return path


def dryrun_multigpu(devices: Sequence,
                    database_file: Optional[str] = None) -> dict:
    """Synthesize and stream over make_mesh(devices); raises on any
    fault, else returns what ran. Without `database_file` the generated
    voice is built into a temporary directory first."""
    if database_file is None:
        with tempfile.TemporaryDirectory(prefix="ctts_dryrun_") as root:
            return dryrun_multigpu(devices, generated_voice_db(root))

    from ctts_tpu_torch.config import config_defaults
    from ctts_tpu_torch.db.reader import VoiceDatabase
    from ctts_tpu_torch.parallel.batch import BatchSynthesizer
    from ctts_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(devices)
    n = mesh.size
    db = VoiceDatabase(database_file)
    try:
        bs = BatchSynthesizer(db, config_defaults(), mesh=mesh)
        # At least one row per device; the batch pads to the mesh.
        texts = (TEXTS * -(-n // len(TEXTS)))[:max(n, len(TEXTS))]
        outs = bs.synthesize(texts)
        if len(outs) != len(texts) or not all(
                o.dtype == np.int16 and o.size > 0 for o in outs):
            raise RuntimeError("dryrun_multigpu: synthesize returned an "
                               "empty or non-int16 output")
        pool = texts + MORE
        first = [pool[i % len(pool)]
                 for i in range(_ragged(len(texts) + len(MORE), n))]
        batches = [first, texts[:_ragged(max(n - 1, 1), n)]]
        streamed = list(bs.stream(iter(batches)))
        if [len(s) for s in streamed] != [len(b) for b in batches]:
            raise RuntimeError(f"dryrun_multigpu: stream yielded "
                               f"{[len(s) for s in streamed]} rows for "
                               f"{[len(b) for b in batches]}")
        for bi, souts in enumerate(streamed):
            want = outs[:min(len(souts), len(outs))]
            for j, (a, b) in enumerate(zip(souts, want)):
                if a.dtype != b.dtype or not np.array_equal(a, b):
                    raise RuntimeError(f"dryrun_multigpu: stream batch {bi}"
                                       f" row {j} differs from synthesize")
    finally:
        db.close()
    return {"devices": [str(d) for d in mesh.devices],
            "sentences": len(outs), "samples": int(sum(o.size for o in outs)),
            "stream_rows": [len(s) for s in streamed],
            "stream_samples": int(sum(o.size for s in streamed for o in s))}
