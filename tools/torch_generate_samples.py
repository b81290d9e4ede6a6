#!/usr/bin/env python
"""Generate the 120-sample acceptance corpus and its demo page with the
PyTorch/CUDA port (ctts_tpu_torch).

The counterpart of tools/generate_samples.py (SURVEY.md §2, component
32: the reference's generate_samples.sh and docs/index.html): the same
corpus, sections, file names and page, written by the port's own code.
config.yaml and normalization.csv are read from the working directory,
as the port's CLI reads them.

Usage:
    python tools/torch_generate_samples.py <voice.db> [output_dir]
        [--executor=torch|native|oracle] [--device=cuda|cpu]
        [--rule-flavor=glibc|full]

--executor=torch (the default) synthesizes on the device through
CTTSEngine, one synthesize_batch per speed of the corpus; the device is
the CUDA card (an error when there is none) unless --device=cpu.
native runs the port's C++ host engine (runtime.NativeEngine, built by
make at first use), oracle the NumPy oracle. An executor that fails
raises and the tool exits nonzero: nothing falls back to another
executor.
"""

from __future__ import annotations

import html
import os
import sys
import time
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from ctts_tpu_torch.config import load_config  # noqa: E402
from ctts_tpu_torch.constants import (  # noqa: E402
    MAX_SPEED,
    MIN_SPEED,
    SAMPLE_RATE,
)
from ctts_tpu_torch.db.reader import VoiceDatabase  # noqa: E402
from ctts_tpu_torch.plan.compiler import compile_plan  # noqa: E402
from ctts_tpu_torch.testing.corpus import CORPUS  # noqa: E402
from ctts_tpu_torch.text.rules import NormalizationRules  # noqa: E402
from ctts_tpu_torch.utils.wav import write_wav  # noqa: E402

EXECUTORS = ("torch", "native", "oracle")
DEVICES = ("cuda", "cpu")

PAGE_HEADER = """<!DOCTYPE html>
<html lang="pt-BR">
<head>
<meta charset="utf-8">
<title>ctts_tpu_torch (PyTorch/CUDA) — Amostras de síntese</title>
<style>
 body { font-family: system-ui, sans-serif; max-width: 900px; margin: 2rem auto; }
 h1 { font-size: 1.4rem; } h2 { font-size: 1.1rem; margin-top: 2rem; }
 .sample { display: flex; align-items: center; gap: 1rem; padding: .3rem 0; }
 .sample span { flex: 1; }
 audio { height: 2rem; }
</style>
</head>
<body>
<h1>ctts_tpu_torch (PyTorch/CUDA) — 120 amostras de aceitação</h1>
<p>Corpus de regressão (14 seções) sintetizado pelo porte PyTorch/CUDA.</p>
"""

SECTIONS = [
    (1, "Perguntas (entonação ascendente)"),
    (11, "Exclamações"),
    (21, "Pausas de vírgula"),
    (31, "Pausas de ponto final"),
    (36, "Pontuação mista"),
    (41, "Expansão de números"),
    (51, "Abreviações"),
    (61, "Hiatos"),
    (71, "R inicial"),
    (81, "S entre vogais"),
    (91, "T final"),
    (93, "Declinação"),
    (97, "Variações de velocidade (WSOLA)"),
    (116, "Diálogos"),
]


def corpus_speed(speed: float) -> float:
    """A corpus speed as the CLI takes it: f32, clamped to the range."""
    return min(max(float(np.float32(speed)), MIN_SPEED), MAX_SPEED)


def synthesize_torch(db_path, config, rules, device: str) -> list:
    """The corpus through CTTSEngine on `device`, one synthesize_batch
    per speed; outputs in corpus order."""
    import torch

    from ctts_tpu_torch.env import device as cuda_device
    from ctts_tpu_torch.models.engine import CTTSEngine

    dev = cuda_device() if device == "cuda" else torch.device("cpu")
    groups = defaultdict(list)
    for i, (_, text, speed) in enumerate(CORPUS):
        groups[corpus_speed(speed)].append(i)
    eng = CTTSEngine(db_path, config=config, rules=rules, device=dev)
    outs = [None] * len(CORPUS)
    try:
        for speed, idxs in groups.items():
            got = eng.synthesize_batch([CORPUS[i][1] for i in idxs], speed)
            for i, samples in zip(idxs, got):
                outs[i] = samples
    finally:
        eng.close()
    return outs


def synthesize_plans(executor: str, db, db_path, config, rules) -> list:
    """The corpus one plan at a time through the native engine or the
    oracle; outputs in corpus order."""
    plans = [compile_plan(db, text, config, rules, corpus_speed(speed))
             for _, text, speed in CORPUS]
    if executor == "oracle":
        from ctts_tpu_torch.synth.oracle import execute_plan_oracle

        return [execute_plan_oracle(p, db) for p in plans]
    from ctts_tpu_torch.runtime.native import NativeEngine

    engine = NativeEngine(db_path)
    try:
        return [engine.execute(p) for p in plans]
    finally:
        engine.close()


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv if argv is None else argv)
    flags = {k: v for k, _, v in
             (a.partition("=") for a in argv[1:] if a.startswith("--"))}
    args = [a for a in argv[1:] if not a.startswith("--")]
    executor = flags.get("--executor", "torch")
    device = flags.get("--device", "cuda")
    if not args or executor not in EXECUTORS or device not in DEVICES:
        print(__doc__, file=sys.stderr)
        return 1
    db_path = args[0]
    out_dir = args[1] if len(args) > 1 else "samples"

    db = VoiceDatabase(db_path)
    config = load_config("config.yaml")
    rules = NormalizationRules.load("normalization.csv", verbose=False,
                                    flavor=flags.get("--rule-flavor",
                                                     "glibc"))
    if executor != "oracle":
        from ctts_tpu_torch.synth.plan_arrays import check_config

        check_config(config)

    t0 = time.perf_counter()
    if executor == "torch":
        outs = synthesize_torch(db_path, config, rules, device)
    else:
        outs = synthesize_plans(executor, db, db_path, config, rules)
    seconds = time.perf_counter() - t0

    os.makedirs(os.path.join(out_dir, "audio"), exist_ok=True)
    sections = dict(SECTIONS)
    page = [PAGE_HEADER]
    for i, ((fname, text, speed), samples) in enumerate(zip(CORPUS, outs),
                                                        start=1):
        if i in sections:
            page.append(f"<h2>{html.escape(sections[i])}</h2>")
        write_wav(os.path.join(out_dir, "audio", fname), samples, SAMPLE_RATE)
        label = html.escape(text)
        spd = f" ({speed}x)" if speed != 1.0 else ""
        page.append(
            f'<div class="sample"><span>[{i:03d}] {label}{spd}</span>'
            f'<audio controls src="audio/{fname}"></audio></div>'
        )
        print(f"[{i:03d}] {text}")

    page.append("</body></html>\n")
    with open(os.path.join(out_dir, "index.html"), "w", encoding="utf-8") as f:
        f.write("\n".join(page))
    where = f" on {device}" if executor == "torch" else ""
    print(f"\nGenerated {len(CORPUS)} samples in {out_dir}/ "
          f"(executor {executor}{where}, {seconds:.2f} s of synthesis)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
