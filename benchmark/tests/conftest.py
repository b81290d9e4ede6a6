"""The benchmark's own tests: python -m pytest benchmark/tests -q

They run on the CPU (the port's plain versions, a tiny corpus, windows
of a second); tests marked `cuda` run a cell on the card and skip
without one. The checkout's root is put on sys.path so that
`benchmark` and the port import as they do under benchmark/run.py."""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY_TEXTS = ["como vai?", "que legal!", "sim, eu entendo", "o rio é grande",
              "parabéns!", "ela usa saia"]


@pytest.fixture
def tiny(tmp_path):
    """A checkout root and a benchmark directory holding the real
    configurations and metric readers, and two tiny traffic files (6
    texts; batches of 4), with a spec of one cell of each loop per
    configuration, each metric read in the tiny cells that stand for the
    cells it names. Returns (root, bench dir, spec)."""
    bench = tmp_path / "bench"
    for d in ("configs", "metrics"):
        shutil.copytree(os.path.join(ROOT, "benchmark", d), bench / d)
    (bench / "traffic").mkdir()
    (bench / "traffic" / "tiny.json").write_text(json.dumps(
        {"utterances": [{"name": str(i), "text": t, "speed": 1.0}
                        for i, t in enumerate(TINY_TEXTS)]}))
    (bench / "traffic" / "tiny_batch.json").write_text(json.dumps(
        {"loop": "stream", "texts": "tiny.json", "batch": 4,
         "warm_batches": 3, "check_texts": 3, "check_answers": 8}))
    (bench / "traffic" / "tiny_call.json").write_text(json.dumps(
        {"loop": "call", "texts": "tiny.json",
         "check_texts": 3, "check_answers": 8}))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    tiny_name = {w["name"]: ("batch" if w["traffic"] == "batch" else "call")
                 + "_" + w["config"] for w in spec["workloads"]}
    spec["workloads"] = [
        {"name": f"{loop}_{cfg}", "config": cfg, "traffic": f"tiny_{loop}",
         "chips": 1, "why": "tiny"}
        for cfg in ("ctts_ptbr_1x", "ctts_ptbr_1.5x")
        for loop in ("batch", "call")]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [tiny_name[w] for w in m["workloads"]]
    return str(tmp_path), str(bench), spec
