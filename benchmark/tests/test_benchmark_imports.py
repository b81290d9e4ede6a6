"""What the benchmark imports, by its modules' sources: nothing of JAX
or of the JAX package anywhere, and nothing of the port in the
reference and the yardstick. Top-level names (before the first dot)
are compared whole: ctts_tpu_torch is not ctts_tpu."""

import ast
import os

import pytest

from conftest import ROOT

from benchmark.harness import forbidden_modules

BENCH = os.path.join(ROOT, "benchmark")
NO_JAX = {"jax", "jaxlib", "flax", "ctts_tpu"}
# The reference, the voice it reads, and the arithmetic that decides what
# is measured: independent of the program.
YARDSTICK = ("reference", "voice.py", "yardstick.py", "generator.py",
             "trace.py", "check.py", "control.py", "metrics")


def modules():
    for d, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def imported_tops(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".", 1)[0])
    return tops


def test_scan_reads_every_module():
    paths = list(modules())
    assert any(p.endswith(os.path.join("reference", "oracle.py"))
               for p in paths)
    assert "ctts_tpu_torch" in imported_tops(os.path.join(BENCH,
                                                          "harness.py"))


@pytest.mark.parametrize("path", sorted(modules()),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax_and_a_reference_free_of_the_port(path):
    tops = imported_tops(path)
    assert not tops & NO_JAX, (path, tops & NO_JAX)
    rel = os.path.relpath(path, BENCH)
    if rel.split(os.sep)[0] in YARDSTICK and not rel.startswith("tests"):
        assert "ctts_tpu_torch" not in tops, rel


def test_loaded_modules_compared_by_whole_top_level_name():
    fake = {"ctts_tpu_torch": 1, "ctts_tpu_torch.ops": 1, "jaxtyping": 1,
            "numpy": 1}
    assert forbidden_modules(fake) == []
    fake.update({"ctts_tpu.ops": 1, "jax": 1, "jaxlib.xla": 1, "flax": 1})
    assert forbidden_modules(fake) == ["ctts_tpu.ops", "flax", "jax",
                                       "jaxlib.xla"]
