"""BENCHMARK.json and the files it names: every configuration, traffic
mix and metric found and parsed by its name, and the contract's limits
on names, units and keys."""

import json
import os
import re

import pytest

from conftest import ROOT

from benchmark.harness import Cell, load_json

SPEC = load_json(os.path.join(ROOT, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


def test_top_level_keys_and_command():
    assert set(SPEC) == TOP
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_files_found_by_name(cell):
    c = Cell(SPEC, cell)
    assert c.traffic["loop"] in ("stream", "call")
    assert float(c.config["speed"]) in (1.0, 1.5)
    names = [m["name"] for m in c.end_to_end]
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(c.reader(m["name"]))


def test_names_units_and_keys():
    seen = set()
    for entry in SPEC["configs"] + SPEC["workloads"] + SPEC["end_to_end"] \
            + SPEC["per_layer"]:
        assert NAME.match(entry["name"]), entry["name"]
        assert entry["name"] not in seen
        seen.add(entry["name"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    layers = {}
    for m in SPEC["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        layers.setdefault(m["layer"], m["layer"])
        moved = next(x for x in SPEC["end_to_end"] if x["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", m["workloads"]))
    for c in SPEC["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert len(c["source"]) <= 200 and len(c["why"]) <= 200
    for w in SPEC["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_configuration_writes_out_every_key():
    """Each configuration file holds every key of the port's
    configuration, so that a change to the port's defaults does not
    move the yardstick."""
    import dataclasses

    from ctts_tpu_torch.config import CTTSConfig

    keys = {f.name for f in dataclasses.fields(CTTSConfig)}
    for c in SPEC["configs"]:
        cfg = load_json(os.path.join(ROOT, c["file"]))
        assert set(cfg["config"]) == keys
        assert cfg["name"] == c["name"]
        assert cfg["check"]["max_lsb"] >= 0
