"""BENCHMARK.json and every configuration, traffic and metric file parse, use
only the allowed characters, and are found by name."""

import importlib
import json
import re

import pytest

from isacbench import harness

SPEC = harness.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TEXT_MAX = 200


def _line(text):
    return 1 <= len(text) <= TEXT_MAX and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
    assert 1 <= len(SPEC["command"]) <= 32 and all(_line(w) for w in SPEC["command"])
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert (harness.CHECKOUT / "BENCHMARK.json").stat().st_size <= 64 * 1024


@pytest.mark.parametrize("cfg", SPEC["configs"], ids=lambda c: c["name"])
def test_config_file(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(cfg["name"]) and _line(cfg["source"]) and _line(cfg["why"])
    assert cfg["file"] == f"isacbench/configs/{cfg['name']}.json"
    body = json.loads((harness.CHECKOUT / cfg["file"]).read_text())
    assert body["name"] == cfg["name"] and body["source"] == cfg["source"]
    assert body["reduced"] == cfg["reduced"] and len(cfg["reduced"]) <= 16
    for key in cfg["reduced"]:
        assert NAME.match(key) and key in body["deployment"] and key in body["source_values"]
    assert any(w["config"] == cfg["name"] for w in SPEC["workloads"])


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda c: c["name"])
def test_workload(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"]) and _line(cell["why"])
    assert cell["chips"] in (1, 4)
    harness.find(SPEC["configs"], cell["config"], "config")
    traffic = harness.load_json("traffic", cell["traffic"])
    kind = importlib.import_module(f"isacbench.kinds.{traffic['kind']}")
    assert all(hasattr(kind, f) for f in ("setup", "window", "release"))
    e2e = [m for m in SPEC["end_to_end"] if cell["name"] in m.get("workloads", [cell["name"]])]
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert any(cell["name"] in m.get("workloads", [cell["name"]]) for m in SPEC["per_layer"])


def test_unique_names():
    for group in ("configs", "workloads"):
        names = [x["name"] for x in SPEC[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("m", SPEC["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end(m):
    assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
    assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert m["source"] in ("host_clock", "device_trace")
    assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("m", SPEC["per_layer"], ids=lambda m: m["name"])
def test_per_layer(m):
    assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert _line(m["layer"])
    moved = harness.find(SPEC["end_to_end"], m["moves"], "end-to-end metric")
    for w in m.get("workloads", []):
        harness.find(SPEC["workloads"], w, "workload")
        assert w in moved.get("workloads", [w])
    assert callable(harness.load_reader(m["name"]))
    if m["name"].endswith("_roofline"):
        assert m["unit"] == "%"
