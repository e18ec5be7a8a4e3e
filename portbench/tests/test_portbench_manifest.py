"""BENCHMARK.json against the benchmark's contract, and every file a cell
names found by its name."""

import json
import os
import re

import numpy as np
import pytest

from conftest import ROOT
from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys_and_command():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert m["command"] == ["python3", "portbench/run.py"]
    assert m["paths"] == ["portbench"]
    assert 1 <= m["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024


def test_names_and_units():
    m = manifest()
    names = [c["name"] for c in m["configs"]] + [
        w["name"] for w in m["workloads"]] + [
        x["name"] for x in m["end_to_end"] + m["per_layer"]]
    names += [w["traffic"] for w in m["workloads"]]
    names += [k for c in m["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    metrics = m["end_to_end"] + m["per_layer"]
    assert len({x["name"] for x in metrics}) == len(metrics)
    assert all(UNIT.match(x["unit"]) for x in metrics)
    assert all(x["better"] in ("lower", "higher") for x in metrics)


def test_metrics_rules():
    m = manifest()
    e2e = {x["name"]: x for x in m["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= x["bound"] <= 0.25 for x in e2e.values())
    assert all(x["source"] in ("host_clock", "device_trace")
               for x in e2e.values())
    cells = [w["name"] for w in m["workloads"]]
    for x in m["per_layer"]:
        assert x["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert x["moves"] in e2e
        moved = e2e[x["moves"]].get("workloads", cells)
        assert set(x["workloads"]) <= set(moved), x["name"]
        if x["name"].endswith("_roofline") or "mfu" in x["name"]:
            assert x["unit"] == "%"
    layers = {}
    for x in m["per_layer"]:
        layers.setdefault(x["layer"].split(",")[0], set()).add(x["layer"])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("cell", [w["name"] for w in manifest()["workloads"]])
def test_cell_files_found_by_name(cell):
    m = manifest()
    spec = harness.load_spec(cell)
    w = spec.cell
    assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    assert int(spec.traffic.get("ranks", 1)) <= w["chips"]
    harness.load_module("drivers", spec.traffic["kind"])
    for x in spec.end_to_end + spec.per_layer:
        assert callable(harness.load_module("metrics", x["name"]).read)
    names = {x["name"] for x in spec.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and spec.per_layer
    assert spec.limits and all("limit" in v for v in spec.limits.values())
    conf = next(c for c in m["configs"] if c["name"] == w["config"])
    assert conf["file"].startswith("portbench/")


def test_configs_are_the_committed_presets():
    m = manifest()
    files = [c["file"] for c in m["configs"]]
    assert len(set(files)) == len(files)
    for c in m["configs"]:
        assert c["reduced"] == []
        with open(os.path.join(ROOT, c["file"])) as f:
            conf = json.load(f)
        with np.load(os.path.join(ROOT, conf["checkpoint"])) as z:
            stored = json.loads(bytes(z["__config__"].tobytes()).decode())
            n = sum(z[k].size for k in z.files if k != "__config__")
        assert conf["model"] == stored
        assert conf["params"] == n
    used = {w["config"] for w in m["workloads"]}
    assert used == {c["name"] for c in m["configs"]}


def test_four_card_cells_within_share():
    m = manifest()
    four = [w for w in m["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(m["workloads"]) // 4)
