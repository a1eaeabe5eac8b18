"""BENCHMARK.json against the files the harness finds by name, and the
contract's rules on names, units and cells (CPU, no card)."""
import json
import os
import re

import pytest
import yaml

from rtbench import calls, run

BENCH = run.load_json(run.ROOT, "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["rtbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", BENCH["workloads"],
                         ids=lambda c: c["name"])
def test_cell_files(cell):
    configs = {c["name"]: c for c in BENCH["configs"]}
    assert os.path.exists(os.path.join(run.ROOT,
                                       configs[cell["config"]]["file"]))
    spec = run.load_json(run.HERE, "traffic", cell["traffic"] + ".json")
    kind = calls.load_kind(spec["call"])
    assert all(callable(getattr(kind, f))
               for f in ("setup", "call", "reference", "work"))
    limits = run.load_json(run.HERE, "limits", cell["name"] + ".json")
    assert limits and all(v > 0 for v in limits.values())
    assert cell["chips"] == 1
    assert 1 <= len(cell["why"]) <= 200


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_reader_and_names(metric):
    assert NAME.match(metric["name"])
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert callable(run.load_reader(metric["name"]))
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells


def test_names_unique_and_well_formed():
    for group in ("configs", "workloads"):
        names = [x["name"] for x in BENCH[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    names = [m["name"] for m in METRICS]
    assert len(names) == len(set(names))
    for c in BENCH["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])


@pytest.mark.parametrize("cell", BENCH["workloads"],
                         ids=lambda c: c["name"])
def test_every_cell_reports_what_its_metrics_move(cell):
    e2e = {m["name"] for m in run.cell_metrics(BENCH, cell, False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    per_layer = run.cell_metrics(BENCH, cell, True)
    assert per_layer
    for m in BENCH["per_layer"]:
        if cell["name"] in m.get("workloads", ()):
            assert m["moves"] in e2e


def test_per_layer_layers_are_named():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert layers <= {"config and model build", "device", "kernels",
                      "RT algebra in torch ops", "forward-mode AD",
                      "host driver", "entry"}


def test_o2a_is_the_source_below_its_header():
    """Below its ``benchmark`` block the o2a file is the upstream file as
    the repository holds it; what a run takes in place of a value is named
    in ``assumed``."""
    config = {c["name"]: c for c in BENCH["configs"]}["o2a"]
    with open(os.path.join(run.ROOT, config["file"])) as f:
        ours = yaml.safe_load(f)
    with open(os.path.join(run.ROOT, "vsmartmom", "config",
                           "default_parameters.yaml")) as f:
        upstream = yaml.safe_load(f)
    head = ours.pop("benchmark")
    assert head["source"] == config["source"]
    assert head["reduced"] == config["reduced"] == []
    assert ours == upstream
    assert calls.assumed(os.path.join(run.ROOT, config["file"])) \
        == {"float_type": "Float32"}
