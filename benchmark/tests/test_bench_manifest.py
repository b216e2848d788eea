"""BENCHMARK.json against the contract, and every file it names found by
name."""
import json
import os
import re

import pytest

from benchmark.harness import manifest

MAN = manifest.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def _metrics():
    return MAN["end_to_end"] + MAN["per_layer"]


def test_top_level_keys_and_size():
    assert set(MAN) == KEYS
    path = os.path.join(manifest.ROOT, "BENCHMARK.json")
    assert os.path.getsize(path) <= 64 * 1024
    assert MAN["command"][:2] == ["python3", "benchmark/run.py"]
    assert MAN["paths"] == ["benchmark"]
    assert 1 <= MAN["run_seconds"] <= 51


def test_names_and_units():
    names = ([c["name"] for c in MAN["configs"]]
             + [w["name"] for w in MAN["workloads"]]
             + [m["name"] for m in _metrics()])
    assert len(set(names)) == len(names)
    for n in names + [w["traffic"] for w in MAN["workloads"]]:
        assert NAME.match(n), n
    for m in _metrics():
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_end_to_end_bounds():
    names = {m["name"] for m in MAN["end_to_end"]}
    assert "setup_s" in names
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}


@pytest.mark.parametrize("m", MAN["per_layer"], ids=lambda m: m["name"])
def test_per_layer_cells_report_their_moves(m):
    cells = m.get("workloads", [w["name"] for w in MAN["workloads"]])
    for cell in cells:
        reported = {e["name"] for e in manifest.end_to_end_for(MAN, cell)}
        assert m["moves"] in reported, (m["name"], cell)
    assert set(m) <= {"name", "unit", "better", "source", "layer", "moves",
                      "workloads"}


@pytest.mark.parametrize("w", MAN["workloads"], ids=lambda w: w["name"])
def test_cell_files_found_by_name(w):
    cfg = manifest.config(w["config"])
    assert cfg["name"] == w["config"]
    tr = manifest.traffic(w["traffic"])
    manifest.driver(tr["kind"])
    lim = manifest.limits(w["name"])
    assert lim and all("limit" in v for v in lim.values())
    assert w["chips"] == 1
    assert len(w["why"]) <= 200
    for m in (manifest.end_to_end_for(MAN, w["name"])
              + manifest.per_layer_for(MAN, w["name"])):
        assert callable(manifest.metric_reader(m["name"]).read)
    reported = manifest.end_to_end_for(MAN, w["name"])
    assert len(reported) >= 2 and manifest.per_layer_for(MAN, w["name"])


@pytest.mark.parametrize("c", MAN["configs"], ids=lambda c: c["name"])
def test_config_entries(c):
    assert c["file"] == f"benchmark/configs/{c['name']}.json"
    with open(os.path.join(manifest.ROOT, c["file"])) as f:
        cfg = json.load(f)
    assert cfg["reduced"] == c["reduced"]
    assert c["source"] == cfg["source"] and len(c["source"]) <= 200
    assert any(w["config"] == c["name"] for w in MAN["workloads"])


def test_layers_are_perf_md_layers():
    with open(os.path.join(manifest.ROOT, "PERF.md")) as f:
        perf = f.read()
    for m in MAN["per_layer"]:
        assert f"| {m['layer']} |" in perf, m["layer"]


def test_a_suffixed_metric_falls_back_to_its_base_reader():
    base = manifest.metric_reader("fwd_ms_per_step")
    kind = manifest.metric_reader("fwd_ms_per_step.trajopt")
    assert base.__file__ == kind.__file__
    assert base.__file__.endswith(os.path.join("metrics",
                                               "fwd_ms_per_step.py"))
