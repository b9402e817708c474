"""BENCHMARK.json against its rules: keys, names, units,
every file it names present, every metric's cells reporting what it moves,
and the run length within a full check's time."""
import json
import os
import re

import pytest

from portbench.harness.cell import ROOT, Cell, read_json

BENCH = read_json(os.path.join(ROOT, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
METRIC_KEYS = {"name", "unit", "better", "source"}


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(TEXT.match(w) for w in BENCH["command"])
    for p in BENCH["paths"]:
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", p) and ".." not in p
        assert not p.endswith("_torch") and os.path.isdir(os.path.join(ROOT, p))
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51


def test_a_full_check_of_24_cells_fits():
    s = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


def all_names():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            yield group, e["name"]


@pytest.mark.parametrize("group,name", list(all_names()))
def test_names(group, name):
    assert NAME.match(name), name


def test_names_are_distinct():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))


def test_configs():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert c["file"].startswith("portbench/") and os.path.isfile(
            os.path.join(ROOT, c["file"]))
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    assert len({c["file"] for c in BENCH["configs"]}) == len(BENCH["configs"])


def test_workloads():
    pairs = set()
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and TEXT.match(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert os.path.isfile(os.path.join(ROOT, "portbench", "traffic",
                                           w["traffic"] + ".json"))


def test_metrics():
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert TEXT.match(m["layer"])
        assert os.path.isfile(os.path.join(ROOT, "portbench", "metrics",
                                           m["name"] + ".py"))


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in BENCH["workloads"]:
        cell = Cell(w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in names, (w["name"], m["name"])


def test_one_layer_one_name():
    by_module = {}
    for m in BENCH["per_layer"]:
        by_module.setdefault(m["layer"], []).append(m["name"])
    assert "device" in by_module


def config_file(name):
    entry = [c for c in BENCH["configs"] if c["name"] == name][0]
    return read_json(os.path.join(ROOT, entry["file"]))


def test_dcn_criteo_is_at_the_papers_widths():
    c = config_file("dcn_criteo")
    assert c["model_args"]["cross_layers"] == c["source_settings"]["cross_layers"] == 6
    assert c["model_args"]["hidden_units"] == [1024, 1024]
    assert c["batch_size"] == c["source_settings"]["batch_size"] == 512
    sparse = [f for f in c["features"] if f["kind"] == "sparse"]
    dense = [f for f in c["features"] if f["kind"] == "dense"]
    assert len(sparse) == 26 and len(dense) == 13
    card = c["cardinalities"]["values"]
    for f in sparse:
        # 6 x cardinality^(1/4), each category a row of its own (row 0 the pad)
        assert f["dim"] == round(6 * card[f["name"]] ** 0.25), f["name"]
        assert f["rows"] == card[f["name"]] + 1 and f["hashes"] == 1
    assert c["embedding_dims"]["x0_width"] == sum(f["dim"] for f in sparse) + 13
    assert c["reduced"] == [e["reduced"] for e in BENCH["configs"]
                            if e["name"] == "dcn_criteo"][0] == []


def test_dssm_recall_is_at_its_sources_widths():
    c = config_file("dssm_recall")
    assert c["model_args"]["tower_units"] == c["source_settings"]["tower_units"] \
        == [1024, 512, 256]
    assert c["port_conf"]["Networks"]["tower_units"] == [1024, 512, 256]
    assert "embedding_dim" not in c["port_conf"]["Networks"]
    assert c["model_args"]["activation"] == "selu" and c["model_args"]["batch_norm"]
    assert c["batch_size"] == 1024
    search = read_json(os.path.join(ROOT, "portbench", "traffic", "serve_top100.json"))
    assert search["catalogue"]["dim"] == c["model_args"]["tower_units"][-1]
