"""The harness finds a cell by name: a cell added as new files and one
entry of BENCHMARK.json, with nothing else edited, is found; run.py exits
with no result without a card, and in a directory that holds only
BENCHMARK.json and portbench/."""
import json
import os
import shutil
import subprocess
import sys

from portbench.harness.cell import ROOT, Cell, read_json


def test_a_new_cell_is_found_by_name(tmp_path):
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    bench = read_json(os.path.join(ROOT, "BENCHMARK.json"))
    traffic = read_json(os.path.join(ROOT, "portbench", "traffic", "score_2048.json"))
    traffic.update(rows=512)
    (tmp_path / "portbench" / "traffic" / "score_512.json").write_text(json.dumps(traffic))
    (tmp_path / "portbench" / "metrics" / "rows_seen.py").write_text(
        "def read(ctx):\n    return float(len(ctx.batches))\n")
    bench["workloads"].append({"name": "dcn_criteo-score_512", "config": "dcn_criteo",
                               "traffic": "score_512", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "rows_seen", "unit": "count", "better": "higher",
                               "source": "device_trace", "layer": "device",
                               "moves": "requests_per_s",
                               "workloads": ["dcn_criteo-score_512"]})
    for m in bench["end_to_end"]:
        if "workloads" in m and "dcn_criteo-score_2048" in m["workloads"]:
            m["workloads"].append("dcn_criteo-score_512")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = Cell("dcn_criteo-score_512", root=str(tmp_path))
    assert cell.traffic["rows"] == 512
    assert cell.config["name"] == "dcn_criteo"
    assert [m["name"] for m in cell.per_layer] == ["rows_seen"]
    assert cell.reader("rows_seen").read(type("C", (), {"batches": [1, 2]})) == 2.0
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "requests_per_s"}


def run_py(cwd, env=None):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "dcn_criteo-score_2048",
         "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def test_without_a_card_run_exits_nonzero_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = run_py(ROOT, env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_alone_in_a_directory_run_exits_nonzero_and_prints_no_result(tmp_path):
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = run_py(str(tmp_path), env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
