"""Cells on a mesh, on the CPU over gloo: the launch of the other ranks, the
mesh path's check (sound, under faults, under the TF32 control), the
weights drawn by block, the mesh reference against the one-card
reference, a failing rank ending the run, and a one-card cell that builds
no group. Each test has its own time limit."""
import json
import os
import signal
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench.harness import paths, ranks, run_cell
from portbench.harness import traffic as gen
from portbench.harness.cell import ROOT
from portbench.harness.paths import FitPath, MeshFitPath
from portbench.harness.run_cell import judge, launch, passed
from portbench.reference import common
from portbench.reference.common import (TouchedRows, draw_logical_rows,
                                        draw_rows, make_dense)
from portbench.reference.layout import Layout
from portbench.tests.small import mesh_cell, small_cell

CPU = torch.device("cpu")
WORKLOAD = "dcn_criteo-train_zipf"
LIMIT_S = 300          # each test (an in-process run shares the CPU with others)
RUN_LIMIT_S = 110      # a run of the launcher
SEED = 2**31 + 4242


@pytest.fixture(autouse=True)
def time_limit():
    def expired(signum, frame):
        raise TimeoutError(f"the test ran past its {LIMIT_S} s")
    old = signal.signal(signal.SIGALRM, expired)
    signal.alarm(LIMIT_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def left_in_session(sid: int, wait_s: float = 10.0):
    """Processes still in the session `sid` (the launcher's children) after
    up to `wait_s` seconds: a child notices a killed rank 0 within a second."""
    end = time.monotonic() + wait_s
    while True:
        left = []
        for d in os.listdir("/proc"):
            if d.isdigit():
                try:
                    if os.getsid(int(d)) == sid:
                        left.append(int(d))
                except OSError:
                    pass
        if not left or time.monotonic() > end:
            return left
        time.sleep(0.2)


def launched(*args: str, limit: float = RUN_LIMIT_S):
    """(exit code, the result or None, stderr, seconds, leftovers) of
    `rank_cell` run as its own session."""
    t0 = time.monotonic()
    p = subprocess.Popen([sys.executable, "-m", "portbench.tests.rank_cell", *args],
                         cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, start_new_session=True)
    try:
        out, err = p.communicate(timeout=limit)
    finally:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
            p.communicate()
    seconds = time.monotonic() - t0
    lines = [x for x in out.strip().splitlines() if x.startswith("{")]
    result = json.loads(lines[-1]) if lines else None
    return p.returncode, result, err, seconds, left_in_session(p.pid)


@pytest.mark.parametrize("chips", [1, 2, 4])
def test_a_mesh_cell_is_correct(chips):
    rc, result, err, _, left = launched("--chips", str(chips), "--seed", str(SEED),
                                        "--seconds", "1")
    assert rc == 0, err[-3000:]
    assert result["correct"] is True, result["checks"]
    assert result["device"]["count"] == chips
    assert [r["rank"] for r in result["device"]["per_rank"]] == list(range(chips))
    assert result["attempted"] > 0
    # every rank holds its block of the two tables big enough to shard
    for k in range(chips):
        assert f"rank {k}: row-sharded over {chips} rank(s): dim8 dim339" in err
    assert not left


def test_a_model_built_at_one_ranks_share_takes_its_block():
    rc, result, err, _, left = launched("--chips", "2", "--seed", str(SEED + 6),
                                        "--seconds", "0.5", "--share-tables", "1")
    assert rc == 0, err[-3000:]
    assert result["correct"] is True, result["checks"]
    assert "rank 1: row-sharded over 2 rank(s): dim8 dim339" in err
    assert not left


@pytest.mark.parametrize("fault", ["half_batch", "unchanged", "no_exchange"])
def test_a_planted_fault_on_a_mesh_is_not_correct(fault):
    rc, result, err, _, left = launched("--chips", "2", "--seed", str(SEED + 1),
                                        "--seconds", "0.5", "--fault", fault)
    assert rc == 0, err[-3000:]
    assert result["correct"] is False
    assert [n for n, c in result["checks"].items() if c["value"] > c["limit"]]
    assert not left


def test_a_serving_cell_does_not_run_on_a_mesh():
    rc, result, err, _, left = launched("--workload", "dcn_criteo-score_2048",
                                        "--chips", "2", "--seed", str(SEED),
                                        "--seconds", "0.5", limit=60)
    assert rc not in (0, None) and result is None
    assert "does not run on a mesh" in err
    assert not left, left


@pytest.mark.parametrize("rank,at", [(0, "setup"), (1, "setup"), (3, "setup"),
                                     (0, "window"), (2, "window")])
def test_a_failing_rank_ends_the_run(rank, at):
    """A rank that raises in set-up, or is killed as the window opens while
    the others wait in its collectives: the launcher exits other than 0,
    soon, with no result and no process left."""
    rc, result, err, seconds, left = launched(
        "--chips", "4", "--seed", str(SEED + 2), "--seconds", "5",
        "--fail-rank", str(rank), "--fail-at", at, limit=60)
    assert rc not in (0, None), err[-3000:]
    assert result is None
    assert f"rank {rank} fails in set-up" in err if at == "setup" else \
        f"rank {rank} is killed in its window" in err
    assert seconds < 60
    assert not left, left


def test_a_one_card_cell_builds_no_group_and_no_mesh(monkeypatch, capsys):
    def refuse(*args, **kwargs):
        raise AssertionError("a one-card cell built a group")
    monkeypatch.setattr(ranks.Group, "__init__", refuse)
    monkeypatch.setattr(ranks, "start", refuse)
    made = []

    def make_path(*args, **kwargs):
        made.append(paths.make_path(*args, **kwargs))
        return made[-1]
    monkeypatch.setattr(run_cell, "make_path", make_path)
    rc = launch(small_cell(WORKLOAD), SEED + 3, 0.5, False, time.monotonic(),
                ["unused"], device_type="cpu")
    assert rc == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["correct"] is True and result["device"]["count"] == 1
    assert "per_rank" not in result["device"]
    assert type(made[0]) is FitPath
    assert not (torch.distributed.is_available() and torch.distributed.is_initialized())


# ------------------------------------------------------- weights by block

@pytest.mark.parametrize("dim", [8, 339])
def test_rows_drawn_alone_are_the_whole_draws_rows(monkeypatch, dim):
    monkeypatch.setattr(common, "BLOCK_ELEMENTS", 1000 * dim + 7 * dim)  # 1007 rows
    layout = Layout(mesh_cell(WORKLOAD, 2).config)
    g = layout.groups[dim]
    whole = draw_rows(layout, SEED, dim, 0, g.logical_rows, CPU)
    assert whole.shape == (g.logical_rows, dim)
    assert not whole[sorted(g.offsets.values())].any()       # pad rows zero
    for a, b in [(0, 5), (1000, 1014), (2014, 3021), (1007 * 3 - 1, 1007 * 5 + 1),
                 (g.logical_rows - 9, g.logical_rows)]:
        assert torch.equal(draw_rows(layout, SEED, dim, a, b, CPU), whole[a:b])
    ids = torch.unique(torch.randint(0, g.logical_rows, (500,)))
    assert torch.equal(draw_logical_rows(layout, SEED, dim, ids), whole[ids])
    touched = TouchedRows(layout, SEED, dim, ids)
    assert torch.equal(touched[ids], whole[ids])
    # whole stored rows: every logical row of a touched stored row is held
    stored = touched.values.view(-1, g.pack * dim)
    assert torch.equal(stored, whole.view(-1, g.pack * dim)[touched.stored])
    # another seed, another table
    assert not torch.equal(draw_rows(layout, SEED + 1, dim, 0, 50, CPU), whole[:50])


def reference_path(chips: int) -> MeshFitPath:
    """A mesh path for its reference alone (no group, no program): the pool's
    first three global batches, the configuration's dropout."""
    cell = mesh_cell(WORKLOAD, chips, dropout=None)
    assert cell.config["model_args"]["dropout"] > 0
    group = SimpleNamespace(world=chips, rank=0)
    path = MeshFitPath(cell, CPU, SEED + 5, group)
    path.pool = gen.batch_pool(path.layout, int(cell.config["batch_size"]), 3,
                               path.seed, float(cell.traffic["zipf"]))
    return path


def assert_same(a, b, rtol=1e-12):
    assert np.allclose(a["loss"], b["loss"], rtol=rtol, atol=0)
    for k in ("grad", "change"):
        assert a[k].keys() == b[k].keys()
        for leaf in a[k]:
            assert np.isclose(a[k][leaf], b[k][leaf], rtol=rtol, atol=0), (k, leaf)


def whole_tables(path):
    return {d: draw_rows(path.layout, path.seed, d, 0, g.logical_rows, CPU)
            for d, g in path.layout.groups.items()}


@pytest.mark.parametrize("chips", [2, 4])
def test_the_mesh_reference_is_the_one_card_reference(chips):
    """The mesh reference, holding only the touched rows, reads what the
    one-card reference reads over the whole tables drawn by block, its
    dropout drawn over the whole global batch alike."""
    path = reference_path(chips)
    one_card = FitPath.reference_steps(path, "float32", whole_tables(path),
                                       make_dense(path.specs, path.seed, CPU))
    assert_same(path.reference(), one_card)


@pytest.mark.parametrize("chips", [1, 2, 4])
def test_the_mesh_reference_holds_only_touched_rows(monkeypatch, chips):
    path = reference_path(chips)
    held = {}

    def steps(precision, tables, dense):
        held.update(tables)
        return FitPath.reference_steps(path, precision, tables, dense)
    monkeypatch.setattr(path, "reference_steps", steps)
    path.reference()
    assert held.keys() == path.layout.groups.keys()
    for d, t in held.items():
        assert isinstance(t, TouchedRows)
        assert len(t.values) < path.layout.groups[d].logical_rows


def test_the_control_on_a_mesh_is_not_correct():
    path = reference_path(2)
    numbers = path.numbers(path.reference("tf32"), path.reference("float32"))
    assert not passed(judge(numbers, path.cell.limits))


def test_the_ranks_numbers_combine_as_one_cards():
    parts = [{"loss": [1.0, 2.0, 3.0], "grad": {"w": 4.0}, "change": {"w": 5.0},
              "tables": {"table_dim8": (9.0, 16.0)}},
             {"loss": [1.0, 2.0, 3.0], "grad": {"w": 4.0}, "change": {"w": 5.0},
              "tables": {"table_dim8": (16.0, 9.0)}}]
    out = MeshFitPath.combine(parts)
    assert out == {"loss": [1.0, 2.0, 3.0], "grad": {"w": 4.0, "table_dim8": 5.0},
                   "change": {"w": 5.0, "table_dim8": 5.0}}
