"""The control: the reference computed in TF32 (every operand of every
matrix product rounded to TF32's mantissa, the nearest precision below the
configurations' float32 with TF32 off), put in the program's place, must
come out not correct. On the CPU at small sizes; with a card
(`-m cuda`), at the cells' own sizes on three seeds."""
import pytest
import torch

from portbench.harness.cell import Cell
from portbench.harness.paths import control_answers, make_path
from portbench.harness.run_cell import judge, passed
from portbench.tests.small import small_cell

WORKLOADS = ["dssm_recall-train_zipf", "dcn_criteo-train_zipf",
             "dssm_recall-serve_top100", "dcn_criteo-score_2048"]


def control_numbers(cell, device, seed):
    path = make_path(cell, device, seed)
    path.setup()
    if path.kind == "serve":
        path.window(1.0, False)
    path.free()
    if path.kind == "train":
        return path.numbers(path.reference("tf32"), path.reference("float32"))
    ctl = control_answers(path, path.reference("tf32"))
    return path.numbers(ctl, path.reference("float32", ctl))


def not_correct(numbers, limits):
    return not passed(judge(numbers, limits))


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_is_not_correct_at_small_size(workload):
    cell = small_cell(workload)
    assert not_correct(control_numbers(cell, torch.device("cpu"), 2**31 + 303),
                       cell.limits)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_is_not_correct_at_the_cells_size(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    cell = Cell(workload)
    for seed in (4000000001, 4000000002, 4000000003):
        assert not_correct(control_numbers(cell, torch.device("cuda", 0), seed),
                           cell.limits), seed
