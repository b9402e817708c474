"""A run's check against faults planted in the timed path: the harness
drives a whole run at small sizes on the CPU (set-up, window, check), with
the look for a card skipped, and `correct` comes out false for each fault
the cell can have. One card, so no exchange between cards to leave out."""
import pytest
import torch

from portbench.harness.faults import planted
from portbench.harness.run_cell import run
from portbench.tests.small import small_cell

CPU = torch.device("cpu")
CASES = [("dssm_recall-train_zipf", "unchanged"),
         ("dssm_recall-train_zipf", "half_batch"),
         ("dcn_criteo-train_zipf", "unchanged"),
         ("dcn_criteo-train_zipf", "half_batch"),
         ("dssm_recall-serve_top100", "altered_answer"),
         ("dcn_criteo-score_2048", "altered_answer")]


@pytest.mark.parametrize("workload,fault", CASES)
def test_a_planted_fault_is_not_correct(workload, fault):
    cell = small_cell(workload)
    with planted(fault):
        result = run(cell, 2**31 + 101, 1.0, False, CPU, 0.0, log=lambda s: None)
    assert result["correct"] is False
    failed = [n for n, c in result["checks"].items() if c["value"] > c["limit"]]
    assert failed, result["checks"]


def test_faults_are_put_back():
    from recommendflow_tpu_torch.train.trainer import Trainer
    before = Trainer._device_step, Trainer._forward_backward
    with planted("unchanged"):
        assert Trainer._device_step is not before[0]
    with planted("half_batch"):
        assert Trainer._forward_backward is not before[1]
    assert (Trainer._device_step, Trainer._forward_backward) == before
