"""The control comes out not correct: the reference put in the program's
place with TF32 on (the step below float32 with TF32 off) fails one of the
cell's limits, at the cell's own size on the card, and so does each fault
planted in the replayed step (half of each batch left out; stale fixed
inputs), while the program's own run on the same seed passes them all.
Marked ``cuda``; skips without a card."""

import pytest

from perfbench import control, harness


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["hmnist_hensman.train", "hmnist_closed.train"])
def test_control_and_replayed_faults_fail_a_limit(card, workload):
    cell = harness.load(workload)
    row = control.train_readings(cell, 2 ** 31 + 202, True, "cuda")
    limits = {k: v["limit"] for k, v in cell.limits.items()}
    assert all(row["program"][k] <= limits[k] for k in limits), row
    for wrong in ("control_tf32", "fault_half_batch_replay", "fault_stale_inputs"):
        assert any(row[wrong][k] > limits[k] for k in limits), (wrong, row)
