"""A run of each cell, with the chip's look skipped and the timed path
broken underneath, comes out not correct; the same run unbroken comes out
correct. At a tiny size on the CPU, planted in the program (the CPU runs
every step eagerly; on the card ``perfbench/control.py`` plants the faults
in the replayed step)."""

import time

import pytest
import torch

from conftest import tiny_cell
from perfbench import harness, parts

CELLS = ["hmnist_hensman.train", "hmnist_closed.train"]


def _run(workload: str) -> dict:
    return harness.run_cell(tiny_cell(workload), 2 ** 31 + 21, 0.2, False, time.perf_counter(),
                            device="cpu")[0]


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    out = _run(workload)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("workload", CELLS)
def test_state_unchanged(monkeypatch, workload):
    """Each step computes its output and leaves every trained tensor as it
    was."""
    regime = parts.find("regimes", tiny_cell(workload).config["regime"])
    from lvae_torch.train.hensman import HensmanTrainer
    from lvae_torch.train.standard import StandardTrainer

    for cls in (HensmanTrainer, StandardTrainer):
        real = cls._step

        def step(self, *args, real=real):
            tensors = list(regime.trained(self).values())
            before = [t.detach().clone() for t in tensors]
            out = real(self, *args)
            with torch.no_grad():
                for t, b in zip(tensors, before):
                    t.copy_(b)
            return out

        monkeypatch.setattr(cls, "_step", step)
    out = _run(workload)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_half_batch(workload):
    regime = parts.find("regimes", tiny_cell(workload).config["regime"])
    with regime.half_batch(replay_only=False):
        out = _run(workload)
    assert not out["correct"], out["checks"]
