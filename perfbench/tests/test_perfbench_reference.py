"""The plain reference against the port's CPU path, at a tiny size: the
three training steps of each regime in float64 (both sides in exact
arithmetic up to rounding)."""

import pytest
import torch

from conftest import tiny_cell
from perfbench import parts


@pytest.mark.parametrize("workload", ["hmnist_hensman.train", "hmnist_closed.train"])
def test_training_steps_agree_in_float64(workload):
    cell = tiny_cell(workload)
    kind = parts.find("kinds", cell.traffic["kind"])
    sut = kind.make(cell.config, cell.traffic, 2 ** 31 + 11, "cpu", torch.float64)
    sut.setup()
    sut.release()
    gaps = sut.gaps()
    assert gaps["loss_gap"] < 1e-12
    assert gaps["recon_gap"] < 1e-12
    assert gaps["grad_gap"] < 1e-10
    assert gaps["change_gap"] < 1e-8


def test_reference_draws_are_the_documented_convention():
    """The reference works out the program's draws from the seed alone: one
    CPU generator, a permutation an epoch, then one normal draw a batch."""
    from perfbench.reference import steps as rs

    draws = rs.hensman_draws(7, 6, 2, 3, 4, 3, torch.float32)
    gen = torch.Generator().manual_seed(7)
    perm = torch.randperm(6, generator=gen)
    assert torch.equal(torch.cat([r for r, _ in draws]), perm)
    assert torch.equal(draws[1][1], (lambda _: torch.randn((6, 4), generator=gen))(
        torch.randn((6, 4), generator=gen)))
