"""Shared pieces of the benchmark's tests: the repository root on the path,
the card fixture, and a cell cut to a size the CPU runs in a second."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# widths and counts small enough for the CPU; the image stays 36×36
TINY_CONFIG = {"latent_dim": 4, "M": 5, "P": 6, "T": 6, "subjects_per_batch": 2}


def tiny_cell(workload: str):
    """The cell of ``workload`` with :data:`TINY_CONFIG`'s sizes."""
    from perfbench import harness

    cell = harness.load(workload)
    return cell._replace(config={**cell.config, **TINY_CONFIG})


@pytest.fixture
def card():
    """Skips unless a CUDA device is present (decided when the test runs)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark runs on the card")
    return torch.device("cuda")
