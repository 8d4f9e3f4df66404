"""The port's CUDA kernel K2 on the card (marked ``cuda``).

These tests need an NVIDIA GPU and ``nvcc``; without a card they skip. On a
machine with a card, where JAX may be absent, run them without the suite's
JAX conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: max |Δ| over max |reference| per matrix, 1e-4 at n <= 20 and
1e-3 at n = 64, on SPD stacks with condition number 1e2 (f32 rounding grows
with n and the condition number; the two versions sum in other orders).
"""

import math

import pytest
import torch

from lvae_torch.kernels_cuda import cholesky as k2
from lvae_torch.ops import linalg as la

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


def spd_stack(shape, n, gen, cond=1e2):
    x = torch.randn(*shape, n, n, generator=gen, dtype=torch.float64, device="cuda")
    q, _ = torch.linalg.qr(x)
    lam = torch.logspace(0, math.log10(cond), n, dtype=torch.float64, device="cuda")
    a = (q * lam) @ q.mT
    return (0.5 * (a + a.mT)).float().contiguous()


def rel_err(got, want):
    num = (got - want).abs().amax(dim=(-1, -2))
    return float((num / want.abs().amax(dim=(-1, -2))).max())


@pytest.mark.parametrize("shape,n,tol", [((5, 3), 2, 1e-4), ((32, 100), 20, 1e-4), ((7,), 64, 1e-3)])
def test_kernel_matches_plain_version(gen, shape, n, tol):
    a = spd_stack(shape, n, gen)
    before = k2.cholesky_inverse.launches
    l, inv = k2.cholesky_inverse(a)
    torch.cuda.synchronize()
    assert k2.cholesky_inverse.launches == before + 1
    lr, ir = k2.cholesky_inverse_reference(a)
    assert rel_err(l, lr) <= tol and rel_err(inv, ir) <= tol
    assert bool((torch.triu(l, 1) == 0).all())
    assert torch.equal(inv, inv.mT)


def test_non_spd_block_gives_nan_in_that_block_only(gen):
    a = spd_stack((4,), 20, gen)
    a[2] = -a[2]
    l, inv = k2.cholesky_inverse(a)
    torch.cuda.synchronize()
    assert torch.isnan(l[2]).any() and torch.isnan(inv[2]).any()
    assert torch.isfinite(l[[0, 1, 3]]).all() and torch.isfinite(inv[[0, 1, 3]]).all()


def test_cholesky_and_inverse_gate(gen):
    """f32 with 2 <= n <= 64 launches the kernel; other dtypes and sizes take
    the plain path, as the JAX package sends them to XLA."""
    a = spd_stack((3,), 20, gen)
    before = k2.cholesky_inverse.launches
    la.cholesky_and_inverse(a)
    assert k2.cholesky_inverse.launches == before + 1
    la.cholesky_and_inverse(a.double())
    la.cholesky_and_inverse(spd_stack((2,), 65, gen))
    assert k2.cholesky_inverse.launches == before + 1


def test_wrapper_rejects_what_the_kernel_does_not_take(gen):
    a = spd_stack((3,), 20, gen)
    with pytest.raises(ValueError):
        k2.cholesky_inverse(a.double())
    with pytest.raises(ValueError):
        k2.cholesky_inverse(a.mT)
    with pytest.raises(ValueError):
        k2.cholesky_inverse(spd_stack((2,), 65, gen))
