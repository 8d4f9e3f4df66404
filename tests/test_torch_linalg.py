"""lvae_torch.ops.linalg and the Cholesky+inverse kernel's plain version
against lvae_tpu, on the CPU.

The same numpy inputs, made from a seed, go through both packages. The
linear-algebra helpers are compared in float64 at rtol 1e-8 (both sides call
LAPACK-grade factorisations; the difference is summation order). The plain
version of kernel K2 is held against the Pallas kernel body run in interpret
mode, in float32, at rtol 2e-4 on L and 2e-3 on A⁻¹ (the tolerances of the
JAX package's own kernel test, for an unrolled f32 factorisation).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvae_tpu.kernels_pallas.cholesky import cholesky_inverse_interpret
from lvae_tpu.ops import linalg as jla
from lvae_torch.kernels_cuda import cholesky as tk
from lvae_torch.ops import linalg as tla

RTOL64 = 1e-8


def spd_stack(rng, batch, n, dtype=np.float64):
    h = rng.normal(size=batch + (n, n)) / np.sqrt(n)
    return (h @ np.swapaxes(h, -1, -2) + 0.5 * np.eye(n)).astype(dtype)


def _both(fn_name, *arrays, **kw):
    got = getattr(tla, fn_name)(*(torch.from_numpy(a) for a in arrays), **kw)
    want = getattr(jla, fn_name)(*(jnp.asarray(a) for a in arrays), **kw)
    return got, want


def _close(got, want, rtol=RTOL64, atol=1e-12):
    if isinstance(got, tuple):
        for g, w in zip(got, want):
            _close(g, w, rtol, atol)
        return
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol)


CASES = {
    "cholesky": lambda a, l, b: (("cholesky", a), {}),
    "cholesky_jitter": lambda a, l, b: (("cholesky", a), {"jitter": 1e-3}),
    "solve_triangular": lambda a, l, b: (("solve_triangular", l, b), {}),
    "cho_solve": lambda a, l, b: (("cho_solve", l, b), {}),
    "chol_inverse": lambda a, l, b: (("chol_inverse", l), {}),
    "logdet": lambda a, l, b: (("logdet_from_chol", l), {}),
    "logdet_batch1": lambda a, l, b: (("logdet_from_chol", l), {"batch_dims": 1}),
    "symmetrize": lambda a, l, b: (("symmetrize", a + 0.1 * b[..., :1]), {}),
    "cholesky_and_inverse": lambda a, l, b: (("cholesky_and_inverse", a), {}),
    "cholesky_and_inverse_jitter": lambda a, l, b: (
        ("cholesky_and_inverse", a), {"jitter": 1e-2}
    ),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_linalg_matches_jax_f64(case):
    rng = np.random.default_rng(0)
    a = spd_stack(rng, (3, 4), 6)
    l = np.linalg.cholesky(a)
    b = rng.normal(size=(6, 2))  # broadcast over the batch dims
    (name, *arrays), kw = CASES[case](a, l, b)
    got, want = _both(name, *arrays, **kw)
    _close(got, want)


@pytest.mark.parametrize("n", [4, 20, 60])
def test_reference_matches_pallas_interpret(n):
    """The plain version of K2 equals the TPU kernel body, f32."""
    rng = np.random.default_rng(n)
    a = spd_stack(rng, (3, 5), n, dtype=np.float32)
    l_got, inv_got = tk.cholesky_inverse_reference(torch.from_numpy(a))
    l_want, inv_want = cholesky_inverse_interpret(jnp.asarray(a))
    np.testing.assert_allclose(l_got.numpy(), np.asarray(l_want), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(inv_got.numpy(), np.asarray(inv_want), rtol=2e-3, atol=2e-4)
    # the kernel's output contract, which the plain version shares
    assert (torch.triu(l_got, 1) == 0).all()
    np.testing.assert_allclose(inv_got.numpy(), inv_got.mT.numpy(), rtol=1e-5, atol=1e-6)


def test_cpu_tensor_takes_plain_version_without_launch():
    rng = np.random.default_rng(3)
    a = torch.from_numpy(spd_stack(rng, (4,), 20, dtype=np.float32))
    assert not tla.uses_kernel(a)
    before = tk.cholesky_inverse.launches
    l, inv = tk.cholesky_inverse(a)
    l2, inv2 = tla.cholesky_and_inverse(a)
    assert tk.cholesky_inverse.launches == before
    torch.testing.assert_close(l, l2, rtol=0, atol=0)
    torch.testing.assert_close(inv @ a, torch.eye(20, dtype=torch.float32).expand(4, 20, 20), rtol=0, atol=1e-4)


def test_non_spd_block_gives_nan_like_jax():
    """A failed factor is NaN (not an exception), in that block only — the
    TPU kernel's and jnp.linalg.cholesky's behaviour."""
    rng = np.random.default_rng(4)
    a = spd_stack(rng, (3,), 5)
    a[1] = -a[1]
    l, inv = tla.cholesky_and_inverse(torch.from_numpy(a))
    jl, jinv = jla.cholesky_and_inverse(jnp.asarray(a))
    assert torch.isnan(l[1]).any() and torch.isnan(inv[1]).any()
    assert np.isnan(np.asarray(jl[1])).any()
    for k in (0, 2):
        _close(l[k], jl[k])
        _close(inv[k], jinv[k])


def test_full_precision_restores_flags():
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    try:
        with tla.full_precision():
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _grad_weights(rng, shape):
    return rng.normal(size=shape), rng.normal(size=shape)


@pytest.mark.parametrize("outputs", ["both", "chol", "inverse"])
def test_cholesky_and_inverse_grad_matches_jax_f64(outputs):
    """K2's gradient (ops/linalg.CholeskyInverse) against jax.grad through
    lvae_tpu's cholesky_inverse custom VJP, f64 at rtol 1e-8; an unused
    output reaches the backward as no cotangent at all."""
    from lvae_tpu.kernels_pallas.cholesky import cholesky_inverse as j_chol_inv

    rng = np.random.default_rng(7)
    a = spd_stack(rng, (2, 3), 6)
    wl, wi = _grad_weights(rng, a.shape)
    use_l, use_i = outputs in ("both", "chol"), outputs in ("both", "inverse")

    def j_loss(x):
        l, inv = j_chol_inv(x)
        return use_l * jnp.sum(l * wl) + use_i * jnp.sum(inv * wi)

    want = np.asarray(jax.grad(j_loss)(jnp.asarray(a)))
    x = torch.tensor(a, requires_grad=True)
    l, inv = tla.cholesky_and_inverse(x)
    loss = 0.0
    if use_l:
        loss = loss + torch.sum(l * torch.from_numpy(wl))
    if use_i:
        loss = loss + torch.sum(inv * torch.from_numpy(wi))
    loss.backward()
    np.testing.assert_allclose(x.grad.numpy(), want, rtol=1e-8, atol=1e-12)


def test_cholesky_and_inverse_gradcheck():
    """Finite differences agree with the analytic backward on symmetric
    inputs (the VJP assumes A = Aᵀ, as the JAX package's does)."""
    rng = np.random.default_rng(8)
    a = torch.tensor(spd_stack(rng, (2,), 4), requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda x: tla.cholesky_and_inverse(tla.symmetrize(x), jitter=1e-3), (a,)
    )


def test_cholesky_and_inverse_backward_runs_at_full_precision(monkeypatch):
    """The backward enters full_precision() itself: autograd runs it after
    the forward's precision block has exited."""
    entered = []
    real = tla.full_precision

    def recording():
        entered.append(True)
        return real()

    monkeypatch.setattr(tla, "full_precision", recording)
    rng = np.random.default_rng(9)
    x = torch.tensor(spd_stack(rng, (2,), 5), requires_grad=True)
    _, inv = tla.cholesky_and_inverse(x)
    assert not entered
    inv.sum().backward()
    assert entered


def test_cohort_gram_sums_in_float64():
    """``K0zx B⁻¹ K0xz`` over a cohort is summed in float64 and rounded
    once: a float32 stack gives the float64 sum's float32 bits, a float64
    stack the plain einsum's."""
    rng = np.random.default_rng(7)
    a, b = (torch.from_numpy(rng.normal(size=(3, 40, 5, 6))) for _ in range(2))
    want = torch.einsum("lptm,lptn->lmn", a, b)
    assert torch.equal(tla.cohort_gram(a, b), want)
    got = tla.cohort_gram(a.float(), b.float())
    assert got.dtype == torch.float32
    assert torch.equal(got, torch.einsum("lptm,lptn->lmn", a.float().double(),
                                         b.float().double()).float())
