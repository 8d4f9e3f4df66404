"""Batched Cholesky helpers used by the GP algebra (port of lvae_tpu.ops.linalg).

All functions broadcast over arbitrary leading batch dims. Unlike
``torch.linalg.cholesky``, :func:`cholesky` does not raise on a matrix that is
not positive definite: the failed factor is NaN, as ``jnp.linalg.cholesky``
gives it, so a serving call never synchronises on an error check and callers
see the failure in the numbers.

:func:`cholesky_and_inverse` is the one entry to the batched Cholesky+inverse
kernel (``lvae_torch/kernels_cuda/cholesky.py``, CUDA): a CUDA f32 stack with
``2 <= n <= 64`` launches it, every other dtype or size takes the plain
``torch.linalg`` path, as the JAX package sends those to XLA, and a CPU
tensor takes the plain path. On every device it is differentiable through
one ``autograd.Function`` whose backward is the JAX package's
``kernels_pallas/cholesky.py:_chol_inv_bwd`` (plain tensor algebra in both).
"""

from __future__ import annotations

import contextlib
import functools

import torch

KERNEL_MIN_N = 2
KERNEL_MAX_N = 64


@contextlib.contextmanager
def full_precision():
    """Run f32 matmuls and convolutions without TF32 inside the block.

    The counterpart of ``lvae_tpu.ops.elbo._full_precision``: the GP algebra
    (inverse-space updates, Cholesky chains) loses its conditioning at
    reduced matmul precision, and the VAE's convolutions are held to full f32
    so that the card's results can be compared with the CPU's. The flags are
    process-wide; the previous values are restored on exit.
    """
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _full_precision(fn):
    """Decorator form of :func:`full_precision`."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with full_precision():
            return fn(*args, **kwargs)

    return wrapped


def _eye_like(a: torch.Tensor) -> torch.Tensor:
    n = a.shape[-1]
    return torch.eye(n, dtype=a.dtype, device=a.device)


def cholesky(a: torch.Tensor, jitter: float = 0.0) -> torch.Tensor:
    """Lower-triangular Cholesky of a batched SPD matrix (optionally
    jittered); NaN where a matrix is not positive definite."""
    if jitter:
        a = a + jitter * _eye_like(a)
    l, info = torch.linalg.cholesky_ex(a)
    return torch.where((info == 0)[..., None, None], l, torch.nan)


def solve_triangular(chol_l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``L y = b`` with ``L`` lower triangular (batched)."""
    b = b.broadcast_to(chol_l.shape[:-2] + b.shape[-2:])
    return torch.linalg.solve_triangular(chol_l, b, upper=False)


def cho_solve(chol_l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``A x = b`` given ``A = L L^T`` (batched, broadcasts ``b``)."""
    y = solve_triangular(chol_l, b)
    return torch.linalg.solve_triangular(chol_l.mT, y, upper=True)


def chol_inverse(chol_l: torch.Tensor) -> torch.Tensor:
    """Inverse of ``A`` from its Cholesky factor (batched)."""
    return cho_solve(chol_l, _eye_like(chol_l).broadcast_to(chol_l.shape))


def logdet_from_chol(chol_l: torch.Tensor, batch_dims: int = 0) -> torch.Tensor:
    """``log det A = 2 sum log diag L``, summed over all but ``batch_dims`` axes."""
    d = torch.diagonal(chol_l, dim1=-2, dim2=-1)
    dims = tuple(range(batch_dims, d.ndim))
    return 2.0 * torch.sum(torch.log(d), dim=dims)


def symmetrize(a: torch.Tensor) -> torch.Tensor:
    """0.5 (A + A^T)."""
    return 0.5 * (a + a.mT)


def cohort_gram(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``Σ_{p,t} a[l, p, t]ᵀ b[l, p, t]`` per latent: ``[L, M, N]`` from
    ``a [L, P, T, M]`` and ``b [L, P, T, N]``, accumulated in float64 and
    returned in ``a``'s dtype (float64 is unchanged).

    For ``K0zx B⁻¹ K0xz`` over a whole cohort: ``W = K0zz + K0zx B⁻¹ K0xz``
    is nearly of low rank, its small eigenvalues the jitters' (3e-4 of the
    mean diagonal), and a float32 sum over 20,000 frames on the card moves
    them by as much (a latent's W then read −0.005 and did not factor);
    summed in float64 and rounded once, W keeps them."""
    return torch.einsum("lptm,lptn->lmn", a.double(), b.double()).to(a.dtype)


def uses_kernel(a: torch.Tensor) -> bool:
    """Whether :func:`cholesky_and_inverse` sends ``a`` to the CUDA kernel:
    the shape and dtype gate of the JAX package's ``_use_pallas``."""
    n = a.shape[-1]
    return (
        a.is_cuda
        and a.dtype == torch.float32
        and KERNEL_MIN_N <= n <= KERNEL_MAX_N
    )


def _phi(x: torch.Tensor) -> torch.Tensor:
    """tril with halved diagonal (the Cholesky pullback projector)."""
    return torch.tril(x) - 0.5 * torch.tril(torch.triu(x))


class CholeskyInverse(torch.autograd.Function):
    """(cholesky(A), A⁻¹) with the JAX package's custom VJP.

    Forward: the CUDA kernel where :func:`uses_kernel` says so, else the plain
    ``torch.linalg`` path. Backward (``_chol_inv_bwd``): with L⁻¹ = LᵀA⁻¹,
    Ā = ½ L⁻ᵀ (Φ(LᵀL̄) + Φ(LᵀL̄)ᵀ) L⁻¹ (Murray 2016) − A⁻¹ Īnv A⁻¹.
    """

    @staticmethod
    def forward(ctx, a):
        if uses_kernel(a):
            from lvae_torch.kernels_cuda.cholesky import cholesky_inverse

            l, inv = cholesky_inverse(a.contiguous())
        else:
            l = cholesky(a)
            inv = chol_inverse(l)
        ctx.save_for_backward(l, inv)
        ctx.set_materialize_grads(False)
        return l, inv

    @staticmethod
    def backward(ctx, dl, dinv):
        # autograd runs this after the forward's full_precision() block has
        # exited, so the backward enters it again itself
        with full_precision():
            l, inv = ctx.saved_tensors
            da = torch.zeros_like(l)
            if dinv is not None:
                da = da - inv @ dinv @ inv
            if dl is not None:
                lt = l.mT
                l_inv = lt @ inv  # L⁻¹ = Lᵀ A⁻¹ (A symmetric)
                m = _phi(lt @ dl)
                da = da + 0.5 * (l_inv.mT @ (m + m.mT) @ l_inv)
            return da


def cholesky_and_inverse(a: torch.Tensor, jitter: float = 0.0):
    """(cholesky(A), A⁻¹) in one shot — the pair every GP bound consumes.

    Differentiable on every device (:class:`CholeskyInverse`)."""
    if jitter:
        a = a + jitter * _eye_like(a)
    return CholeskyInverse.apply(a)
