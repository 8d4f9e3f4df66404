"""Batched small-matrix Cholesky + inverse: CUDA kernel K2 and its plain version.

The kernel (``lvae_torch/csrc/chol_inv.cu``) replaces the Pallas TPU kernel
``lvae_tpu/kernels_pallas/cholesky.py:_chol_inv_pallas``: for an f32 SPD
stack ``[..., n, n]`` with ``2 <= n <= 64`` it returns ``(L, A⁻¹)``, L lower
triangular with exact zeros above the diagonal, A⁻¹ full and symmetric. A
non-SPD block gives NaN. The source's head note gives its bound and design;
its launch geometry is ``chol_plan.chol_inv_plan``.

:func:`cholesky_inverse` takes the plain version only for a tensor on the
CPU; a CUDA tensor launches the kernel or raises. The gradient is
``ops/linalg.CholeskyInverse``, the ``autograd.Function`` that
``cholesky_and_inverse`` applies around this wrapper (the TPU kernel's VJP is
plain tensor algebra too, so there is no backward kernel).
"""

from __future__ import annotations

import ctypes

import torch

from lvae_torch.kernels_cuda import build
from lvae_torch.kernels_cuda import chol_plan as plan
from lvae_torch.ops import linalg as la

SOURCE = "lvae_torch/csrc/chol_inv.cu"
REPLACES = "lvae_tpu/kernels_pallas/cholesky.py:86"  # _chol_inv_pallas

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("chol_inv").lvae_chol_inv_f32
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            *[ctypes.c_int] * 6, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def cholesky_inverse_reference(a: torch.Tensor):
    """Plain PyTorch version: ``torch.linalg`` Cholesky, then two triangular
    solves (mirrors ``_chol_inv_reference``)."""
    l = la.cholesky(a)
    return l, la.chol_inverse(l)


def cholesky_inverse(a: torch.Tensor):
    """(cholesky(a), a⁻¹) for ``a [..., n, n]``.

    CPU tensor: the plain version. CUDA tensor: the kernel, which requires
    f32, ``2 <= n <= 64`` and a contiguous layout; anything else raises. Its
    launch geometry is ``chol_plan.chol_inv_plan`` for the card's SM count.
    """
    if a.device.type == "cpu":
        return cholesky_inverse_reference(a)
    if not a.is_cuda:
        raise ValueError(f"cholesky_inverse: unsupported device {a.device}")
    if a.dtype != torch.float32:
        raise ValueError(f"cholesky_inverse kernel takes float32, got {a.dtype}")
    if a.ndim < 2 or a.shape[-1] != a.shape[-2]:
        raise ValueError(f"cholesky_inverse needs [..., n, n], got {tuple(a.shape)}")
    n = a.shape[-1]
    if not a.is_contiguous():
        raise ValueError("cholesky_inverse kernel needs a contiguous tensor")
    # raises outside 2 <= n <= 64
    return _launch(a, plan.chol_inv_plan(n, a.numel() // (n * n), plan.num_sms(a.device)))


def _launch(a: torch.Tensor, p: plan.Plan):
    """The kernel on a checked stack ``a`` with the launch plan ``p``;
    :func:`cholesky_inverse` passes its own plan, the card tests others."""
    n = a.shape[-1]
    batch = a.numel() // (n * n)
    l = torch.empty_like(a)
    inv = torch.empty_like(a)
    if batch == 0:
        return l, inv
    fn = _kernel()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), l.data_ptr(), inv.data_ptr(), batch, n, *p, stream)
    if err != 0:
        raise RuntimeError(f"chol_inv kernel launch failed: cudaError {err} (plan {p})")
    cholesky_inverse.launches += 1
    return l, inv


cholesky_inverse.launches = 0
