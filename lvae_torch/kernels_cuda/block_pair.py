"""The per-subject block stacks of both kernel specs in one pass: CUDA kernel
K4, its plain version and its gradient.

K4 (``lvae_torch/csrc/block_pair.cu``) replaces the Pallas TPU kernel
``lvae_tpu/kernels_pallas/kernel_matrix.py:_block_pair_pallas``: from
constrained ``scale``/``g = 1/(2ℓ²)`` of spec0 ``[L, C0]`` and spec1
``[L, C1]``, covariates ``xb [S, T, Q]`` and the mask ``[S, T]`` it writes the
masked blocks ``K0 [L, S, T, T]`` and ``K1 [L, S, T, T]``. The source's head
note gives its bound and design.

* :func:`block_pair` — the forward: the kernel for a CUDA tensor (f32,
  contiguous, both specs within the component table; anything else raises),
  the plain version for a CPU tensor. Its launch geometry is
  ``km_plan.k4_plan``: a flat walk over the ``S·T·T`` plane, four entries
  of one latent a thread.
* :func:`block_pair_reference` — the plain PyTorch version, the two
  ``masked_block_stack`` calls.
* :class:`BlockPair` — the ``autograd.Function``; its backward is the port of
  ``_block_pair_bwd_impl``: ``block_param_grads`` once per spec, none for the
  covariates or the mask.
* :func:`block_kernel_pair` — raw parameters in, both stacks in ``xb``'s
  dtype: the counterpart of ``block_kernel_pair_pallas``, which
  ``ops/elbo.gp_block_operators`` runs on the K4 route.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from lvae_torch.kernels_cuda import build
from lvae_torch.kernels_cuda import km_plan as kp
from lvae_torch.kernels_cuda.kernel_matrix import (
    block_param_grads, fits, masked_block_stack, table_array,
)
from lvae_torch.ops import kernels as kx
from lvae_torch.ops import linalg as la

SOURCE = "lvae_torch/csrc/block_pair.cu"
REPLACES = "lvae_tpu/kernels_pallas/kernel_matrix.py:254"  # _block_pair_pallas

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("block_pair").lvae_block_pair_f32
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
            ctypes.POINTER(ctypes.c_int), *[ctypes.c_int] * 5, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def usable(spec0: kx.KernelSpec, spec1: kx.KernelSpec, kp0: kx.KernelParams,
           xb: torch.Tensor) -> bool:
    """Shape and dtype gate of the K4 route (``ops/elbo.py:193-200`` in the
    JAX package): f32, ``[L, C]`` parameters, both specs non-empty and within
    the component table, and ``S·T·T`` within the kernel's 32-bit flat index
    (it stages nothing in shared memory). The JAX gate's ``L·S·T²·4 <= 2
    MB`` is the TPU's VMEM budget for a grid-less Pallas call; the CUDA
    kernel has a grid, so it has no such limit. The caller adds that ``xb``
    lies on a CUDA device."""
    return (
        xb.dtype == torch.float32
        and kp0.raw_scale.ndim == 2
        and fits(spec0)
        and fits(spec1)
        and kp.k4_fits(xb.shape[0], xb.shape[1])
    )


def block_pair_reference(spec0, spec1, s0, g0, s1, g1, xb, mask):
    """Plain PyTorch version: ``(K0, K1)``, each ``[L, S, T, T]`` in ``xb``'s
    dtype."""
    mm3 = mask[:, :, None] * mask[:, None, :]
    return (masked_block_stack(spec0, s0, g0, xb, mm3),
            masked_block_stack(spec1, s1, g1, xb, mm3))


def _check(name: str, t: torch.Tensor, shape, device) -> None:
    if t.device != device or t.dtype != torch.float32:
        raise ValueError(f"block_pair kernel: {name} must be float32 on {device}, got "
                         f"{t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"block_pair kernel: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"block_pair kernel: {name} must be contiguous")


def block_pair(spec0, spec1, s0, g0, s1, g1, xb, mask) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(K0, K1)`` from CONSTRAINED parameters (no gradient).

    CPU tensors: the plain version. CUDA tensors: the kernel, which takes f32
    contiguous inputs and specs that fit its component table; anything else
    raises."""
    if xb.device.type == "cpu":
        return block_pair_reference(spec0, spec1, s0, g0, s1, g1, xb, mask)
    if not xb.is_cuda:
        raise ValueError(f"block_pair: unsupported device {xb.device}")
    if xb.ndim != 3:
        raise ValueError(f"block_pair kernel needs xb [S, T, Q], got {tuple(xb.shape)}")
    n_subj, t, q = xb.shape
    table_array(spec0, spec1)  # raises on a spec the table cannot hold
    c0, c1 = len(spec0.components), len(spec1.components)
    if c0 == 0 or c1 == 0:
        raise ValueError("block_pair kernel needs two non-empty specs")
    n_lat = s0.shape[0]
    dev = xb.device
    for name, arr, shape in (
        ("s0", s0, (n_lat, c0)), ("g0", g0, (n_lat, c0)), ("s1", s1, (n_lat, c1)),
        ("g1", g1, (n_lat, c1)), ("xb", xb, (n_subj, t, q)), ("mask", mask, (n_subj, t)),
    ):
        _check(name, arr, shape, dev)
    # raises beyond the 32-bit flat index or the grid
    plan = kp.k4_plan(n_lat, n_subj, t)
    return _launch(spec0, spec1, s0, g0, s1, g1, xb, mask, plan)


def _launch(spec0, spec1, s0, g0, s1, g1, xb, mask, plan: kp.K4Plan):
    """The kernel on checked inputs with the launch plan ``plan``;
    :func:`block_pair` passes its own plan, the card tests another (scalar
    stores on a plane that takes 16-byte ones)."""
    n_subj, t, q = xb.shape
    n_lat = s0.shape[0]
    k0 = torch.empty((n_lat, n_subj, t, t), dtype=torch.float32, device=xb.device)
    k1 = torch.empty_like(k0)
    if k0.numel() == 0:
        return k0, k1
    fn = _kernel()
    with torch.cuda.device(xb.device):
        stream = torch.cuda.current_stream(xb.device).cuda_stream
        err = fn(s0.data_ptr(), g0.data_ptr(), s1.data_ptr(), g1.data_ptr(), xb.data_ptr(),
                 mask.data_ptr(), k0.data_ptr(), k1.data_ptr(), n_lat, n_subj, t, q,
                 table_array(spec0, spec1),
                 len(spec0.components), len(spec1.components), int(plan.vec), plan.blocks,
                 plan.latents, stream)
    if err != 0:
        raise RuntimeError(f"block_pair kernel launch failed: cudaError {err} (plan {plan})")
    block_pair.launches += 1
    return k0, k1


block_pair.launches = 0


class BlockPair(torch.autograd.Function):
    """Differentiable in (s0, g0, s1, g1); the covariates and the mask are
    data and get no gradient, as in the JAX package.

    Forward: :func:`block_pair` (the kernel on CUDA, the plain version on the
    CPU). Backward: ``block_param_grads`` once per spec under
    ``full_precision()``, which autograd runs after the forward's own
    precision block has exited."""

    @staticmethod
    def forward(ctx, spec0, spec1, s0, g0, s1, g1, xb, mask):
        k0, k1 = block_pair(spec0, spec1, s0, g0, s1, g1, xb, mask)
        ctx.specs = (spec0, spec1)
        ctx.save_for_backward(s0, g0, s1, g1, xb, mask)
        ctx.set_materialize_grads(False)
        return k0, k1

    @staticmethod
    def backward(ctx, cot0, cot1):
        spec0, spec1 = ctx.specs
        s0, g0, s1, g1, xb, mask = ctx.saved_tensors
        mm3 = mask[:, :, None] * mask[:, None, :]
        d_s0 = d_g0 = d_s1 = d_g1 = None
        with la.full_precision():
            if cot0 is not None:
                d_s0, d_g0 = block_param_grads(spec0, s0, g0, cot0, xb, mm3)
            if cot1 is not None:
                d_s1, d_g1 = block_param_grads(spec1, s1, g1, cot1, xb, mm3)
        return None, None, d_s0, d_g0, d_s1, d_g1, None, None


def block_kernel_pair(spec0, spec1, kp0: kx.KernelParams, kp1: kx.KernelParams,
                      xb: torch.Tensor, mask: torch.Tensor):
    """``(K0, K1)`` in ``xb``'s dtype from RAW kernel parameters
    (``block_kernel_pair_pallas``): constrain, run :class:`BlockPair`, cast."""

    def cg(kp):
        scale = kx.constrain(kp.raw_scale)
        ls = kx.constrain(kp.raw_lengthscale)
        return scale.contiguous(), (0.5 / (ls * ls)).contiguous()

    k0, k1 = BlockPair.apply(spec0, spec1, *cg(kp0), *cg(kp1), xb.contiguous(),
                             mask.to(xb.dtype).contiguous())
    return k0.to(xb.dtype), k1.to(xb.dtype)
