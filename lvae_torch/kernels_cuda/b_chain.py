"""Fused per-subject B-operator chain: CUDA kernel K1, its plain version and
its gradient.

The kernel (``lvae_torch/csrc/b_chain.cu``) replaces the Pallas TPU kernel
``lvae_tpu/kernels_pallas/b_chain.py:_b_chain_pallas``. Per (latent, subject)
block of a training batch it builds the masked K0 and K1 blocks from
constrained kernel parameters, forms ``B = K1 + diag(mask·σ² + 1 − mask)``,
factors it and returns ``(B⁻¹ [L,S,T,T], log|B| [L], tr(B⁻¹K0) [L])``. The
source's head note gives its bound and design.

* :func:`b_chain` — the forward: the kernel for a CUDA tensor (f32,
  ``2 <= T <= 128``, both specs non-empty and within the kernel's component
  table; anything else raises), the plain version for a CPU tensor.
* :func:`b_chain_reference` — the plain PyTorch version.
* :class:`BChain` — the ``autograd.Function``; its backward is the port of
  ``_b_chain_bwd_impl``, plain tensor algebra as in JAX.
* :func:`b_chain_operators` — raw kernel parameters in, the three outputs in
  ``xb``'s dtype; :func:`usable` — the shape and dtype gate that
  ``ops/elbo.gp_block_operators`` consults (with the CUDA check beside it).
"""

from __future__ import annotations

import ctypes

import torch

from lvae_torch.kernels_cuda import build
from lvae_torch.kernels_cuda import chol_plan as plan
from lvae_torch.kernels_cuda.kernel_matrix import (  # noqa: F401  (table limits re-exported)
    MAX_AND, MAX_COMPONENTS, MAX_EQ, block_param_grads, fits, masked_block_stack, spec_table,
    table_array,
)
from lvae_torch.ops import kernels as kx
from lvae_torch.ops import linalg as la

SOURCE = "lvae_torch/csrc/b_chain.cu"
REPLACES = "lvae_tpu/kernels_pallas/b_chain.py:227"  # _b_chain_pallas

MIN_T, MAX_T = plan.K1_MIN_T, plan.K1_MAX_T

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("b_chain").lvae_b_chain_f32
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [
            ctypes.POINTER(ctypes.c_int), *[ctypes.c_int] * 7, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def usable(spec0: kx.KernelSpec, spec1: kx.KernelSpec, kp0: kx.KernelParams,
           xb: torch.Tensor) -> bool:
    """Shape and dtype gate of the kernel (``b_chain.py:usable``): f32,
    ``2 <= T <= 128``, ``[L, C]`` parameters, both specs non-empty and within
    the component table. The caller adds that ``xb`` lies on a CUDA device."""
    return (
        xb.dtype == torch.float32
        and kp0.raw_scale.ndim == 2
        and fits(spec0)
        and fits(spec1)
        and MIN_T <= xb.shape[1] <= MAX_T
    )


def b_chain_reference(spec0, spec1, s0, g0, s1, g1, noise, xb, mask):
    """Plain PyTorch version, in ``xb``'s dtype: masked block stacks → B →
    Cholesky and inverse (``torch.linalg``) → log|B| → tr(B⁻¹K0)."""
    mm3 = mask[:, :, None] * mask[:, None, :]
    k1 = masked_block_stack(spec1, s1, g1, xb, mm3)
    diag = mask[None] * noise[:, None, None] + (1.0 - mask)[None]
    lb = la.cholesky(k1 + torch.diag_embed(diag))
    ib = la.chol_inverse(lb)
    logdet = la.logdet_from_chol(lb, batch_dims=1)
    k0 = masked_block_stack(spec0, s0, g0, xb, mm3)
    tr = torch.einsum("lstu,lstu->l", ib, k0)
    return ib, logdet, tr


_table = table_array  # the specs' ctypes table, built once per pair (shared with K3, K4)


def _check(name: str, t: torch.Tensor, shape, device) -> None:
    if t.device != device or t.dtype != torch.float32:
        raise ValueError(f"b_chain kernel: {name} must be float32 on {device}, got "
                         f"{t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"b_chain kernel: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"b_chain kernel: {name} must be contiguous")


def b_chain(spec0, spec1, s0, g0, s1, g1, noise, xb, mask):
    """(B⁻¹, log|B|, tr(B⁻¹K0)) from CONSTRAINED parameters (no gradient).

    CPU tensors: the plain version. CUDA tensors: the kernel, which takes
    f32 contiguous inputs with ``2 <= T <= 128`` and specs that fit its
    component table; anything else raises. Its launch geometry is
    ``chol_plan.b_chain_plan`` for the card's SM count."""
    if xb.device.type == "cpu":
        return b_chain_reference(spec0, spec1, s0, g0, s1, g1, noise, xb, mask)
    if not xb.is_cuda:
        raise ValueError(f"b_chain: unsupported device {xb.device}")
    if xb.ndim != 3:
        raise ValueError(f"b_chain kernel needs xb [S, T, Q], got {tuple(xb.shape)}")
    n_subj, t, q = xb.shape
    if not MIN_T <= t <= MAX_T:
        raise ValueError(f"b_chain kernel takes {MIN_T} <= T <= {MAX_T}, got T={t}")
    c0, c1 = len(spec0.components), len(spec1.components)
    n_lat = s0.shape[0]
    dev = xb.device
    for name, arr, shape in (
        ("s0", s0, (n_lat, c0)), ("g0", g0, (n_lat, c0)), ("s1", s1, (n_lat, c1)),
        ("g1", g1, (n_lat, c1)), ("noise", noise, (n_lat,)), ("xb", xb, (n_subj, t, q)),
        ("mask", mask, (n_subj, t)),
    ):
        _check(name, arr, shape, dev)
    p = plan.b_chain_plan(t, n_lat * n_subj, q, plan.num_sms(dev))
    return _launch(spec0, spec1, s0, g0, s1, g1, noise, xb, mask, p)


def _launch(spec0, spec1, s0, g0, s1, g1, noise, xb, mask, p: plan.Plan):
    """The kernel on checked inputs with the launch plan ``p``;
    :func:`b_chain` passes its own plan, the card tests others."""
    table = _table(spec0, spec1)  # raises on a spec the table cannot hold
    n_lat, (n_subj, t, q), dev = s0.shape[0], xb.shape, xb.device
    ib = torch.empty((n_lat, n_subj, t, t), dtype=torch.float32, device=dev)
    logdet = torch.empty((n_lat, n_subj), dtype=torch.float32, device=dev)
    tr = torch.empty((n_lat, n_subj), dtype=torch.float32, device=dev)
    if n_lat * n_subj == 0:
        return ib, logdet.sum(1), tr.sum(1)
    fn = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            s0.data_ptr(), g0.data_ptr(), s1.data_ptr(), g1.data_ptr(), noise.data_ptr(),
            xb.data_ptr(), mask.data_ptr(), ib.data_ptr(), logdet.data_ptr(), tr.data_ptr(),
            n_lat, n_subj, t, q, table, len(spec0.components), len(spec1.components), *p, stream,
        )
    if err != 0:
        raise RuntimeError(f"b_chain kernel launch failed: cudaError {err} (plan {p})")
    b_chain.launches += 1
    return ib, logdet.sum(1), tr.sum(1)


b_chain.launches = 0


def b_chain_backward(spec0, spec1, s0, g0, s1, g1, noise, xb, mask, ib,
                     d_ib, d_logdet, d_tr):
    """Cotangents of (s0, g0, s1, g1, noise) from those of the three outputs
    (``_b_chain_bwd_impl``; ``None`` for an unused output):
    dB = d_logdet·B⁻¹ − B⁻¹(Ḡ + d_tr·K0)B⁻¹, dK0 = d_tr·B⁻¹, dσ² = Σ diag(dB)·mask."""
    mm3 = mask[:, :, None] * mask[:, None, :]
    n_lat = ib.shape[0]
    zeros = torch.zeros((n_lat,), dtype=ib.dtype, device=ib.device)
    d_ib = torch.zeros((), dtype=ib.dtype, device=ib.device) if d_ib is None else d_ib
    d_logdet = (zeros if d_logdet is None else d_logdet)[:, None, None, None]
    d_tr = (zeros if d_tr is None else d_tr)[:, None, None, None]
    k0m = masked_block_stack(spec0, s0, g0, xb, mm3)
    db = d_logdet * ib - ib @ ((d_ib + d_tr * k0m) @ ib)
    d_s0, d_g0 = block_param_grads(spec0, s0, g0, d_tr * ib, xb, mm3)
    d_s1, d_g1 = block_param_grads(spec1, s1, g1, db, xb, mm3)
    d_noise = torch.einsum("lstt,st->l", db, mask).to(noise.dtype)
    return d_s0, d_g0, d_s1, d_g1, d_noise


class BChain(torch.autograd.Function):
    """Differentiable in (s0, g0, s1, g1, noise); covariates and mask are data.

    Forward: :func:`b_chain` (the kernel on CUDA, the plain version on the
    CPU). Backward: :func:`b_chain_backward` under ``full_precision()``,
    which autograd runs after the forward's own precision block has exited."""

    @staticmethod
    def forward(ctx, spec0, spec1, s0, g0, s1, g1, noise, xb, mask):
        ib, logdet, tr = b_chain(spec0, spec1, s0, g0, s1, g1, noise, xb, mask)
        ctx.specs = (spec0, spec1)
        ctx.save_for_backward(s0, g0, s1, g1, noise, xb, mask, ib)
        ctx.set_materialize_grads(False)
        return ib, logdet, tr

    @staticmethod
    def backward(ctx, d_ib, d_logdet, d_tr):
        with la.full_precision():
            grads = b_chain_backward(*ctx.specs, *ctx.saved_tensors, d_ib, d_logdet, d_tr)
        return (None, None, *grads, None, None)


def b_chain_operators(spec0, spec1, kp0, kp1, noise, xb, mask):
    """(B⁻¹, log|B| [L], tr(B⁻¹K0) [L]) in ``xb``'s dtype from RAW kernel
    parameters (``b_chain.py:b_chain_operators``)."""

    def cg(kp):
        scale = kx.constrain(kp.raw_scale)
        ls = kx.constrain(kp.raw_lengthscale)
        return scale, 0.5 / (ls * ls)

    s0, g0 = cg(kp0)
    s1, g1 = cg(kp1)
    dtype = xb.dtype
    ib, logdet, tr = BChain.apply(
        spec0, spec1, s0.contiguous(), g0.contiguous(), s1.contiguous(), g1.contiguous(),
        noise.contiguous(), xb.contiguous(), mask.to(dtype).contiguous(),
    )
    return ib.to(dtype), logdet.to(dtype), tr.to(dtype)
