"""The additive kernel matrix: CUDA kernel K3, its plain version and its
gradient; and the masked per-subject block helpers of the B-chain.

K3 (``lvae_torch/csrc/kernel_matrix.cu``) replaces the Pallas TPU kernel
``lvae_tpu/kernels_pallas/kernel_matrix.py:_kernel_matrix_pallas``: from
constrained ``scale`` and ``g = 1/(2ℓ²)`` ``[L, C]`` and covariates
``x1 [N1, Q]``, ``x2 [N2, Q]`` it writes ``K [L, N1, N2]`` in one pass. The
source's head note gives its bound and design.

* :func:`kernel_matrix_fused` — the forward: the kernel for a CUDA tensor
  (f32, contiguous, a spec within the component table; anything else
  raises), the plain version for a CPU tensor. Its launch geometry is
  ``km_plan.k3_plan``: the symmetric walk (tiles ``I >= J``, each
  off-diagonal tile also stored transposed) when ``x1`` and ``x2`` are one
  tensor, the general walk otherwise, with bit-equal results.
* :func:`kernel_matrix_reference` — the plain PyTorch version.
* :class:`FusedKernelMatrix` — the ``autograd.Function``; its backward is
  the port of ``_fused_bwd_impl``: analytic (d scale, d g), plain tensor
  algebra as in JAX, none for the covariates.
* :func:`kernel_matrix_kernel` — raw parameters in, ``K`` in ``x1``'s dtype
  with optional row/column masks: the counterpart of ``kernel_matrix_pallas``,
  which ``ops/kernels.kernel_matrix`` calls inside :func:`usable`'s shapes.
* :func:`spec_table` — the int component table that K1, K3 and K4 take;
  :func:`table_array` the cached ctypes array of it.

:func:`masked_block_stack` rebuilds the masked ``K [L, S, T, T]`` blocks and
:func:`block_param_grads` maps a cotangent of those blocks to the
constrained parameters: the B-chain backward (``kernels_cuda/b_chain.py``)
uses both.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Tuple

import torch

from lvae_torch.kernels_cuda import build
from lvae_torch.kernels_cuda import km_plan as kp
from lvae_torch.ops import kernels as kx
from lvae_torch.ops import linalg as la

SOURCE = "lvae_torch/csrc/kernel_matrix.cu"
REPLACES = "lvae_tpu/kernels_pallas/kernel_matrix.py:97"  # _kernel_matrix_pallas

# the component table of csrc/component.cuh (kMaxComponents per spec,
# kMaxEq, kMaxAnd)
MAX_COMPONENTS, MAX_EQ, MAX_AND = 16, 4, 4
MIN_N = 512  # the JAX package's gate: square evaluations from 512 x 512

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("kernel_matrix").lvae_kernel_matrix_f32
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
            ctypes.POINTER(ctypes.c_int), *[ctypes.c_int] * 7, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def fits(spec: kx.KernelSpec) -> bool:
    """Whether ``spec`` is non-empty and fits one spec's rows of the table."""
    return 0 < len(spec.components) <= MAX_COMPONENTS and all(
        len(c.eq_cols) <= MAX_EQ and len(c.and_cols) <= MAX_AND for c in spec.components
    )


def spec_table(*specs: kx.KernelSpec) -> List[int]:
    """The kernels' component table: one row of ints per component, the
    specs' components in order (``rbf_col, n_eq, eq…, n_and, and…, cat_col,
    cat_num``, unused slots 0). Raises ``ValueError`` on a spec the table
    cannot hold."""
    if not all(fits(spec) for spec in specs):
        raise ValueError(
            f"the CUDA kernels take 1..{MAX_COMPONENTS} components per spec with "
            f"at most {MAX_EQ} equality and {MAX_AND} both-one columns each"
        )
    rows: List[int] = []
    for spec in specs:
        for comp in spec.components:
            eq = list(comp.eq_cols) + [0] * (MAX_EQ - len(comp.eq_cols))
            both = list(comp.and_cols) + [0] * (MAX_AND - len(comp.and_cols))
            rows += [comp.rbf_col, len(comp.eq_cols), *eq, len(comp.and_cols), *both,
                     comp.cat_mod[0], comp.cat_mod[1]]
    return rows


@functools.lru_cache(maxsize=64)
def table_array(*specs: kx.KernelSpec):
    """The specs' component table as the ctypes array the entry points
    read, built once per tuple of specs."""
    table = spec_table(*specs)
    return (ctypes.c_int * len(table))(*table)


def usable(spec: kx.KernelSpec, params: kx.KernelParams, x1: torch.Tensor,
           x2: torch.Tensor) -> bool:
    """Shape and dtype gate of K3 (``ops/kernels.py:216-228`` in the JAX
    package): f32, ``[L, C]`` parameters, ``[N, Q]`` covariates without
    batch dims, ``N1, N2 >= 512``, a non-empty spec within the table and
    parameters that fit a block's shared memory beside its tile (either
    walk of ``km_plan``). The caller adds that ``x1`` lies on a CUDA
    device."""
    return (
        x1.dtype == torch.float32
        and params.raw_scale.ndim == 2
        and x1.ndim == 2
        and x2.ndim == 2
        and x1.shape[0] >= MIN_N
        and x2.shape[0] >= MIN_N
        and fits(spec)
        and kp.k3_fits(params.raw_scale.shape[0], len(spec.components), x1.shape[1])
    )


def kernel_matrix_reference(spec: kx.KernelSpec, scale: torch.Tensor, g: torch.Tensor,
                            x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``K [L, N1, N2]`` in ``x1``'s dtype from
    CONSTRAINED ``scale``/``g`` ``[L, C]`` (``ops/kernels``' evaluation)."""
    return kx.additive_stack(spec, scale.to(x1.dtype), g.to(x1.dtype), x1, x2)


def _check(name: str, t: torch.Tensor, shape, device) -> None:
    if t.device != device or t.dtype != torch.float32:
        raise ValueError(f"kernel_matrix kernel: {name} must be float32 on {device}, "
                         f"got {t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"kernel_matrix kernel: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"kernel_matrix kernel: {name} must be contiguous")


def kernel_matrix_fused(spec: kx.KernelSpec, scale: torch.Tensor, g: torch.Tensor,
                        x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """``K [L, N1, N2]`` from CONSTRAINED parameters (no gradient).

    CPU tensors: the plain version. CUDA tensors: the kernel, which takes f32
    contiguous inputs and a spec within the component table; anything else
    raises. When ``x1`` and ``x2`` are one tensor (:func:`km_plan.same_storage`)
    the kernel walks the symmetric tiles only; a copy takes the general walk,
    with bit-equal results."""
    if x1.device.type == "cpu":
        return kernel_matrix_reference(spec, scale, g, x1, x2)
    if not x1.is_cuda:
        raise ValueError(f"kernel_matrix: unsupported device {x1.device}")
    if x1.ndim != 2 or x2.ndim != 2 or scale.ndim != 2:
        raise ValueError("kernel_matrix kernel needs x1 [N1, Q], x2 [N2, Q] and [L, C] "
                         f"parameters, got {tuple(x1.shape)}, {tuple(x2.shape)}, "
                         f"{tuple(scale.shape)}")
    table_array(spec)  # raises on a spec the table cannot hold
    n_lat, c = scale.shape
    (n1, q), n2 = x1.shape, x2.shape[0]
    if c != len(spec.components):
        raise ValueError(f"kernel_matrix kernel: {c} parameter columns for "
                         f"{len(spec.components)} components")
    dev = x1.device
    for name, arr, shape in (("scale", scale, (n_lat, c)), ("g", g, (n_lat, c)),
                             ("x1", x1, (n1, q)), ("x2", x2, (n2, q))):
        _check(name, arr, shape, dev)
    # raises where shared memory or the grid cannot hold the problem
    plan = kp.k3_plan(n_lat, n1, n2, q, c, kp.same_storage(x1, x2))
    return _launch(spec, scale, g, x1, x2, plan)


def _launch(spec: kx.KernelSpec, scale: torch.Tensor, g: torch.Tensor, x1: torch.Tensor,
            x2: torch.Tensor, plan: kp.K3Plan) -> torch.Tensor:
    """The kernel on checked inputs with the launch plan ``plan``;
    :func:`kernel_matrix_fused` passes its own plan, the card tests others
    (the scalar stores on a row that takes 16-byte ones)."""
    n_lat, c = scale.shape
    (n1, q), n2 = x1.shape, x2.shape[0]
    out = torch.empty((n_lat, n1, n2), dtype=torch.float32, device=x1.device)
    if out.numel() == 0:
        return out
    fn = _kernel()
    with torch.cuda.device(x1.device):
        stream = torch.cuda.current_stream(x1.device).cuda_stream
        err = fn(scale.data_ptr(), g.data_ptr(), x1.data_ptr(), x2.data_ptr(),
                 out.data_ptr(), n_lat, n1, n2, q, table_array(spec), c, int(plan.symmetric),
                 int(plan.vec), plan.grid_x, plan.grid_y, plan.smem, plan.bucket, stream)
    if err != 0:
        raise RuntimeError(f"kernel_matrix kernel launch failed: cudaError {err} (plan {plan})")
    kernel_matrix_fused.launches += 1
    return out


kernel_matrix_fused.launches = 0


def kernel_matrix_backward(spec: kx.KernelSpec, scale: torch.Tensor, g: torch.Tensor,
                           x1: torch.Tensor, x2: torch.Tensor,
                           cot: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(d scale, d g), each ``[L, C]``, of ``Σ cot ⊙ K(scale, g)``
    (``_fused_bwd_impl``). Each RBF component's ``[L, N1, N2]`` factor is
    built in place and dropped before the next, so at most one exists."""
    n_lat = scale.shape[0]
    ds, dg = [], []
    for c, comp in enumerate(spec.components):
        disc, sqd = kx._component_base(comp, x1, x2)
        if sqd is not None:
            ke = torch.exp(-sqd[None] * g[:, c, None, None])
            if disc is not None:
                ke.mul_(disc)
            ds.append(torch.einsum("lnm,lnm->l", cot, ke))
            ke.mul_(sqd)
            dg.append(-torch.einsum("lnm,lnm->l", cot, ke) * scale[:, c])
            del ke
        else:
            base = disc if disc is not None else torch.ones_like(cot[0])
            ds.append(torch.einsum("lnm,nm->l", cot, base))
            dg.append(torch.zeros(n_lat, dtype=scale.dtype, device=scale.device))
    return torch.stack(ds, dim=1).to(scale.dtype), torch.stack(dg, dim=1).to(g.dtype)


class FusedKernelMatrix(torch.autograd.Function):
    """Differentiable in (scale, g); the covariates are data and get no
    gradient, as in the JAX package.

    Forward: :func:`kernel_matrix_fused` (the kernel on CUDA, the plain
    version on the CPU). Backward: :func:`kernel_matrix_backward` under
    ``full_precision()``, which autograd runs after the forward's own
    precision block has exited."""

    @staticmethod
    def forward(ctx, spec, scale, g, x1, x2):
        out = kernel_matrix_fused(spec, scale, g, x1, x2)
        ctx.spec = spec
        ctx.save_for_backward(scale, g, x1, x2)
        ctx.set_materialize_grads(False)
        return out

    @staticmethod
    def backward(ctx, cot):
        if cot is None:
            return None, None, None, None, None
        with la.full_precision():
            d_scale, d_g = kernel_matrix_backward(ctx.spec, *ctx.saved_tensors, cot)
        return None, d_scale, d_g, None, None


def kernel_matrix_kernel(spec: kx.KernelSpec, params: kx.KernelParams, x1: torch.Tensor,
                         x2: torch.Tensor, mask1=None, mask2=None) -> torch.Tensor:
    """``K [L, N1, N2]`` in ``x1``'s dtype from RAW parameters ``[L, C]``:
    constrain, run the kernel (:class:`FusedKernelMatrix`), cast, and zero
    the rows and columns of ``mask1 [N1]``/``mask2 [N2]``
    (``kernel_matrix_pallas``)."""
    scale = kx.constrain(params.raw_scale)
    ls = kx.constrain(params.raw_lengthscale)
    g = 0.5 / (ls * ls)
    x1c = x1.contiguous()
    # one tensor stays one (copied once), so the kernel sees K(X, X) as symmetric
    x2c = x1c if kp.same_storage(x1, x2) else x2.contiguous()
    out = FusedKernelMatrix.apply(spec, scale.contiguous(), g.contiguous(), x1c, x2c)
    dtype = x1.dtype
    out = out.to(dtype)
    if mask1 is not None:
        out = out * mask1.to(dtype)[:, None]
    if mask2 is not None:
        out = out * mask2.to(dtype)[None, :]
    return out


# ------------------------------------------------- per-subject block helpers
def _bases(comp: kx.KernelComponent, xf: torch.Tensor, mm3: torch.Tensor):
    """(masked discrete base [S, T, T], squared distance [S, T, T] or None)."""
    disc, sqd = kx._component_base(comp, xf, xf)
    base = disc if disc is not None else torch.ones_like(mm3)
    return base * mm3, sqd


def masked_block_stack(
    spec: kx.KernelSpec,
    scale: torch.Tensor,
    g: torch.Tensor,
    xf: torch.Tensor,
    mm3: torch.Tensor,
) -> torch.Tensor:
    """``K_blocks [L, S, T, T]`` from CONSTRAINED ``scale``/``g`` ``[L, C]``,
    covariates ``xf [S, T, Q]`` and the mask outer product ``mm3 [S, T, T]``;
    in ``xf``'s dtype."""
    s_dim, t_dim, _ = xf.shape
    acc = torch.zeros(
        (scale.shape[0], s_dim, t_dim, t_dim), dtype=xf.dtype, device=xf.device
    )
    for c, comp in enumerate(spec.components):
        base, sqd = _bases(comp, xf, mm3)
        sc = scale[:, c, None, None, None]
        if sqd is not None:
            term = sc * base[None] * torch.exp(-sqd[None] * g[:, c, None, None, None])
        else:
            term = sc * base[None]
        acc = acc + term
    return acc


def block_param_grads(
    spec: kx.KernelSpec,
    scale: torch.Tensor,
    g: torch.Tensor,
    cot: torch.Tensor,
    xf: torch.Tensor,
    mm3: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(d scale, d g), each ``[L, C]``, of ``Σ cot ⊙ K_blocks(scale, g)`` for
    one spec, with ``cot [L, S, T, T]``."""
    ds, dg = [], []
    for c, comp in enumerate(spec.components):
        base, sqd = _bases(comp, xf, mm3)
        if sqd is not None:
            ke = base[None] * torch.exp(-sqd[None] * g[:, c, None, None, None])
            ds.append(torch.einsum("lstu,lstu->l", cot, ke))
            dg.append(-torch.einsum("lstu,lstu->l", cot, ke * sqd[None]) * scale[:, c])
        else:
            ds.append(torch.einsum("lstu,stu->l", cot, base))
            dg.append(torch.zeros(scale.shape[0], dtype=scale.dtype, device=scale.device))
    return torch.stack(ds, dim=1).to(scale.dtype), torch.stack(dg, dim=1).to(g.dtype)
