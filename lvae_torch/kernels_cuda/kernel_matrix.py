"""Masked per-subject kernel blocks and their parameter gradients (plain torch).

A port of the two helpers that ``lvae_tpu/kernels_pallas/kernel_matrix.py``
shares between the custom VJPs of its Pallas kernels:
:func:`masked_block_stack` rebuilds the masked ``K [L, S, T, T]`` blocks, and
:func:`block_param_grads` maps a cotangent of those blocks to the constrained
(scale, 1/(2ℓ²)) parameters. The B-chain backward
(``kernels_cuda/b_chain.py``) uses both; so will the block-pair kernel's.
Both are built on ``ops/kernels._component_base``, the component math of the
plain kernel evaluation.
"""

from __future__ import annotations

from typing import Tuple

import torch

from lvae_torch.ops import kernels as kx


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
