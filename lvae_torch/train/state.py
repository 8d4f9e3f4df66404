"""Training state and optimizer assembly (port of lvae_tpu.train.state).

All state of a Hensman run is one explicit :class:`HensmanState`: the
trainables (the VAE module, the GP hyperparameters, and (m, H's factor) or
learnable inducing points where the regime trains them), the natural-gradient
variational parameters, the Adam optimizer, the CPU random generator and the
step count (the standard regime's state is ``train/standard.StandardState``).
The optimizer is Adam over exactly the trainables the regime allows.
"""

from __future__ import annotations

import os
from typing import Iterator, List, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from lvae_torch.kernels_cuda.adam import FusedAdam
from lvae_torch.ops import kernels as kx
from lvae_torch.ops.linalg import full_precision


class GPParams(NamedTuple):
    """GP-prior hyperparameters (one entry per latent dim)."""

    kp0: kx.KernelParams
    kp1: kx.KernelParams
    raw_noise: torch.Tensor  # [L]

    def to(self, *args, **kwargs) -> "GPParams":
        return GPParams(
            kp0=self.kp0.to(*args, **kwargs),
            kp1=self.kp1.to(*args, **kwargs),
            raw_noise=self.raw_noise.to(*args, **kwargs),
        )

    def tensors(self) -> List[torch.Tensor]:
        return [*self.kp0, *self.kp1, self.raw_noise]

    def latents(self, sel) -> "GPParams":
        """The GPs ``sel`` (an index or slice of the latent axis), as views."""
        return GPParams(self.kp0.latents(sel), self.kp1.latents(sel), self.raw_noise[sel])


def init_gp_params(
    spec0: kx.KernelSpec,
    spec1: kx.KernelSpec,
    latent_dim: int,
    noise_init: float = kx.DEFAULT_NOISE,
    constrain_scales: bool = False,
    dtype=torch.float32,
    device=None,
) -> GPParams:
    """GP hyperparameter init: default scales and lengthscales, and noise 1
    under ``constrain_scales`` (else ``noise_init``)."""
    noise = 1.0 if constrain_scales else noise_init
    return GPParams(
        kp0=kx.init_kernel_params(spec0, latent_dim, dtype=dtype, device=device),
        kp1=kx.init_kernel_params(spec1, latent_dim, dtype=dtype, device=device),
        raw_noise=torch.full(
            (latent_dim,), float(kx.unconstrain(noise)), dtype=dtype, device=device
        ),
    )


def init_inducing_points(
    labels: np.ndarray, m_inducing: int, seed: int = 0, dtype=np.float32
) -> np.ndarray:
    """Inducing points = a random covariate subsample without replacement,
    drawn with ``numpy.random.default_rng(seed)`` (the JAX package's draw)."""
    rng = np.random.default_rng(seed)
    n = labels.shape[0]
    idx = rng.choice(n, size=min(m_inducing, n), replace=False)
    return np.asarray(labels[idx], dtype=dtype)


class Trainables(NamedTuple):
    """Everything the Adam optimizer sees; every tensor is a leaf that
    requires grad."""

    vae: nn.Module
    gp: GPParams
    m: Optional[torch.Tensor]  # [L, M, 1], only without natural gradients
    h_factor: Optional[torch.Tensor]  # [L, M, M] free factor (H = h hᵀ)
    z: Optional[torch.Tensor] = None  # [M, Q] learnable inducing points

    def parameters(self) -> Iterator[torch.Tensor]:
        """The optimizer's parameters in a fixed order: the VAE's, then kp0,
        kp1 and raw_noise, then m, h_factor and z where present."""
        yield from self.vae.parameters()
        yield from self.gp.tensors()
        for t in (self.m, self.h_factor, self.z):
            if t is not None:
                yield t


class TrainData(NamedTuple):
    """The dataset and inducing points of a run, on the run's device."""

    data: torch.Tensor  # [N, ...] frames
    labels: torch.Tensor  # [N, Q]
    pixmask: torch.Tensor  # [N, D]
    z: torch.Tensor  # [M, Q] inducing points


class HensmanState(NamedTuple):
    trainables: Trainables
    m_nat: Optional[torch.Tensor]  # [L, M, 1] with natural gradients
    H_nat: Optional[torch.Tensor]  # [L, M, M] PSD with natural gradients
    opt_state: torch.optim.Optimizer
    rng: torch.Generator  # on the CPU: the card and the CPU draw alike
    step: int


def init_variational(
    latent_dim: int, m_inducing: int, natural_gradient: bool, seed: int = 0,
    dtype=torch.float32, device=None,
):
    """(m, H) init: m ~ N(0,1), H ~ N(0,1)/10, made PSD (H Hᵀ) with natural
    gradients; the same numpy draws as the JAX package."""
    rng = np.random.default_rng(seed)
    m = rng.normal(size=(latent_dim, m_inducing, 1))
    h = rng.normal(size=(latent_dim, m_inducing, m_inducing)) / 10.0
    if natural_gradient:
        h = h @ np.swapaxes(h, -1, -2)
    return (torch.tensor(m, dtype=dtype, device=device),
            torch.tensor(h, dtype=dtype, device=device))


def psd_from_factor(h_factor: torch.Tensor) -> torch.Tensor:
    """``H = h hᵀ`` at full f32 precision (TF32 could round the product off
    the PSD cone before the Cholesky that consumes it)."""
    with full_precision():
        return h_factor @ h_factor.mT


def make_optimizer(params, learning_rate: float = 1e-3,
                   kind: Optional[str] = None) -> torch.optim.Optimizer:
    """Adam over ``params`` (in the order given). ``kind`` selects the
    implementation, by default ``$LVAE_OPT`` or ``"adam"``, as in the JAX
    package: ``"adam"`` is ``torch.optim.Adam`` with optax.adam's defaults
    (β = (0.9, 0.999), eps 1e-8 outside the square root, bias correction);
    ``"flatten"`` is the same Adam, since flattening only changed the TPU's
    layout; ``"fused"`` is :class:`~lvae_torch.kernels_cuda.adam.FusedAdam`,
    one launch of kernel K5 a step on the card.

    On the card ``torch.optim.Adam`` is built ``capturable``: its step count
    lives on the device, so a step captured in a CUDA graph advances it and
    its bias correction on every replay (the CPU does not support it and
    keeps the host count). A state saved on the other device loads with the
    optimizer's own setting."""
    kind = kind or os.environ.get("LVAE_OPT", "adam")
    params = list(params)
    if kind in ("adam", "flatten"):
        capturable = bool(params) and params[0].is_cuda
        opt = torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                               capturable=capturable)
        opt.register_load_state_dict_pre_hook(_keep_capturable)
        return opt
    if kind == "fused":
        return FusedAdam(params, lr=learning_rate)
    raise ValueError(f"unknown optimizer kind {kind!r}")


def _keep_capturable(optimizer: torch.optim.Optimizer, state_dict: dict) -> dict:
    """``state_dict`` with each group's ``capturable`` set to the live
    optimizer's: Adam reads the saved flag, and a card's (capturable) state
    would otherwise refuse to step on the CPU, a CPU's refuse a capture."""
    groups = [dict(saved, capturable=live["capturable"])
              for saved, live in zip(state_dict["param_groups"], optimizer.param_groups)]
    return {**state_dict, "param_groups": groups}


def zero_missing_grads(params) -> List[torch.Tensor]:
    """``params`` as a list, each that has no gradient given a zero one: a
    tensor the loss does not reach (raw_noise under constrain_scales or in
    the GPPVAE regime, a frozen raw_log_vy) then advances its Adam moments
    and step count with the others, as in optax."""
    params = list(params)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    return params


def tree_finite(tensors) -> torch.Tensor:
    """A device boolean: every tensor in ``tensors`` (an iterable, or
    :class:`Trainables`) is finite. No host synchronisation."""
    if isinstance(tensors, Trainables):
        tensors = tensors.parameters()
    flags = [torch.isfinite(t).all() for t in tensors]
    return torch.stack(flags).all()
