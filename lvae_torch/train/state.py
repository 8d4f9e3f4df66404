"""GP parameter state (port of the serving part of lvae_tpu.train.state).

Only what serving reads is here: :class:`GPParams`, :func:`init_gp_params`
and :func:`init_inducing_points`. The optimizer state comes with training.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from lvae_torch.ops import kernels as kx


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
