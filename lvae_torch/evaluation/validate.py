"""Validation loss: reconstruction + the batched GP term (port of
lvae_tpu.evaluation.validate).

Encode the validation cohort, sum the reconstruction and NLL losses of one
reparameterised sample, add the GP KL over all latent dims and combine them
per the loss function. The GP term is the deviance upper bound (DUBO) in
every regime but ``GPapprox``, where it is the mean over ``num_samples``
latent samples of −Σ ``gp_elbo``. The summary line is the reference's.

Noise: the encoder's reparameterisation noise ``[N, L]`` and the GPapprox
samples' noise ``[num_samples, P, T, L]`` are drawn, in that order, from a
CPU generator (seeded 0 unless one is given) and moved to the device, or
injected.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from lvae_torch.data.blocks import build_subject_blocks
from lvae_torch.evaluation.encode import vae_forward
from lvae_torch.models import vae as mv
from lvae_torch.ops import elbo as eb
from lvae_torch.utils.device import resolve_device


class ValidationResult(NamedTuple):
    net: float
    gp: float
    nll: float
    recon: float


def on_device(a, dtype, device) -> torch.Tensor:
    """A numpy array or a tensor as a tensor of ``dtype`` on ``device``."""
    return torch.as_tensor(a if isinstance(a, torch.Tensor) else np.asarray(a),
                           dtype=dtype, device=device)


def draw_noise(shape, eps: Optional[torch.Tensor], generator: Optional[torch.Generator],
               like: torch.Tensor) -> torch.Tensor:
    """``eps`` if given, else a standard-normal draw of ``shape`` from the CPU
    ``generator`` (a fresh one seeded 0 if None), on ``like``'s device."""
    if eps is None:
        generator = generator if generator is not None else torch.Generator().manual_seed(0)
        eps = torch.randn(shape, generator=generator, dtype=like.dtype)
    return eps.to(like.device, like.dtype)


@torch.no_grad()
def validate(
    model,
    gp_params,
    noise,
    spec0,
    spec1,
    dataset,
    z,
    id_covariate: int,
    weight: float,
    loss_function: str = "mse",
    latent_dim: Optional[int] = None,
    eps: float = 1e-6,
    verbose: bool = True,
    type_kl: str = "GPapprox_closed",
    num_samples: int = 1,
    enc_eps: Optional[torch.Tensor] = None,
    gp_eps: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    device="cuda",
) -> ValidationResult:
    """Validation metrics of ``model`` (a port VAE) and the GP
    (``gp_params``, constrained ``noise [L]``, inducing points ``z``) on
    ``dataset``; prints the reference's summary line. Runs on ``device``
    (the model is moved there): the VAE in its own dtype, the GP term in
    the dtype of ``noise``."""
    if verbose:
        print("Testing the model with a validation set")
    dev = resolve_device(device)
    noise = torch.as_tensor(noise, device=dev)
    dtype = noise.dtype
    model.to(dev)

    def t(a):
        return on_device(a, dtype, dev)

    blocks = build_subject_blocks(dataset.labels, id_covariate)
    mdtype = model.raw_log_vy.dtype  # the VAE runs in its own dtype
    data = on_device(dataset.data, mdtype, dev)
    pixmask = on_device(dataset.mask, mdtype, dev)
    labels = t(dataset.labels)
    latent = latent_dim or gp_params.kp0.raw_scale.shape[0]
    enc_eps = draw_noise((data.shape[0], model.latent_dim), enc_eps, generator, data)
    recon, mu, log_var = vae_forward(model, data, enc_eps)
    mse_i, nll_i = mv.vae_loss(model.raw_log_vy.detach(), recon, data, pixmask)
    mu, log_var = mu.to(dtype), log_var.to(dtype)
    recon_sum = float(torch.sum(mse_i))
    nll_sum = float(torch.sum(nll_i))

    p, t_len = blocks.index.shape
    idx = torch.as_tensor(blocks.index.reshape(-1), dtype=torch.long, device=dev)
    block_mask = t(blocks.mask)
    xb = labels[idx].reshape(p, t_len, -1) * block_mask[..., None]
    mu_b = mu[idx].reshape(p, t_len, -1)
    lv_b = log_var[idx].reshape(p, t_len, -1)
    gp = gp_params.to(device=dev, dtype=dtype)
    ops = eb.gp_block_operators(spec0, spec1, gp.kp0, gp.kp1, noise, xb, t(z), block_mask, eps)
    if type_kl == "GPapprox":
        gp_eps = draw_noise((num_samples,) + tuple(mu_b.shape), gp_eps, generator, mu_b)
        std = torch.exp(0.5 * lv_b)
        gp_loss = float(torch.stack([-torch.sum(eb.gp_elbo(ops, mu_b + e * std))
                                     for e in gp_eps]).mean())
    else:
        gp_loss = float(torch.sum(eb.dubo(ops, mu_b, lv_b)))
    if loss_function == "mse":
        gp_term = gp_loss / latent
        net = weight * gp_term + recon_sum
    else:
        gp_term = gp_loss
        net = gp_term + nll_sum
    if verbose:
        print(
            "Validation set - Loss: %.3f  - GP loss: %.3f  - NLL loss: %.3f"
            "  - Recon Loss: %.3f" % (net, gp_term, nll_sum, recon_sum)
        )
    return ValidationResult(net=net, gp=gp_term, nll=nll_sum, recon=recon_sum)
