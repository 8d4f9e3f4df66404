"""Validation loss: reconstruction + the batched GP term (port of
lvae_tpu.evaluation.validate).

Encode the validation cohort, sum the reconstruction and NLL losses of one
reparameterised sample, add the GP KL over all latent dims and combine them
per the loss function. The GP term is the deviance upper bound (DUBO) in
every regime but ``GPapprox``, where it is the mean over ``num_samples``
latent samples of −Σ ``gp_elbo``. The summary line is the reference's.

The whole computation is one program (``evaluation/programs.py``, the
counterpart of JAX's ``_validate_jit``): on the card a replay of a CUDA
graph captured at the cohort's shape, with K1 (or K4 on its route) and K2
inside, whose three sums come to the host in one read. The cohort's arrays
and blocks go to the card once per dataset array.

Noise: the encoder's reparameterisation noise ``[N, L]`` and the GPapprox
samples' noise ``[num_samples, P, T, L]`` are drawn, in that order, from
one CPU generator (a fresh one seeded 0 unless one is given), or injected,
and go to the device in one pinned slab, one copy.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from lvae_torch.evaluation import programs
from lvae_torch.evaluation.encode import forward
from lvae_torch.models import vae as mv
from lvae_torch.ops import elbo as eb
from lvae_torch.ops import kernels as kx
from lvae_torch.train.graph import finish_host_copy, start_host_copy
from lvae_torch.utils.device import resolve_device


class ValidationResult(NamedTuple):
    net: float
    gp: float
    nll: float
    recon: float


def _program(model, spec0, spec1, eps: float, type_kl: str, noise_parts):
    """The validation program: ``[recon_sum, nll_sum, gp_loss]`` of the
    cohort (frames, pixel mask, labels, block index and mask), the GP
    tensors and the noise slab."""
    def program(data, pixmask, labels, idx, block_mask, noise, s0, l0, s1, l1, z, slab):
        enc_eps, *gp_eps = programs.split_noise(slab, noise_parts)
        recon, mu, log_var = forward(model, data, enc_eps)
        mse_i, nll_i = mv.vae_loss(model.raw_log_vy.detach(), recon, data, pixmask)
        dtype = noise.dtype
        mu, log_var = mu.to(dtype), log_var.to(dtype)
        p, t_len = block_mask.shape
        xb = labels[idx].reshape(p, t_len, -1) * block_mask[..., None]
        mu_b = mu[idx].reshape(p, t_len, -1)
        lv_b = log_var[idx].reshape(p, t_len, -1)
        ops = eb.gp_block_operators(spec0, spec1, kx.KernelParams(s0, l0),
                                    kx.KernelParams(s1, l1), noise, xb, z, block_mask, eps)
        if type_kl == "GPapprox":
            std = torch.exp(0.5 * lv_b)
            gp_loss = torch.stack([-torch.sum(eb.gp_elbo(ops, mu_b + e * std))
                                   for e in gp_eps[0]]).mean()
        else:
            gp_loss = torch.sum(eb.dubo(ops, mu_b, lv_b))
        sums = (torch.sum(mse_i), torch.sum(nll_i), gp_loss)
        out_dtype = torch.promote_types(sums[0].dtype, dtype)
        return torch.stack([s.to(out_dtype) for s in sums])

    return program


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
    model.to(dev).eval()
    mdtype = model.raw_log_vy.dtype  # the VAE runs in its own dtype
    data = programs.dataset_tensor(dataset.data, mdtype, dev)
    pixmask = programs.dataset_tensor(dataset.mask, mdtype, dev)
    labels = programs.dataset_tensor(dataset.labels, dtype, dev)
    idx, block_mask = programs.dataset_blocks(dataset.labels, id_covariate, dtype, dev)
    latent = latent_dim or gp_params.kp0.raw_scale.shape[0]
    p, t_len = block_mask.shape
    parts = [((data.shape[0], model.latent_dim), mdtype, enc_eps)]
    if type_kl == "GPapprox":
        parts.append(((num_samples, p, t_len, model.latent_dim), dtype, gp_eps))
    slab = programs.host_noise(parts, generator, dev)
    gp = gp_params.to(device=dev, dtype=dtype)
    noise_parts = [(shape, d) for shape, d, _ in parts]
    program = _program(model, spec0, spec1, eps, type_kl, noise_parts)
    inputs = [data, pixmask, labels, idx, block_mask, noise, *gp.kp0, *gp.kp1,
              programs.on_device(z, dtype, dev), slab]
    out_dtype = torch.promote_types(mdtype, dtype)
    sums = programs.run("validate", program, inputs, (3,), out_dtype, dev, model,
                        (spec0, spec1, eps, type_kl, num_samples))
    recon_sum, nll_sum, gp_loss = finish_host_copy(start_host_copy(sums)).tolist()
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
