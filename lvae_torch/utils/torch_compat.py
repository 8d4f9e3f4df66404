"""The reference's own file formats (port of lvae_tpu.utils.torch_compat).

* :func:`save_reference_gp_state` / :func:`load_reference_gp_state` — the
  reference's four GP resume files: ``gp_model.pth`` (a GPyTorch
  ``ExactGPModel`` ``state_dict``), ``zt_list.pth`` ``[L, M, Q]``,
  ``m.pth`` ``[L, M, 1]`` and ``H.pth`` ``[L, M, M]``, all float64. A GP
  trained by the port resumes in the reference from them, and one trained
  by the reference resumes here.
* :func:`save_torch_vae_checkpoint` — the reference's ``.pth`` VAE
  ``state_dict`` of a ConvVAE or SimpleVAE. The port's layer names and
  layouts are the reference's; only the observation noise is named
  ``_log_vy`` there (the inverse of ``pipeline.reference_vae_state_dict``).

The port's raw GP parameters are log-space (``ops/kernels.constrain``);
GPyTorch stores the softplus inverse of each positive value, and its
likelihood noise above a ``GreaterThan(1e-8)`` bound.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch
from torch import nn

from lvae_torch.ops import kernels as kx

_GPY_MIN = 1e-8  # GaussianLikelihood's GreaterThan(1e-8) noise bound


def _inv_softplus(y) -> np.ndarray:
    """softplus⁻¹ in f64 (GPyTorch's Positive constraint inverse)."""
    y = np.asarray(y, np.float64)
    return np.where(y > 30.0, y, np.log(np.expm1(np.clip(y, 1e-300, 30.0))))


def _softplus(x) -> np.ndarray:
    x = np.asarray(x, np.float64)
    return np.where(x > 30.0, x, np.log1p(np.exp(np.minimum(x, 30.0))))


def _component_key_paths(
    cat_kernel=(), bin_kernel=(), sqexp_kernel=(), cat_int_kernel=(),
    bin_int_kernel=(), covariate_missing_val=(), id_covariate=0,
):
    """GPyTorch key paths of each additive component, kernel0's then
    kernel1's, in ``ops/kernels.split_kernel_spec``'s component order: for
    each, the path under ``covar_module.kernels.{i}.`` of its RBF
    ``raw_lengthscale``, or None (the ``raw_outputscale`` always sits at the
    component's root)."""
    missing = [d["covariate"] for d in covariate_missing_val]
    k0, k1 = [], []
    for idx in cat_kernel:
        (k1 if idx == id_covariate else k0).append(None)
    for idx in sqexp_kernel:
        k0.append("base_kernel.kernels.0.raw_lengthscale" if idx in missing
                  else "base_kernel.raw_lengthscale")
    for _ in bin_kernel:
        k0.append(None)
    for d in cat_int_kernel:
        sub = ("base_kernel.kernels.1.kernels.0.raw_lengthscale"
               if d["cont_covariate"] in missing else "base_kernel.kernels.1.raw_lengthscale")
        (k1 if d["cat_covariate"] == id_covariate else k0).append(sub)
    for d in bin_int_kernel:
        k0.append("base_kernel.kernels.1.kernels.0.raw_lengthscale"
                  if d["cont_covariate"] in missing else "base_kernel.kernels.1.raw_lengthscale")
    return k0, k1


def _f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def save_reference_gp_state(
    dirpath: str,
    gp,  # train.state.GPParams
    zt,  # [M, Q] inducing points
    m,  # [L, M, 1]
    H,  # [L, M, M] PSD
    latent_dim: int,
    constrain_scales: bool = False,
    **spec_kwargs,  # cat_kernel, ..., covariate_missing_val, id_covariate
) -> str:
    """Write the reference's four GP resume files into ``dirpath``. The
    constrained values are computed in the parameters' own dtype, then
    re-expressed in GPyTorch's raw space in float64."""
    os.makedirs(dirpath, exist_ok=True)
    paths0, paths1 = _component_key_paths(**spec_kwargs)

    def constrained(raw) -> np.ndarray:
        return _f64(kx.constrain(raw.detach().cpu()))

    noise = np.ones((latent_dim,), np.float64) if constrain_scales else constrained(gp.raw_noise)
    sd = {"likelihood.noise_covar.raw_noise": torch.tensor(
        _inv_softplus(noise - _GPY_MIN).reshape(latent_dim, 1))}

    def emit(kp, paths, offset):
        scale, ls = constrained(kp.raw_scale), constrained(kp.raw_lengthscale)  # [L, C]
        for c, sub in enumerate(paths):
            sd[f"covar_module.kernels.{offset + c}.raw_outputscale"] = torch.tensor(
                _inv_softplus(scale[:, c]))
            if sub is not None:
                sd[f"covar_module.kernels.{offset + c}.{sub}"] = torch.tensor(
                    _inv_softplus(ls[:, c]).reshape(latent_dim, 1, 1))

    emit(gp.kp0, paths0, 0)
    emit(gp.kp1, paths1, len(paths0))
    torch.save(sd, os.path.join(dirpath, "gp_model.pth"))
    zt64 = _f64(zt)
    torch.save(torch.tensor(np.broadcast_to(zt64, (latent_dim,) + zt64.shape).copy()),
               os.path.join(dirpath, "zt_list.pth"))
    torch.save(torch.tensor(_f64(m)), os.path.join(dirpath, "m.pth"))
    torch.save(torch.tensor(_f64(H)), os.path.join(dirpath, "H.pth"))
    return dirpath


def load_reference_gp_state(dirpath: str, latent_dim: int, **spec_kwargs) -> Tuple:
    """Read the reference's GP resume files: ``(kp0, kp1, noise [L],
    zt [M, Q], m, H)``, the kernel parameters as the port's log-space raws
    (``KernelParams`` of float64 tensors), the rest float64 tensors. The
    inverse of :func:`save_reference_gp_state`; it also reads files the
    reference wrote, given the spec it trained with."""
    sd = torch.load(os.path.join(dirpath, "gp_model.pth"), map_location="cpu",
                    weights_only=True)
    sd = {k: _f64(v) for k, v in sd.items()}
    paths0, paths1 = _component_key_paths(**spec_kwargs)
    noise = _softplus(sd["likelihood.noise_covar.raw_noise"]).reshape(latent_dim) + _GPY_MIN

    def absorb(paths, offset) -> kx.KernelParams:
        scale = np.zeros((latent_dim, len(paths)), np.float64)
        ls = np.full((latent_dim, len(paths)), float(kx.DEFAULT_LENGTHSCALE), np.float64)
        for c, sub in enumerate(paths):
            scale[:, c] = _softplus(
                sd[f"covar_module.kernels.{offset + c}.raw_outputscale"]).reshape(latent_dim)
            if sub is not None:
                ls[:, c] = _softplus(sd[f"covar_module.kernels.{offset + c}.{sub}"]).reshape(
                    latent_dim)
        return kx.KernelParams(raw_scale=kx.unconstrain(torch.tensor(scale)),
                               raw_lengthscale=kx.unconstrain(torch.tensor(ls)))

    def tensor(name: str) -> torch.Tensor:
        return torch.load(os.path.join(dirpath, name), map_location="cpu",
                          weights_only=True).to(torch.float64)

    return (absorb(paths0, 0), absorb(paths1, len(paths0)), torch.tensor(noise),
            tensor("zt_list.pth")[0], tensor("m.pth"), tensor("H.pth"))


def save_torch_vae_checkpoint(path: str, model: nn.Module) -> str:
    """Write ``model`` (a ConvVAE or SimpleVAE) as the reference's ``.pth``
    VAE ``state_dict``; the reference has no RNN encoder."""
    if hasattr(model, "rnn"):
        raise ValueError("the reference's .pth VAE format has no RNN encoder")
    sd = {("_log_vy" if k == "raw_log_vy" else k): v.detach().cpu().clone()
          for k, v in model.state_dict().items()}
    torch.save(sd, path)
    return path
