"""The GPPVAE regime's step as one full-batch loss, in plain torch.

The program takes the gradient in five phases that splice the GP loss's
gradient into per-subject encoder replays; with a deterministic encoder
that is the gradient of one loss over the whole cohort, which this module
takes by a single autograd: every frame encoded with gradients, the
reconstruction of μ + ε·σ on the full-batch noise of
:func:`perfbench.reference.steps.closed_draws`, plus the deviance upper
bound (DUBO; the reference implementation's ``deviance_upper_bound``,
elbo_functions.py:86–142) of the moments over the subject blocks and the
inducing points, weighted by ``weight / L`` under the MSE loss, the
likelihood noise detached as the regime detaches it. Then one Adam step.
"""

from __future__ import annotations

import torch

from perfbench.reference import gp as rg
from perfbench.reference import model as rm
from perfbench.reference import steps as rs

def dubo(comps0, comps1, gp: dict, noise, xb, z, mu, log_var, eps: float) -> torch.Tensor:
    """The DUBO of the moments ``mu``/``log_var [P, T, L]`` of P subjects
    (covariates ``xb [P, T, Q]``) against the prior with inducing points
    ``z [M, Q]``, summed over latents: with ``B = K1 + σ²I`` block-diagonal
    over subjects, ``Σ = B + K0xz K0zz⁻¹ K0zx`` and ``D = diag(exp(log_var))``,
    ``½ (tr(Σ⁻¹D) + μᵀΣ⁻¹μ − N + log|Σ| − log|D| + tr(B⁻¹(K0 − Q0)))``,
    K0 the block-diagonal part of kernel0 and Q0 its Nyström
    approximation. Σ⁻¹ and log|Σ| by Woodbury through
    ``W = K0zz + K0zx B⁻¹ K0xz`` (with the relative jitter of f32 that the
    inducing covariance also gets), ``K0zx B⁻¹ K0xz`` a product over each
    subject's T frames and then a sum over the subjects: W's small
    eigenvalues are the jitters', which one float32 product over the
    cohort's 20,000 frames can move by as much."""
    p, t, q = xb.shape
    n_lat, n_ind = mu.shape[-1], z.shape[0]
    m = mu.permute(2, 0, 1)  # [L, P, T]
    v = torch.exp(log_var).permute(2, 0, 1)
    s0, l0 = gp["kp0.raw_scale"], gp["kp0.raw_lengthscale"]
    k0xz = rg.kernel(comps0, s0, l0, xb.reshape(p * t, q), z).reshape(n_lat, p, t, n_ind)
    k0zz = rg.inducing_jitter(rg.kernel(comps0, s0, l0, z, z), eps)
    _, ik, logdet_k = rg.chol_inv(k0zz)
    k0b = rg.kernel(comps0, s0, l0, xb, xb)  # [L, P, T, T]
    b = rg.kernel(comps1, gp["kp1.raw_scale"], gp["kp1.raw_lengthscale"], xb, xb)
    b = b + noise[:, None, None, None] * rg.eye(t, b)
    _, ib, logdet_b = rg.chol_inv(b)
    ib_k0xz = ib @ k0xz
    s1 = torch.einsum("lptm,lptn->lpmn", k0xz, ib_k0xz).sum(1)
    w = k0zz + 0.5 * (s1 + s1.mT)
    if w.dtype == torch.float32:
        w = w + rg.REL_JITTER * torch.diagonal(w, dim1=-2, dim2=-1).mean() * rg.eye(n_ind, w)
    _, iw, logdet_w = rg.chol_inv(w)
    ib_m = (ib @ m[..., None])[..., 0]
    c = torch.einsum("lptm,lpt->lm", k0xz, ib_m)  # K0zx B⁻¹ μ
    quad = (m * ib_m).sum((1, 2)) - torch.einsum("lm,lmn,ln->l", c, iw, c)
    g = torch.einsum("lptm,lpt,lptn->lmn", ib_k0xz, v, ib_k0xz)  # K0zx B⁻¹ D B⁻¹ K0xz
    tr_isigma_d = (torch.diagonal(ib, dim1=-2, dim2=-1) * v).sum((1, 2)) \
        - torch.einsum("lmn,lnm->l", iw, g)
    nystrom = torch.einsum("lptu,lptu->l", ib, k0b) - torch.einsum("lmn,lnm->l", s1, ik)
    logdet_sigma = logdet_w - logdet_k + logdet_b.sum(-1)
    per_latent = 0.5 * (tr_isigma_d + quad - p * t + logdet_sigma - log_var.sum((0, 1))
                        + nystrom)
    return per_latent.sum()


def gppvae_steps(cfg: dict, data: dict, init: dict, seed: int, steps: int = 3,
                 tf32: bool = False, half_batch: bool = False, device="cpu",
                 dtype=torch.float32, skip_epochs: int = 0) -> rs.Trace:
    """``steps`` GPPVAE steps from ``init`` (``vae.*``, ``gp.*``) on the whole
    cohort ``data`` (frames, labels, pixmask, z), each one autograd over the
    full-batch loss, on the draws after ``skip_epochs``; ``half_batch`` is
    the planted fault of :func:`perfbench.reference.steps.hensman_steps`,
    over subjects."""
    comps0, comps1 = rg.split_components(cfg)
    p, t, n_lat = cfg["P"], cfg["T"], cfg["latent_dim"]
    n = p * t
    frames, labels, pixmask, z = (torch.as_tensor(data[k]).to(device, dtype)
                                  for k in ("frames", "labels", "pixmask", "z"))
    keep_p = p // 2 if half_batch else p
    keep = keep_p * t
    params = rs._leaves(init, device, dtype)
    adam: dict = {}
    losses, recons, first_grad = [], [], {}
    with rs.precision(tf32):
        for i, eps in enumerate(rs.closed_draws(seed, n, n_lat, steps, dtype, skip_epochs)):
            eps = eps.to(device)[:keep]
            w = rs._parts(params, "vae.")
            x = frames[:keep]
            mu, lv = rm.encode(w, x)
            mse, _ = rm.recon_losses(w["raw_log_vy"], rm.decode(w, mu + eps * torch.exp(0.5 * lv)),
                                     x, pixmask[:keep])
            gp = rs._parts(params, "gp.")
            kl = dubo(comps0, comps1, gp, rs._noise(cfg, params).detach(),
                      labels[:keep].reshape(keep_p, t, -1), z, mu.reshape(keep_p, t, n_lat),
                      lv.reshape(keep_p, t, n_lat), cfg["eps"])
            recon = mse.sum() * (n / keep)
            net = recon + cfg["weight"] * kl / n_lat * (n / keep)
            grads = dict(zip(params, torch.autograd.grad(net, list(params.values()),
                                                         allow_unused=True)))
            grads = {k: torch.zeros_like(params[k]) if g is None else g for k, g in grads.items()}
            if i == 0:
                first_grad = {k: g.detach() for k, g in grads.items()}
            losses.append(float(net.detach()))
            recons.append(float(recon.detach()))
            rs._adam(params, grads, adam, i + 1, cfg["learning_rate"])
            del grads, kl, net
    change = {k: (params[k].detach() - init[k].to(device, dtype)) for k in params}
    return rs.Trace(losses, recons, first_grad, change)
