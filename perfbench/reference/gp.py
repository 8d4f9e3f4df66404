"""The additive GP prior over covariates and its KL terms, in plain torch.

A configuration names its kernel as the reference implementation's flags
do (``cat_kernel``, ``sqexp_kernel``, ``bin_kernel``, ``cat_int_kernel``,
``bin_int_kernel``). Each component is a scale times a product of factors:
an equality indicator on a categorical covariate, an indicator that two
binary covariates are both 1, a squared-exponential factor on a continuous
covariate. The components that carry the subject-id covariate make kernel1,
block-diagonal over subjects; the others make kernel0. Their parameters are
``[L, C]`` stacks, one column a component, columns in the order the
components are listed here: kernel-by-kernel as the flags are read
(categorical, squared-exponential, binary, categorical×continuous,
binary×continuous), each sent to kernel1 or kernel0. Positive values are
``exp(-16 + softplus(raw + 16))``.

In float32 the prior's inducing covariance gets the jitter
``max(eps, 3e-4 · mean diagonal)`` (the mean over every latent); float64
adds ``eps``.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import torch

MIN_LOG = -16.0
REL_JITTER = 3e-4


class Component(NamedTuple):
    rbf: int  # covariate of the squared-exponential factor, or -1
    eq: Tuple[int, ...]  # categorical covariates compared for equality
    both: Tuple[int, ...]  # binary covariates that must both be 1


def split_components(cfg: dict) -> Tuple[List[Component], List[Component]]:
    """(kernel0, kernel1) components of the configuration's kernel."""
    ident = cfg["id_covariate"]
    k0: List[Component] = []
    k1: List[Component] = []
    for c in cfg["cat_kernel"]:
        (k1 if c == ident else k0).append(Component(-1, (c,), ()))
    for c in cfg["sqexp_kernel"]:
        k0.append(Component(c, (), ()))
    for c in cfg["bin_kernel"]:
        k0.append(Component(-1, (), (c,)))
    for d in cfg["cat_int_kernel"]:
        comp = Component(d["cont_covariate"], (d["cat_covariate"],), ())
        (k1 if d["cat_covariate"] == ident else k0).append(comp)
    for d in cfg["bin_int_kernel"]:
        k0.append(Component(d["cont_covariate"], (), (d["bin_covariate"],)))
    if cfg.get("covariate_missing_val"):
        raise ValueError("the reference covers cohorts without missing covariates")
    return k0, k1


def positive(raw: torch.Tensor) -> torch.Tensor:
    """Raw parameter → positive value."""
    x = raw - MIN_LOG
    return torch.exp(MIN_LOG + torch.logaddexp(x, torch.zeros_like(x)))


def kernel(comps: List[Component], raw_scale: torch.Tensor, raw_ls: torch.Tensor,
           x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """``K [L, *B, N1, N2]`` for covariates ``x1 [*B, N1, Q]``, ``x2 [*B, N2, Q]``
    and raw parameters ``[L, C]``."""
    scale, ls = positive(raw_scale), positive(raw_ls)
    lead = (slice(None),) + (None,) * (x1.dim())
    out = None
    for c, comp in enumerate(comps):
        term = scale[:, c][lead] * torch.ones(x1.shape[:-1] + (x2.shape[-2],), dtype=x1.dtype,
                                              device=x1.device)
        if comp.rbf >= 0:
            d = x1[..., :, comp.rbf, None] - x2[..., None, :, comp.rbf]
            term = term * torch.exp(-(d * d) / (2.0 * ls[:, c][lead] ** 2))
        for col in comp.eq:
            term = term * (x1[..., :, col, None] == x2[..., None, :, col]).to(x1.dtype)
        for col in comp.both:
            term = term * ((x1[..., :, col, None] + x2[..., None, :, col]) == 2.0).to(x1.dtype)
        out = term if out is None else out + term
    return out


def eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def inducing_jitter(kzz: torch.Tensor, eps: float) -> torch.Tensor:
    m = kzz.shape[-1]
    if kzz.dtype == torch.float32:
        mean_diag = torch.diagonal(kzz, dim1=-2, dim2=-1).mean()
        jit = torch.maximum(torch.full((), eps, dtype=kzz.dtype, device=kzz.device),
                            REL_JITTER * mean_diag)
    else:
        jit = eps
    return kzz + jit * eye(m, kzz)


def chol_inv(a: torch.Tensor):
    """(Cholesky factor, inverse, log-determinant per matrix) of SPD ``a``;
    NaN where ``a`` is not positive definite."""
    lo, info = torch.linalg.cholesky_ex(a)
    lo = torch.where((info == 0)[..., None, None], lo, torch.nan)
    logdet = 2.0 * torch.log(torch.diagonal(lo, dim1=-2, dim2=-1)).sum(-1)
    return lo, torch.cholesky_inverse(lo), logdet


def hensman_kl(comps0, comps1, gp: dict, noise, m, H, xb, z, mu, log_var, p_tot: int,
               n_tot: int, eps: float):
    """Hensman et al.'s minibatch bound on the KL of the latents
    ``mu``/``log_var [S, T, L]`` of S subjects (covariates ``xb [S, T, Q]``)
    against the prior with inducing points ``z [M, Q]`` and the variational
    ``q(u) = N(m [L, M, 1], H [L, M, M])``, scaled to ``p_tot`` subjects and
    ``n_tot`` frames; returns the bound and what the natural gradients need."""
    s, t, q = xb.shape
    n_lat, n_ind = m.shape[0], m.shape[1]
    mu_l = mu.permute(2, 0, 1)  # [L, S, T]
    v = torch.exp(log_var).permute(2, 0, 1)
    k0xz = kernel(comps0, gp["kp0.raw_scale"], gp["kp0.raw_lengthscale"],
                  xb.reshape(s * t, q), z).reshape(n_lat, s, t, n_ind)
    k0zz = inducing_jitter(kernel(comps0, gp["kp0.raw_scale"], gp["kp0.raw_lengthscale"], z, z),
                           eps)
    _, ik, logdet_k = chol_inv(k0zz)
    _, ih, logdet_h = chol_inv(H)
    k0b = kernel(comps0, gp["kp0.raw_scale"], gp["kp0.raw_lengthscale"], xb, xb)
    b = kernel(comps1, gp["kp1.raw_scale"], gp["kp1.raw_lengthscale"], xb, xb)
    b = b + noise[:, None, None, None] * eye(t, b)
    _, ib, logdet_b = chol_inv(b)
    ib_k0xz = ib @ k0xz
    s1 = torch.einsum("lptm,lptn->lmn", k0xz, ib_k0xz)
    r = torch.einsum("lptm,lm->lpt", k0xz, (ik @ m)[..., 0]) - mu_l
    a_t = torch.einsum("lpt,lptu,lpu->", r, ib, r)
    b_t = (torch.diagonal(ib, dim1=-2, dim2=-1) * v).sum()
    d_t = torch.einsum("lptu,lptu->", ib, k0b) - torch.einsum("lmn,lmn->", s1, ik)
    e_t = torch.einsum("lnm,lmn->", ik @ H @ ik, s1)
    kl_u = 0.5 * (torch.einsum("lmn,lnm->", ik, H) + torch.einsum("lmo,lmo->", m, ik @ m)
                  - n_lat * n_ind + logdet_k.sum() - logdet_h.sum())
    kl = (p_tot / s) * 0.5 * (a_t + b_t + logdet_b.sum() + d_t + e_t - log_var.sum())
    kl = kl + kl_u - n_lat * n_tot / 2.0
    return kl, (ik.detach(), ih.detach(), s1.detach(),
                torch.einsum("lptm,lptu,lpu->lm", k0xz, ib, mu_l).detach())


@torch.no_grad()
def natural_gradient_step(m, H, parts, lr: float):
    """One natural-gradient step on (m, H) in the inverse space, kept only
    where every new factor is finite."""
    ik, ih, s1, k0zx_ib_mu = parts
    ng_b = ik @ s1 @ ik + ik
    grad_m = -(ik @ k0zx_ib_mu[..., None]) + ng_b @ m
    grad_h = 0.5 * (-ih + ng_b)
    _, h_new, _ = chol_inv(ih + lr * (grad_h + grad_h.mT))
    m_new = h_new @ (ih @ m - lr * (grad_m - 2.0 * (grad_h @ m)))
    l_new, _, _ = chol_inv(h_new)
    ok = bool(torch.isfinite(m_new).all() and torch.isfinite(h_new).all()
              and torch.isfinite(l_new).all())
    return (m_new, h_new) if ok else (m, H)


def closed_kl(comps, gp: dict, noise, labels, mu, log_var):
    """The exact KL of the latents ``[N, L]`` against the full prior
    ``K + σ²I`` over the cohort's covariates ``labels [N, Q]``, summed over
    latents."""
    n = labels.shape[0]
    raw_s = torch.cat([gp["kp0.raw_scale"], gp["kp1.raw_scale"]], -1)
    raw_l = torch.cat([gp["kp0.raw_lengthscale"], gp["kp1.raw_lengthscale"]], -1)
    k = kernel(comps, raw_s, raw_l, labels, labels)
    k = k + noise[:, None, None] * eye(n, k)
    _, ik, logdet = chol_inv(k)
    del k
    mu_l, lv_l = mu.t(), log_var.t()
    tr = (torch.diagonal(ik, dim1=-2, dim2=-1) * torch.exp(lv_l)).sum(-1)
    qf = (mu_l * (ik @ mu_l[..., None])[..., 0]).sum(-1)
    return (0.5 * (tr + qf - n + logdet - lv_l.sum(-1))).sum()
