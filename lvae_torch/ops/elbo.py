"""GP KL bounds of the longitudinal VAE and the natural gradients (port of
lvae_tpu.ops.elbo).

Functions operate on padded subject blocks: covariates ``xb [P, T, Q]``,
latents ``[P, T, L]`` and a validity mask ``[P, T]`` (1 = real sample). The
mask folds the padding out of every term exactly:

* block kernels are multiplied by ``mask ⊗ mask``, so padded rows and
  columns are 0;
* ``B = K1 + diag(mask·σ² + (1 − mask))``: padded pivots are 1 and add
  ``log 1 = 0`` to every log-determinant;
* ``K0xz`` and the variational moments are masked to 0 on padded rows.

The bounds: :func:`kl_closed`, the exact N×N KL of the standard regime's
``closed`` mode; :func:`gp_elbo`, the sample-based inducing-point bound
(``GPapprox``); :func:`dubo`, the deviance upper bound (``GPapprox_closed``);
:func:`minibatch_kld`, the Hensman SVI bound. Every function runs its GP
algebra at full f32 precision (TF32 off).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from lvae_torch.kernels_cuda import b_chain as bc
from lvae_torch.kernels_cuda import block_pair as bp
from lvae_torch.ops import kernels as kx
from lvae_torch.ops import linalg as la
from lvae_torch.ops.linalg import _full_precision
from lvae_torch.ops.shard import LOCAL, Local


class GPBlockOperators(NamedTuple):
    """Shared intermediates of the sparse-GP bound for one batch of subjects
    (L latent dims, P subjects, T block length, M inducing points)."""

    K0xz: torch.Tensor  # [L, P, T, M]  masked cross-covariance
    K0zz: torch.Tensor  # [L, M, M]     jittered inducing covariance
    LK0zz: torch.Tensor  # [L, M, M]
    iK0zz: torch.Tensor  # [L, M, M]
    K0_st: Optional[torch.Tensor]  # [L, P, T, T] masked block K0 (None on K1)
    B: Optional[torch.Tensor]  # [L, P, T, T] K1 + noise (None on K1)
    LB: Optional[torch.Tensor]  # [L, P, T, T] (None on K1)
    iB: torch.Tensor  # [L, P, T, T]
    iB_K0xz: torch.Tensor  # [L, P, T, M]
    K0zx_iB_K0xz: torch.Tensor  # [L, M, M]
    logdet_B: torch.Tensor  # [L]
    logdet_K0zz: torch.Tensor  # [L]
    mask: torch.Tensor  # [P, T]
    # tr(B⁻¹ K0_blockdiag) per latent dim, set where kernel K1 ran
    tr_iB_K0: Optional[torch.Tensor] = None
    # (chol, inverse) of the caller's ``extra_spd`` stack, factored in the
    # same call as K0zz
    extra_chol: Optional[torch.Tensor] = None  # [L, M, M]
    extra_inv: Optional[torch.Tensor] = None  # [L, M, M]


@_full_precision
def gp_block_operators(
    spec0: kx.KernelSpec,
    spec1: kx.KernelSpec,
    kp0: kx.KernelParams,
    kp1: kx.KernelParams,
    noise: torch.Tensor,
    xb: torch.Tensor,
    z: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    eps: float = 1e-6,
    extra_spd: Optional[torch.Tensor] = None,
    view: Local = LOCAL,
) -> GPBlockOperators:
    """The kernel operators shared by the bounds: kernel evaluations, the
    per-subject ``T×T`` chain of ``B = K1 + σ²I`` and the inducing ``M×M``
    factorisation.

    ``noise`` is the constrained per-latent noise ``[L]``, ``z [M, Q]`` the
    inducing points. ``extra_spd`` (``[L, M, M]`` SPD, the Hensman step's
    variational H) is factored in one call with K0zz, stacked ``[K0zz; H]``,
    and returned as ``extra_chol``/``extra_inv``; an ``extra_spd`` of
    another shape is factored in a call of its own. The operators are those
    of the subjects and latents given; ``view`` says over which latents the
    f32 jitter of K0zz takes its mean (:mod:`lvae_torch.ops.shard`).

    The per-subject chain takes one of three routes, as in the JAX package:

    * K1 (``kernels_cuda/b_chain.py``) where ``ops/kernels.use_b_chain_kernel``
      allows it (None: for CUDA tensors) and ``b_chain.usable`` holds;
    * else K4 (``kernels_cuda/block_pair.py``) builds both block stacks in
      one pass where ``ops/kernels.use_block_pair_kernel`` is on and
      ``block_pair.usable`` holds (f32, ``[L, C]`` parameters);
    * else the plain block kernels, also for a batch outside
      ``block_pair.usable`` with the K4 switch on, on every device.

    K4 and the plain route go on through B → ``cholesky_and_inverse`` →
    log|B|.
    """
    p, t, q = xb.shape
    m_ind = z.shape[0]
    dtype = xb.dtype
    if mask is None:
        mask = torch.ones((p, t), dtype=dtype, device=xb.device)
    mask = mask.to(dtype)

    k0xz_flat = kx.kernel_matrix(spec0, kp0, xb.reshape(p * t, q), z,
                                 mask1=mask.reshape(p * t))
    l_lat = k0xz_flat.shape[0]
    k0xz = k0xz_flat.reshape(l_lat, p, t, m_ind)

    k0zz = kx.add_adaptive_jitter(kx.kernel_matrix(spec0, kp0, z, z), eps, view)
    extra_chol = extra_inv = None
    if extra_spd is not None and extra_spd.shape == k0zz.shape:
        stacked = torch.cat([k0zz, extra_spd.to(k0zz.dtype)], dim=0)
        l_all, i_all = la.cholesky_and_inverse(stacked)
        lk0zz, ik0zz = l_all[:l_lat], i_all[:l_lat]
        extra_chol, extra_inv = l_all[l_lat:], i_all[l_lat:]
    else:
        lk0zz, ik0zz = la.cholesky_and_inverse(k0zz)
        if extra_spd is not None:  # another shape: factored on its own
            extra_chol, extra_inv = la.cholesky_and_inverse(extra_spd)

    want_b_chain = kx.use_b_chain_kernel
    if want_b_chain is None:
        want_b_chain = xb.is_cuda
    if want_b_chain and bc.usable(spec0, spec1, kp0, xb):
        ib, logdet_b, tr_ib_k0 = bc.b_chain_operators(spec0, spec1, kp0, kp1, noise, xb, mask)
        k0_st = b = lb = None
    else:
        if kx.use_block_pair_kernel and bp.usable(spec0, spec1, kp0, xb):
            k0_st, k1_st = bp.block_kernel_pair(spec0, spec1, kp0, kp1, xb, mask)
        else:
            k0_st = kx.block_kernel_matrix(spec0, kp0, xb, mask)
            k1_st = kx.block_kernel_matrix(spec1, kp1, xb, mask)
        b = kx.block_b_operator(spec1, kp1, xb, mask, noise, k1_st=k1_st)
        lb, ib = la.cholesky_and_inverse(b)
        logdet_b = la.logdet_from_chol(lb, batch_dims=1)
        tr_ib_k0 = None

    ib_k0xz = ib @ k0xz
    return GPBlockOperators(
        K0xz=k0xz,
        K0zz=k0zz,
        LK0zz=lk0zz,
        iK0zz=ik0zz,
        K0_st=k0_st,
        B=b,
        LB=lb,
        iB=ib,
        iB_K0xz=ib_k0xz,
        K0zx_iB_K0xz=la.cohort_gram(k0xz, ib_k0xz),
        logdet_B=logdet_b,
        logdet_K0zz=la.logdet_from_chol(lk0zz, batch_dims=1),
        mask=mask,
        tr_iB_K0=tr_ib_k0,
        extra_chol=extra_chol,
        extra_inv=extra_inv,
    )


class ClosedKL(torch.autograd.Function):
    """The exact N×N KL(q‖p) of :func:`kl_closed` on flat stacks ``K [B, N,
    N]``, ``mu``/``log_var [B, N]``, with its gradient in closed form.

    With K = L Lᵀ, v = exp(log_var), W = L⁻¹ diag(√v), b = L⁻¹μ and
    a = K⁻¹μ = L⁻ᵀb, the gradient under the cotangent ḡ of each entry is

    * K̄ = ½ ḡ L⁻ᵀ (I − W Wᵀ − b bᵀ) L⁻¹;
    * μ̄ = ḡ a;
    * log_var̄ = ½ ḡ (v ⊙ diag K⁻¹ − 1), diag K⁻¹ the squared column norms
      of L⁻¹.

    The bracket is formed in the whitened space, where its terms are of
    order 1, and mapped back by two triangular solves: written as
    K⁻¹ − K⁻¹ diag(v) K⁻¹ − a aᵀ its terms nearly cancel, and in f32 the
    kernel scales' gradients, which contract K̄ with the prior's smooth
    components, lose up to 1e-3 of their norm against float64 on the
    closed cell's priors (2e-6 this way and through autograd). Forward:
    ``potrf``, L⁻¹ by one solve, two GEMVs; backward: one product and two
    solves, where autograd through ``la.chol_inverse`` runs four more
    solves and three products.
    ``backward_calls`` counts the backward's runs on the host (a CUDA-graph
    replay runs no Python and is not counted).
    """

    backward_calls = 0

    @staticmethod
    def forward(ctx, k, mu, log_var):
        with la.full_precision():
            n = k.shape[-1]
            lk = la.cholesky(k)
            logdet_k = la.logdet_from_chol(lk, batch_dims=1)
            eye = torch.eye(n, dtype=k.dtype, device=k.device)
            li = torch.linalg.solve_triangular(lk, eye.expand_as(lk), upper=False)
            diag_ik = torch.linalg.vector_norm(li, dim=-2).square()
            b = torch.bmm(li, mu[:, :, None])
            a = torch.bmm(li.mT, b)[:, :, 0]
            v = torch.exp(log_var)
            w = li.mul_(torch.sqrt(v)[:, None, :])
            # tr(K⁻¹ diag(v)) from the diagonal: the JAX package takes it
            # through an eye mask for its scatter VJP, which a written-out
            # backward does not need
            tr = torch.sum(v * diag_ik, dim=-1)
            qf = torch.sum(b[:, :, 0].square(), dim=-1)
            ctx.save_for_backward(lk, w, b, a, v, diag_ik)
            return 0.5 * (tr + qf - n + logdet_k - torch.sum(log_var, dim=-1))

    @staticmethod
    def backward(ctx, g):
        ClosedKL.backward_calls += 1
        # autograd runs this after the forward's full_precision() block has
        # exited, so the backward enters it again itself
        with la.full_precision():
            lk, w, b, a, v, diag_ik = ctx.saved_tensors
            half_g = 0.5 * g
            m = torch.bmm(w, w.mT)
            m.addcmul_(b, b.mT)
            m.mul_(-half_g[:, None, None])
            m.diagonal(dim1=-2, dim2=-1).add_(half_g[:, None])
            y = torch.linalg.solve_triangular(lk.mT, m, upper=True)
            del m
            # K̄ comes out column-major, as the solves leave it: K3's
            # backward reads that layout with one copy fewer per component
            # than a row-major one
            dk = torch.linalg.solve_triangular(lk.mT, y.mT, upper=True)
            dmu = g[:, None] * a
            dlv = half_g[:, None] * (v * diag_ik - 1)
            return dk, dmu, dlv


def kl_closed(K: torch.Tensor, mu: torch.Tensor, log_var: torch.Tensor) -> torch.Tensor:
    """Exact N×N KL(q‖p) per leading batch entry (the JAX package vmaps it
    over latents): ``K [..., N, N]`` is the dense prior covariance with the
    observation noise, ``mu``/``log_var [..., N]`` the diagonal variational
    moments, with the same leading dims. The N×N Cholesky and solves are
    ``torch.linalg``'s; the gradient is :class:`ClosedKL`'s closed form."""
    n = K.shape[-1]
    out = ClosedKL.apply(K.reshape(-1, n, n), mu.reshape(-1, n), log_var.reshape(-1, n))
    return out.reshape(K.shape[:-2])


def _w_cholesky(ops: GPBlockOperators, k0zx_ib_k0xz: torch.Tensor, logdet_b: torch.Tensor,
                view: Local):
    """Cholesky of ``W = K0zz + K0zx B⁻¹ K0xz`` (with the f32 relative
    jitter) and ``log|Σ| = log|W| + log|B| − log|K0zz|``, from the subject
    sums ``K0zx B⁻¹ K0xz`` and ``log|B|``: shared by :func:`gp_elbo` and
    :func:`dubo`."""
    w = kx.add_rel_jitter(la.symmetrize(ops.K0zz + k0zx_ib_k0xz), view=view)
    lw = la.cholesky(w)
    logdet_sigma = -ops.logdet_K0zz + logdet_b + la.logdet_from_chol(lw, batch_dims=1)
    return lw, logdet_sigma


def _quadform_sums(ops: GPBlockOperators, y: torch.Tensor):
    """The subject sums ``(yᵀB⁻¹y, K0zx B⁻¹ y)`` per latent dim of the
    Woodbury quadratic form, for ``y [L, P, T]``."""
    ib_y = torch.einsum("lptu,lpu->lpt", ops.iB, y)
    qf1 = torch.einsum("lpt,lpt->l", y, ib_y)
    pvec = torch.einsum("lptm,lpt->lm", ops.K0xz, ib_y)
    return qf1, pvec


def _sigma_quadform(lw: torch.Tensor, qf1: torch.Tensor, pvec: torch.Tensor):
    """``yᵀ Σ⁻¹ y`` per latent dim via Woodbury: ``yᵀB⁻¹y − ‖Lw⁻¹ K0zx B⁻¹ y‖²``."""
    half = la.solve_triangular(lw, pvec[..., None])
    return qf1 - torch.sum(half[..., 0] ** 2, dim=-1)


def _trace_ib_k0(ops: GPBlockOperators):
    """``tr(B⁻¹ K0_blockdiag)`` per latent dim (a subject sum), from kernel
    K1 where it ran."""
    if ops.tr_iB_K0 is not None:
        return ops.tr_iB_K0
    return torch.einsum("lptu,lptu->l", ops.iB, ops.K0_st)


def _nystrom_trace(ops: GPBlockOperators, t1: torch.Tensor, k0zx_ib_k0xz: torch.Tensor):
    """``tr(B⁻¹(K0_blockdiag − Q0))``, the inducing-point slack term, from
    the subject sums ``t1`` and ``K0zx B⁻¹ K0xz``."""
    return t1 - torch.einsum("lmn,lmn->l", k0zx_ib_k0xz, ops.iK0zz)


@_full_precision
def gp_elbo(ops: GPBlockOperators, yb: torch.Tensor, view: Local = LOCAL) -> torch.Tensor:
    """Sample-based inducing-point marginal-likelihood bound per latent dim,
    ``[L]``, for a latent sample ``yb [P, T, L]``: with
    ``Σ = B + K0xz K0zz⁻¹ K0zx``,
    ``−½(N log 2π + log|Σ| + yᵀΣ⁻¹y) − ½ tr(B⁻¹(K0_blockdiag − Q0))``.
    Its subject sums are summed over ``view``'s ranks first, so every rank
    of a latent gets that latent's whole bound."""
    mask = ops.mask
    y = (yb * mask[..., None]).permute(2, 0, 1)  # [L, P, T]
    qf1, pvec = _quadform_sums(ops, y)
    s1, logdet_b, qf1, pvec, t1, n_real = view.data_sums(
        ops.K0zx_iB_K0xz, ops.logdet_B, qf1, pvec, _trace_ib_k0(ops), torch.sum(mask))
    lw, logdet = _w_cholesky(ops, s1, logdet_b, view)
    qf = _sigma_quadform(lw, qf1, pvec)
    tr = _nystrom_trace(ops, t1, s1)
    const = -0.5 * n_real * math.log(2.0 * math.pi)
    return const - 0.5 * (logdet + qf) - 0.5 * tr


@_full_precision
def dubo(ops: GPBlockOperators, mu_b: torch.Tensor, log_var_b: torch.Tensor,
         view: Local = LOCAL) -> torch.Tensor:
    """Deviance upper bound on the KL per latent dim, ``[L]``: the sparse
    bound on the variational mean and variance ``[P, T, L]`` instead of a
    latent sample. Its subject sums are summed over ``view``'s ranks first,
    so every rank of a latent gets that latent's whole bound."""
    mask = ops.mask
    dtype = mu_b.dtype
    m = (mu_b * mask[..., None]).permute(2, 0, 1)  # [L, P, T]
    v = (torch.exp(log_var_b) * mask[..., None]).permute(2, 0, 1)
    log_v_masked = (log_var_b * mask[..., None]).permute(2, 0, 1)

    qf1, pvec = _quadform_sums(ops, m)
    logdet_d = torch.sum(log_v_masked, dim=(1, 2))
    eye_t = torch.eye(ops.iB.shape[-1], dtype=v.dtype, device=v.device)
    tr_ib_d = torch.sum(ops.iB * (eye_t * v[..., :, None]), dim=(1, 2, 3))

    # sqrt has an infinite derivative at the padded slots' v == 0: the
    # double where keeps the value (sqrt(1)·0 == sqrt(0)) and zeroes the
    # cotangent there, so d/d log_var stays finite at padded slots
    real = mask[None, :, :] > 0
    v_safe = torch.where(real, v, torch.ones_like(v))
    sqrt_v = torch.sqrt(v_safe) * mask[None, :, :]
    d05_ib_k0xz = ops.iB_K0xz * sqrt_v[..., None]  # [L, P, T, M]
    g = torch.einsum("lptm,lptn->lmn", d05_ib_k0xz, d05_ib_k0xz)
    s1, logdet_b, qf1, pvec, t1, logdet_d, tr_ib_d, g, n_real = view.data_sums(
        ops.K0zx_iB_K0xz, ops.logdet_B, qf1, pvec, _trace_ib_k0(ops), logdet_d, tr_ib_d, g,
        torch.sum(mask).to(dtype))

    lw, logdet_sigma = _w_cholesky(ops, s1, logdet_b, view)
    qf = _sigma_quadform(lw, qf1, pvec)
    tr = _nystrom_trace(ops, t1, s1)
    eye_m = torch.eye(g.shape[-1], dtype=g.dtype, device=g.device)
    tr_iw_g = torch.sum(la.cho_solve(lw, g) * eye_m, dim=(-2, -1))
    tr_isigma_d = tr_ib_d - tr_iw_g
    return 0.5 * (tr_isigma_d + qf - n_real + logdet_sigma - logdet_d + tr)


class NaturalGradients(NamedTuple):
    grad_m: torch.Tensor  # [L, M, 1]
    grad_H: torch.Tensor  # [L, M, M]
    iH: Optional[torch.Tensor] = None  # [L, M, M] H⁻¹, reused by the update


def _scalar(x, dtype, device) -> torch.Tensor:
    """``x`` as a 0-dim tensor on ``device``: a tensor is cast, a Python
    number is filled on the device (no host-to-device copy, which a CUDA
    graph's capture refuses)."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype=dtype, device=device)
    return torch.full((), x, dtype=dtype, device=device)


@_full_precision
def minibatch_kld(
    ops: GPBlockOperators,
    m: torch.Tensor,
    H: torch.Tensor,
    mu_b: torch.Tensor,
    log_var_b: torch.Tensor,
    P_tot,
    P_batch,
    N_tot,
    natural_gradient: bool = False,
    H_factor: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    view: Local = LOCAL,
) -> Tuple[torch.Tensor, Optional[NaturalGradients]]:
    """Unbiased SVI estimate of the KL upper bound (Hensman training).

    ``m [L, M, 1]`` and ``H [L, M, M]`` (PSD) are the variational parameters
    of the inducing values; ``mu_b``/``log_var_b [P, T, L]`` the encoder's
    moments. Returns the scalar bound and, with ``natural_gradient``, the
    closed-form gradients w.r.t. m and H without the ``P_tot/P_batch``
    rescaling, computed outside autograd. ``H_factor`` is a precomputed
    ``(chol(H), H⁻¹)``, as ``gp_block_operators`` returns it for
    ``extra_spd=H``.

    On one rank's shard (``view``, :mod:`lvae_torch.ops.shard`) the bound is
    that rank's share: the A–F terms, sums over (latent, subject), count on
    every rank whose subjects and latents they are; KL(q(u)‖p(u)) and the
    ``−L·N_tot/2`` constant, sums over latents, on one rank of each latent
    shard. ``P_batch`` is the whole batch's count of real subjects. The
    natural gradients' subject sums are summed over the ranks first.
    """
    mask = ops.mask
    latent_dim = ops.K0xz.shape[0]
    m_ind = ops.K0zz.shape[-1]
    dtype, dev = mu_b.dtype, mu_b.device

    mu = (mu_b * mask[..., None]).permute(2, 0, 1)  # [L, P, T]
    v = (torch.exp(log_var_b) * mask[..., None]).permute(2, 0, 1)
    log_v_masked = (log_var_b * mask[..., None]).permute(2, 0, 1)

    if H_factor is not None:
        lh, ih = H_factor
    else:
        lh, ih = la.cholesky_and_inverse(H)

    ik0zz_m = ops.iK0zz @ m  # [L, M, 1]
    r = torch.einsum("lptm,lm->lpt", ops.K0xz, ik0zz_m[..., 0]) - mu
    r = r * mask[None]

    a_term = torch.einsum("lpt,lptu,lpu->", r, ops.iB, r)
    eye_t = torch.eye(ops.iB.shape[-1], dtype=v.dtype, device=dev)
    b_term = torch.sum(ops.iB * (eye_t * v[..., :, None]))
    c_term = torch.sum(ops.logdet_B)
    if ops.tr_iB_K0 is not None:
        tr_ib_k0 = torch.sum(ops.tr_iB_K0)
    else:
        tr_ib_k0 = torch.einsum("lptu,lptu->", ops.iB, ops.K0_st)
    d_term = tr_ib_k0 - torch.einsum("lmn,lmn->", ops.K0zx_iB_K0xz, ops.iK0zz)
    e_mid = ops.iK0zz @ H @ ops.iK0zz
    e_term = torch.einsum("lnm,lmn->", e_mid, ops.K0zx_iB_K0xz)
    f_term = torch.sum(log_v_masked)

    # KL(q(u) ‖ p(u))
    tr1 = torch.einsum("lmn,lnm->", ops.iK0zz, H)
    qf1 = torch.einsum("lmo,lmo->", m, ops.iK0zz @ m)
    logdet_k = torch.sum(ops.logdet_K0zz)
    logdet_h = torch.sum(la.logdet_from_chol(lh, batch_dims=1))
    kld_qu_pu = 0.5 * (tr1 + qf1 - latent_dim * m_ind + logdet_k - logdet_h)

    scale = _scalar(P_tot, dtype, dev) / _scalar(P_batch, dtype, dev)
    w_pairs, w_latents = view.weight("data", "latent"), view.weight("latent")
    kld_total = (
        w_pairs * (scale * 0.5 * (a_term + b_term + c_term + d_term + e_term - f_term))
        + w_latents * kld_qu_pu
        - w_latents * (latent_dim * _scalar(N_tot, dtype, dev) / 2.0)
    )

    ng = None
    if natural_gradient:
        with torch.no_grad():
            ik0zz = ops.iK0zz.detach()
            k0zx_ib_mu = torch.einsum(
                "lptm,lptu,lpu->lm", ops.K0xz.detach(), ops.iB.detach(), mu.detach()
            )
            k0zx_ib_mu, k0zx_ib_k0xz = view.data_sums(k0zx_ib_mu, ops.K0zx_iB_K0xz.detach())
            ng_a = ik0zz @ k0zx_ib_mu[..., None]  # [L, M, 1]
            ng_b = ik0zz @ k0zx_ib_k0xz @ ik0zz + ik0zz
            grad_m = -ng_a + ng_b @ m.detach()
            grad_h = 0.5 * (-ih.detach() + ng_b)
        ng = NaturalGradients(grad_m=grad_m, grad_H=grad_h, iH=ih.detach())

    return kld_total, ng


@_full_precision
@torch.no_grad()
def natural_gradient_proposal(
    m: torch.Tensor,
    H: torch.Tensor,
    ng: NaturalGradients,
    lr: float,
    view: Local = LOCAL,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The natural-gradient step on (m, H) in inverse space and the guard's
    decision: ``(m_new, H_new, ok)``, with ``ok`` a device boolean (see
    :func:`natural_gradient_update`, which applies it)."""
    if ng.iH is not None:
        ih = ng.iH
    else:
        _, ih = la.cholesky_and_inverse(H)
    ih_new = ih + lr * (ng.grad_H + ng.grad_H.mT)
    _, h_new = la.cholesky_and_inverse(ih_new)
    m_new = h_new @ (ih @ m - lr * (ng.grad_m - 2.0 * (ng.grad_H @ m)))
    l_h_new, _ = la.cholesky_and_inverse(h_new)
    ok = view.all_latents(torch.isfinite(m_new).all() & torch.isfinite(h_new).all()
                          & torch.isfinite(l_h_new).all())
    return m_new, h_new, ok


@_full_precision
@torch.no_grad()
def natural_gradient_update(
    m: torch.Tensor,
    H: torch.Tensor,
    ng: NaturalGradients,
    lr: float,
    view: Local = LOCAL,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Natural-gradient step on (m, H) in inverse space:
    ``iH_new = iH + lr (grad_H + grad_Hᵀ)``, ``H ← iH_new⁻¹``,
    ``m ← H (iH m − lr (grad_m − 2 grad_H m))``. Outside autograd.

    If the step leaves the PSD cone (the factor of ``iH_new`` is NaN), or
    the new H does not factor in the working precision, the previous (m, H)
    are kept; the choice is made on the device, with no host
    synchronisation. The second test is the port's own: the JAX package
    keeps such a step, and every later bound then reads a NaN factor of H
    and every later step is refused (seen in f32 on the card, from the
    reference's nearly singular initial H; ROADMAP queue 3). The guard reads
    every latent of ``view``: on a latent shard a step is kept only where
    every rank's new (m, H) is finite, as one process decides for all L."""
    m_new, h_new, ok = natural_gradient_proposal(m, H, ng, lr, view)
    return torch.where(ok, m_new, m), torch.where(ok, h_new, H)
