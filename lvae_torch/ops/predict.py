"""Sparse-GP posterior prediction of latent trajectories (port of
lvae_tpu.ops.predict).

Given the training cohort's encoded latent means ``mu`` and covariates ``x``,
predict latents at query covariates ``X`` via the sparse additive GP
posterior mean

    Z_pred = K0(X,·) K0zz⁻¹ K0zx μ̃  +  K1(X,·) μ̃,
    μ̃ = Σ⁻¹ μ = (B⁻¹ − B⁻¹ K0xz H⁻¹ K0zx B⁻¹) μ,   H = K0zz + K0zx B⁻¹ K0xz,

batched over latent dims and subjects on the padded ``[P, T_max]`` layout.
``K1`` is block-diagonal over subjects (every kernel1 component carries the
id equality factor), so ``B = K1 + σ²I`` factors per subject: those T×T
blocks go through :func:`lvae_torch.ops.linalg.cholesky_and_inverse`, the
batched Cholesky+inverse kernel on the card.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from lvae_torch.ops import kernels as kx
from lvae_torch.ops import linalg as la
from lvae_torch.ops.linalg import _full_precision
from lvae_torch.ops.shard import LOCAL, Local


class PredictInputs(NamedTuple):
    """Block-layout inputs to :func:`gp_predict`.

    Training cohort: ``xb [P, T, Q]``, ``mask [P, T]``, ``mu_b [P, T, L]``.
    Queries: ``Xb [Pq, Tq, Q]``, ``Xmask [Pq, Tq]``.
    ``align [Pq]`` — index of each query subject's block in the training
    cohort, or -1 when the subject has no training data (the K1 term is zero
    there).
    """

    xb: torch.Tensor
    mask: torch.Tensor
    mu_b: torch.Tensor
    Xb: torch.Tensor
    Xmask: torch.Tensor
    align: torch.Tensor


def _cohort_fold(spec0, spec1, kp0, kp1, noise, xb, mask, mu_b, z, eps, view: Local = LOCAL):
    """Fold the training cohort's block solves once — the shared first half
    of :func:`gp_predict` and :func:`precompute_predict_basis`.

    Returns ``(k0xz [L,P,T,M], k0zz [L,M,M], ib [L,P,T,T], ib_mu [L,P,T],
    h_nojit [L,M,M], c [L,M])`` where ``h_nojit = symmetrize(K0zz + Σ_s
    K0zx_s B_s⁻¹ K0xz_s)`` without the f32 relative jitter and ``c = Σ_s
    K0zx_s B_s⁻¹ μ_s``. K0zz carries the adaptive jitter. On a rank's shard
    (``view``) the subjects are that rank's and the two subject sums are
    summed over the ranks.
    """
    p, t, q = xb.shape
    m_ind = z.shape[0]
    x_flat = xb.reshape(p * t, q)
    k0xz = kx.kernel_matrix(spec0, kp0, x_flat, z, mask1=mask.reshape(p * t))
    latent_dim = k0xz.shape[0]
    k0xz = k0xz.reshape(latent_dim, p, t, m_ind)
    k0zz = kx.add_adaptive_jitter(kx.kernel_matrix(spec0, kp0, z, z), eps, view)

    b = kx.block_b_operator(spec1, kp1, xb, mask, noise)
    _, ib = la.cholesky_and_inverse(b)

    ib_k0xz = ib @ k0xz
    mu = (mu_b * mask[..., None]).permute(2, 0, 1)  # [L, P, T]
    ib_mu = torch.einsum("lptu,lpu->lpt", ib, mu)
    k0zx_ib_k0xz, c = view.data_sums(la.cohort_gram(k0xz, ib_k0xz),
                                     torch.einsum("lptm,lpt->lm", k0xz, ib_mu))
    h_nojit = la.symmetrize(k0zz + k0zx_ib_k0xz)
    return k0xz, k0zz, ib, ib_mu, h_nojit, c


@_full_precision
def gp_predict(
    spec0: kx.KernelSpec,
    spec1: kx.KernelSpec,
    kp0: kx.KernelParams,
    kp1: kx.KernelParams,
    noise: torch.Tensor,
    inputs: PredictInputs,
    z: torch.Tensor,
    eps: float = 1e-6,
    view: Local = LOCAL,
) -> torch.Tensor:
    """Posterior mean latents at the query blocks: ``[Pq, Tq, L]``.

    On a rank's shard (``view``, :func:`lvae_torch.parallel.mesh.sharded_gp_predict`)
    the parameters and ``mu_b`` hold the rank's latents, the query blocks
    the rank's queries, and the training blocks the whole cohort, of which
    the rank folds its subjects (``view.rows``)."""
    xb, mask, mu_b = inputs.xb, inputs.mask, inputs.mu_b
    Xb, Xmask, align = inputs.Xb, inputs.Xmask, inputs.align
    q = xb.shape[2]
    pq, tq, _ = Xb.shape
    dtype = xb.dtype
    mask = mask.to(dtype)
    Xmask = Xmask.to(dtype)

    X_flat = Xb.reshape(pq * tq, q)
    Xmask_flat = Xmask.reshape(pq * tq)

    rows = view.rows
    k0xz, k0zz, ib, ib_mu, h_nojit, c = _cohort_fold(
        spec0, spec1, kp0, kp1, noise, xb[rows], mask[rows], mu_b[rows], z, eps, view
    )
    latent_dim = k0xz.shape[0]
    k0Xz = kx.kernel_matrix(spec0, kp0, X_flat, z, mask1=Xmask_flat)

    h = kx.add_rel_jitter(h_nojit, view=view)
    lh = la.cholesky(h)

    sol = la.cho_solve(lh, c[..., None])[..., 0]  # H⁻¹ K0zx B⁻¹ μ
    back = torch.einsum("lptm,lm->lpt", k0xz, sol)  # K0xz H⁻¹ ...
    mu_tilde = ib_mu - torch.einsum("lptu,lpu->lpt", ib, back)  # [L, P, T]

    # shared term over all queries
    (d,) = view.data_sums(torch.einsum("lptm,lpt->lm", k0xz, mu_tilde))
    # a query's aligned block may be another rank's subject
    mu_tilde = view.gather_rows(mu_tilde, xb.shape[0], dim=1)
    lk0zz = la.cholesky(k0zz)
    shared = torch.einsum(
        "lnm,lm->ln", k0Xz, la.cho_solve(lk0zz, d[..., None])[..., 0]
    )  # [L, Pq*Tq]

    # per-subject K1 term: gather the aligned training block for each query
    has_train = (align >= 0).to(dtype)  # [Pq]
    safe_align = torch.clamp(align, min=0)
    xb_al = xb[safe_align]  # [Pq, T, Q]
    mask_al = mask[safe_align] * has_train[:, None]
    mu_tilde_al = mu_tilde[:, safe_align] * mask_al[None]  # [L, Pq, T]

    k1_cross = kx.kernel_matrix(spec1, kp1, Xb, xb_al, Xmask, mask_al)  # [L, Pq, Tq, T]
    id_term = torch.einsum("lqat,lqt->lqa", k1_cross, mu_tilde_al)  # [L, Pq, Tq]

    z_pred = shared.reshape(latent_dim, pq, tq) + id_term
    return z_pred.permute(1, 2, 0)  # [Pq, Tq, L]


def build_predict_inputs(
    train_labels: np.ndarray,
    train_mu: np.ndarray,
    test_labels: np.ndarray,
    id_covariate: int,
    dtype=np.float32,
    device="cpu",
) -> Tuple[PredictInputs, np.ndarray, np.ndarray]:
    """Host-side packing of flat arrays into aligned prediction blocks on
    ``device``.

    Returns ``(inputs, test_index, test_mask)`` where ``test_index/test_mask``
    map the query blocks back to flat test rows (for scattering ``Z_pred``).
    """
    from lvae_torch.data.blocks import build_subject_blocks

    tr = build_subject_blocks(train_labels, id_covariate)
    te = build_subject_blocks(test_labels, id_covariate)
    train_pos = {float(s): i for i, s in enumerate(tr.subject_ids)}
    align = np.asarray(
        [train_pos.get(float(s), -1) for s in te.subject_ids], dtype=np.int64
    )
    xb = np.asarray(train_labels, dtype=dtype)[tr.index] * tr.mask[..., None]
    Xb = np.asarray(test_labels, dtype=dtype)[te.index] * te.mask[..., None]
    mu_b = np.asarray(train_mu, dtype=dtype)[tr.index] * tr.mask[..., None]

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    inputs = PredictInputs(
        xb=t(xb.astype(dtype)),
        mask=t(tr.mask.astype(dtype)),
        mu_b=t(mu_b.astype(dtype)),
        Xb=t(Xb.astype(dtype)),
        Xmask=t(te.mask.astype(dtype)),
        align=t(align),
    )
    return inputs, te.index, te.mask


def _row_scatter(te_index: np.ndarray, te_mask: np.ndarray, device):
    """``(rows, slots)``: the flat test rows and the block slots
    (``[Pq·Tq]`` order) they come from, as int64 tensors on ``device``;
    :func:`~lvae_torch.data.blocks.scatter_to_flat` on the device."""
    slots = np.flatnonzero(te_mask.reshape(-1))
    rows = te_index.reshape(-1)[slots].astype(np.int64)
    return (torch.as_tensor(rows, device=device),
            torch.as_tensor(slots.astype(np.int64), device=device))


def _scatter_rows(zb: torch.Tensor, rows: torch.Tensor, slots: torch.Tensor,
                  n: int) -> torch.Tensor:
    """Block values ``zb [Pq, Tq, L]`` at the ``n`` flat test rows ``[n, L]``
    (:func:`_row_scatter`'s ``rows`` and ``slots``)."""
    flat = zb.reshape(-1, zb.shape[-1])
    out = torch.zeros((n, flat.shape[1]), dtype=flat.dtype, device=flat.device)
    return out.index_copy_(0, rows, flat.index_select(0, slots))


def _predict_program(spec0, spec1, eps: float, n: int):
    """The posterior program: :func:`gp_predict` on the block inputs, at the
    ``n`` flat test rows ``[n, L]``."""
    def program(s0, l0, s1, l1, noise, xb, mask, mu_b, Xb, Xmask, align, z, rows, slots):
        zb = gp_predict(spec0, spec1, kx.KernelParams(s0, l0), kx.KernelParams(s1, l1), noise,
                        PredictInputs(xb, mask, mu_b, Xb, Xmask, align), z, eps)
        return _scatter_rows(zb, rows, slots, n)

    return program


def predict_latent_rows(
    spec0,
    spec1,
    kp0,
    kp1,
    noise,
    train_labels: np.ndarray,
    train_mu: np.ndarray,
    test_labels: np.ndarray,
    z,
    id_covariate: int,
    eps: float = 1e-6,
    mesh=None,
) -> torch.Tensor:
    """``Z_pred [N_test, L]`` on the device of ``z`` (the flat arrays are
    host numpy, packed by :func:`build_predict_inputs`): one program
    (``evaluation/programs.py``), on the card a replay of the posterior
    captured at the blocks' shapes, with K2 inside at the fold. With
    ``mesh`` the posterior runs mesh-parallel and eagerly
    (:func:`lvae_torch.parallel.mesh.sharded_gp_predict`), and every rank
    gets the whole result."""
    from lvae_torch.evaluation import programs

    train_mu = np.asarray(train_mu)
    test_labels = np.asarray(test_labels)
    inputs, te_index, te_mask = build_predict_inputs(
        train_labels, train_mu, test_labels, id_covariate,
        dtype=train_mu.dtype, device=z.device,
    )
    n = test_labels.shape[0]
    rows, slots = _row_scatter(te_index, te_mask, z.device)
    if mesh is not None:
        from lvae_torch.parallel.mesh import sharded_gp_predict

        zb = sharded_gp_predict(spec0, spec1, kp0, kp1, noise, inputs, z, mesh, eps=eps)
        return _scatter_rows(zb, rows, slots, n)
    return programs.run("gp_predict", _predict_program(spec0, spec1, eps, n),
                        [*kp0, *kp1, noise, *inputs, z, rows, slots], (n, noise.shape[0]),
                        inputs.xb.dtype, z.device, static=(spec0, spec1, eps, n))


def predict_latents(
    spec0,
    spec1,
    kp0,
    kp1,
    noise,
    train_labels: np.ndarray,
    train_mu: np.ndarray,
    test_labels: np.ndarray,
    z,
    id_covariate: int,
    eps: float = 1e-6,
    mesh=None,
) -> np.ndarray:
    """Flat-array convenience wrapper: :func:`predict_latent_rows` on the
    host, ``Z_pred [N_test, L]`` (one copy)."""
    from lvae_torch.train.graph import finish_host_copy, start_host_copy

    zp = predict_latent_rows(spec0, spec1, kp0, kp1, noise, train_labels, train_mu,
                             test_labels, z, id_covariate, eps, mesh)
    return finish_host_copy(start_host_copy(zp)).numpy()


# ---------------------------------------------------------------------------
# Incremental serving path: precomputed basis operators + per-request
# low-rank extension. Same math as gp_predict — the shared term reduces to
#
#     shared = K0(X,z) H⁻¹ c,   H = K0zz + Σ_s K0zx_s B_s⁻¹ K0xz_s,
#     c = Σ_s K0zx_s B_s⁻¹ μ_s
#
# so a request that adds K observed subjects contributes K rank-M updates to
# H and K terms to c: the O(P) per-subject block solves over the training
# cohort are done once, when the basis is folded, not per request.


class PredictBasis(NamedTuple):
    """Cohort-level operators, precomputed once for serving.

    ``h_nojit`` excludes the f32 relative jitter on H, which is applied
    after the request's low-rank update.
    """

    h_nojit: torch.Tensor  # [L, M, M] K0zz(+jitter) + Σ_s K0zx_s B_s⁻¹ K0xz_s
    c: torch.Tensor  # [L, M]    Σ_s K0zx_s B_s⁻¹ μ_s


@_full_precision
def precompute_predict_basis(
    spec0: kx.KernelSpec,
    spec1: kx.KernelSpec,
    kp0: kx.KernelParams,
    kp1: kx.KernelParams,
    noise: torch.Tensor,
    xb: torch.Tensor,
    mask: torch.Tensor,
    mu_b: torch.Tensor,
    z: torch.Tensor,
    eps: float = 1e-6,
) -> PredictBasis:
    """Fold the training cohort's block solves into (H, c) once."""
    mask = mask.to(xb.dtype)
    _, _, _, _, h_nojit, c = _cohort_fold(
        spec0, spec1, kp0, kp1, noise, xb, mask, mu_b, z, eps
    )
    return PredictBasis(h_nojit=h_nojit, c=c)


def _fold_new_subjects(spec0, spec1, kp0, kp1, noise, x_new, mask_new, mu_new, z):
    """Per-subject fold of K new subjects' blocks — the shared core of the
    per-request extension and the basis refresh.

    Returns ``(k0xz_n [L,K,T,M], ib_n [L,K,T,T], ib_mu [L,K,T],
    h_delta [L,M,M], c_delta [L,M])``: the exact per-subject terms of
    :func:`_cohort_fold`'s sums, so adding them to a basis equals refolding
    the union cohort.
    """
    k, t, q = x_new.shape
    m_ind = z.shape[0]
    x_flat = x_new.reshape(k * t, q)
    k0xz_n = kx.kernel_matrix(spec0, kp0, x_flat, z, mask1=mask_new.reshape(k * t))
    latent_dim = k0xz_n.shape[0]
    k0xz_n = k0xz_n.reshape(latent_dim, k, t, m_ind)  # [L,K,T,M]

    b_n = kx.block_b_operator(spec1, kp1, x_new, mask_new, noise)
    _, ib_n = la.cholesky_and_inverse(b_n)  # [L, K, T, T]

    ib_k0xz = ib_n @ k0xz_n  # [L, K, T, M]
    h_delta = torch.einsum("lktm,lktn->lmn", k0xz_n, ib_k0xz)
    mu = (mu_new * mask_new[..., None]).permute(2, 0, 1)  # [L, K, T]
    ib_mu = torch.einsum("lktu,lku->lkt", ib_n, mu)
    c_delta = torch.einsum("lktm,lkt->lm", k0xz_n, ib_mu)
    return k0xz_n, ib_n, ib_mu, h_delta, c_delta


@_full_precision
def extend_predict_basis(
    spec0: kx.KernelSpec,
    spec1: kx.KernelSpec,
    kp0: kx.KernelParams,
    kp1: kx.KernelParams,
    noise: torch.Tensor,
    basis: PredictBasis,
    x_new: torch.Tensor,
    mask_new: torch.Tensor,
    mu_new: torch.Tensor,
    z: torch.Tensor,
) -> PredictBasis:
    """Basis refresh: fold K new *training* subjects into the cohort basis.

    ``(H, c)`` are sums over subject blocks, so the result equals
    :func:`precompute_predict_basis` on the union cohort at a cost of K
    block solves, flat in the basis cohort size. A subject folded in is a
    training subject from then on: later requests must not send it as new.
    """
    mask_new = mask_new.to(x_new.dtype)
    _, _, _, h_delta, c_delta = _fold_new_subjects(
        spec0, spec1, kp0, kp1, noise, x_new, mask_new, mu_new, z
    )
    return PredictBasis(
        h_nojit=la.symmetrize(basis.h_nojit + h_delta), c=basis.c + c_delta
    )


def _pack_basis(basis: PredictBasis) -> torch.Tensor:
    """``(h_nojit [L,M,M], c [L,M])`` as one tensor ``[L, M, M+1]``, ``c``
    its last column: the fold's and the extension's one output."""
    return torch.cat([basis.h_nojit, basis.c[..., None]], dim=-1)


def _basis_views(packed: torch.Tensor) -> PredictBasis:
    m = packed.shape[-2]
    return PredictBasis(h_nojit=packed[..., :m], c=packed[..., m])


def _unpack_basis(packed: torch.Tensor) -> PredictBasis:
    """The basis of a :func:`_pack_basis` tensor, as contiguous copies."""
    return PredictBasis(*(t.contiguous() for t in _basis_views(packed)))


def _fold_program(spec0, spec1, eps: float):
    """The basis fold as a program of its tensors: :func:`precompute_predict_basis`,
    packed."""
    def program(s0, l0, s1, l1, noise, xb, mask, mu_b, z):
        return _pack_basis(precompute_predict_basis(
            spec0, spec1, kx.KernelParams(s0, l0), kx.KernelParams(s1, l1), noise, xb, mask,
            mu_b, z, eps=eps))

    return program


def _extend_program(spec0, spec1):
    """The basis extension as a program of its tensors (the basis packed):
    :func:`extend_predict_basis`, packed."""
    def program(s0, l0, s1, l1, noise, packed, xb, mask, mu_b, z):
        return _pack_basis(extend_predict_basis(
            spec0, spec1, kx.KernelParams(s0, l0), kx.KernelParams(s1, l1), noise,
            _basis_views(packed), xb, mask, mu_b, z))

    return program


def fold_basis(spec0, spec1, kp0, kp1, noise, xb, mask, mu_b, z, eps: float = 1e-6
               ) -> PredictBasis:
    """:func:`precompute_predict_basis` as one program
    (``evaluation/programs.py``, a model-free GP program keyed on the
    specs, ``eps`` and the blocks' shapes): on the card a replay of the
    fold captured at its first call, K2 inside it; the JAX package's
    ``_fold_basis_jit``. Returns fresh tensors."""
    from lvae_torch.evaluation import programs

    lat, m = kp0.raw_scale.shape[0], z.shape[0]
    return _unpack_basis(programs.run(
        "fold_basis", _fold_program(spec0, spec1, eps), [*kp0, *kp1, noise, xb, mask, mu_b, z],
        (lat, m, m + 1), xb.dtype, z.device, static=(spec0, spec1, eps)))


def extend_basis(spec0, spec1, kp0, kp1, noise, basis: PredictBasis, xb, mask, mu_b, z
                 ) -> PredictBasis:
    """:func:`extend_predict_basis` as one program (as :func:`fold_basis`;
    the basis is an input, copied in, so the program reads no caller's
    buffers): the JAX package's ``_extend_basis_jit``. Returns fresh
    tensors."""
    from lvae_torch.evaluation import programs

    packed = _pack_basis(basis)
    return _unpack_basis(programs.run(
        "extend_basis", _extend_program(spec0, spec1),
        [*kp0, *kp1, noise, packed, xb, mask, mu_b, z], tuple(packed.shape), packed.dtype,
        z.device, static=(spec0, spec1)))


@_full_precision
def gp_predict_extend_batch(
    spec0: kx.KernelSpec,
    spec1: kx.KernelSpec,
    kp0: kx.KernelParams,
    kp1: kx.KernelParams,
    noise: torch.Tensor,
    basis: PredictBasis,
    x_new: torch.Tensor,
    mask_new: torch.Tensor,
    mu_new: torch.Tensor,
    Xq: torch.Tensor,
    Xq_mask: torch.Tensor,
    z: torch.Tensor,
) -> torch.Tensor:
    """Posterior latents after observing K new subjects in one request.

    ``x_new [K, T, Q]`` / ``mask_new [K, T]`` / ``mu_new [K, T, L]`` — the
    new subjects' observed covariates and encoded latent means;
    ``Xq [K, Tq, Q]`` / ``Xq_mask [K, Tq]`` — query block k belongs to new
    subject k (its id kernel carries the K1 term) or is data-free
    (``mask_new[k]`` all zero → shared term only). Returns ``[K, Tq, L]``.
    Equal to the full recompute with the K subjects appended to the cohort.
    """
    k, t, q = x_new.shape
    tq = Xq.shape[1]
    dtype = x_new.dtype
    mask_new = mask_new.to(dtype)
    Xq_mask = Xq_mask.to(dtype)

    k0xz_n, ib_n, ib_mu, h_delta, c_delta = _fold_new_subjects(
        spec0, spec1, kp0, kp1, noise, x_new, mask_new, mu_new, z
    )
    latent_dim = k0xz_n.shape[0]
    m_ind = z.shape[0]
    k0Xz = kx.kernel_matrix(
        spec0, kp0, Xq.reshape(k * tq, q), z, mask1=Xq_mask.reshape(k * tq)
    ).reshape(latent_dim, k, tq, m_ind)

    h = kx.add_rel_jitter(la.symmetrize(basis.h_nojit + h_delta))
    lh = la.cholesky(h)
    c = basis.c + c_delta

    sol = la.cho_solve(lh, c[..., None])[..., 0]  # H⁻¹ c  [L, M]
    shared = torch.einsum("lkam,lm->lka", k0Xz, sol)  # [L, K, Tq]

    # each new subject's μ̃ block and its K1 cross-term to its own queries
    back = torch.einsum("lktm,lm->lkt", k0xz_n, sol)
    mu_tilde_n = ib_mu - torch.einsum("lktu,lku->lkt", ib_n, back)  # [L, K, T]
    k1_cross = kx.kernel_matrix(spec1, kp1, Xq, x_new, Xq_mask, mask_new)  # [L, K, Tq, T]
    id_term = torch.einsum("lkat,lkt->lka", k1_cross, mu_tilde_n)

    return (shared + id_term).permute(1, 2, 0)  # [K, Tq, L]


def gp_predict_extend(
    spec0: kx.KernelSpec,
    spec1: kx.KernelSpec,
    kp0: kx.KernelParams,
    kp1: kx.KernelParams,
    noise: torch.Tensor,
    basis: PredictBasis,
    x_new: torch.Tensor,
    mask_new: torch.Tensor,
    mu_new: torch.Tensor,
    Xq: torch.Tensor,
    Xq_mask: torch.Tensor,
    z: torch.Tensor,
) -> torch.Tensor:
    """Posterior latents at ``Xq [Tq, Q]`` after observing ONE new subject
    (``x_new [T, Q]``, ``mask_new [T]``, ``mu_new [T, L]``): the K=1 view of
    :func:`gp_predict_extend_batch`."""
    return gp_predict_extend_batch(
        spec0, spec1, kp0, kp1, noise, basis,
        x_new[None], mask_new[None], mu_new[None], Xq[None], Xq_mask[None], z,
    )[0]
