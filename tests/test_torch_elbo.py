"""lvae_torch.ops.elbo (the Hensman bound and its natural gradients, and
the bounds of the standard regime: kl_closed, gp_elbo, dubo) against the
reference goldens and lvae_tpu, on the CPU in float64.

The goldens ``tests/goldens/reference_goldens.npz`` were produced by the
reference implementation; the port is held to them at the tolerances of
``tests/test_parity_reference.py``: rtol 2e-8 on the KL bound, 1e-7 on the
natural gradients (1e-6 for the fuzzed specs), and, along the 5-step
natural-gradient trajectory, 1e-7 on the bound and 1e-5 on (m, H); and
2e-8 on the per-dim kl_closed, gp_elbo and dubo. Against lvae_tpu on the
same inputs the operators, the bounds, their gradients and the
natural-gradient update agree at rtol 1e-8 (summation order only).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvae_tpu.data.blocks import build_subject_blocks
from lvae_tpu.ops import elbo as jeb
from lvae_tpu.ops import kernels as jkx
from lvae_torch.ops import elbo as teb
from lvae_torch.ops import kernels as tkx

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens", "reference_goldens.npz")
SPEC_A = dict(
    cat_kernel=[2], sqexp_kernel=[0],
    cat_int_kernel=[
        {"cont_covariate": 0, "cat_covariate": 2},
        {"cont_covariate": 0, "cat_covariate": 3},
        {"cont_covariate": 1, "cat_covariate": 4},
    ],
)
SPEC_B = dict(
    cat_kernel=[2], bin_kernel=[4], sqexp_kernel=[0, 1],
    cat_int_kernel=[{"cont_covariate": 0, "cat_covariate": 2}],
    bin_int_kernel=[{"cont_covariate": 0, "bin_covariate": 4}],
    covariate_missing_val=[{"covariate": 1, "mask": 6}],
)
FUZZ_SPECS = [
    dict(cat_kernel=[2, 3], sqexp_kernel=[0, 1]),
    dict(cat_kernel=[2], bin_kernel=[3, 4],
         cat_int_kernel=[{"cont_covariate": 1, "cat_covariate": 2}]),
    dict(cat_kernel=[2, 5], bin_kernel=[4], sqexp_kernel=[0],
         cat_int_kernel=[{"cont_covariate": 0, "cat_covariate": 5}],
         bin_int_kernel=[{"cont_covariate": 1, "bin_covariate": 3}]),
    dict(cat_kernel=[2], sqexp_kernel=[0, 1],
         cat_int_kernel=[{"cont_covariate": 0, "cat_covariate": 2},
                         {"cont_covariate": 1, "cat_covariate": 2}]),
]


@pytest.fixture(scope="module")
def g():
    return np.load(GOLDENS)


def t(x):
    return torch.tensor(np.asarray(x), dtype=torch.float64)


def params_from(scales, ls):
    """Raw params whose constrained values equal the golden's."""
    return tkx.KernelParams(raw_scale=tkx.unconstrain(t(scales)),
                            raw_lengthscale=tkx.unconstrain(t(ls)))


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b) / (np.abs(b) + 1e-12))


def golden_kld(g, spec_args, prefix, xb, z, mu_b, lv_b, p_tot, p_batch, n_tot,
               eps, mask=None):
    spec0, spec1 = tkx.split_kernel_spec(id_covariate=2, **spec_args)
    kp0 = params_from(g[f"{prefix}_scales0"], g[f"{prefix}_ls0"])
    kp1 = params_from(g[f"{prefix}_scales1"], g[f"{prefix}_ls1"])
    ops = teb.gp_block_operators(spec0, spec1, kp0, kp1, t(g["noise"]), t(xb), t(z),
                                 mask=mask, eps=eps)
    return ops, teb.minibatch_kld(ops, t(g["m_var"]), t(g["H_var"]), t(mu_b), t(lv_b),
                                  p_tot, p_batch, n_tot, natural_gradient=True)


def test_minibatch_kld_full_batch_matches_goldens(g):
    P, T, L = int(g["P"]), int(g["T"]), g["mu"].shape[1]
    _, (kld, ng) = golden_kld(
        g, SPEC_A, "A", g["x_fix"].reshape(P, T, -1), g["z"], g["mu"].reshape(P, T, L),
        g["log_var"].reshape(P, T, L), P, P, P * T, float(g["eps"]),
    )
    assert rel(kld, g["mb_kld"]) < 2e-8
    assert rel(ng.grad_m, g["mb_grad_m"]) < 1e-7
    assert rel(ng.grad_H, g["mb_grad_H"]) < 1e-7


def test_minibatch_kld_subject_subset_matches_goldens(g):
    """P_batch < P_tot: the SVI rescaling."""
    P, T, L = int(g["P"]), int(g["T"]), g["mu"].shape[1]
    p_b = int(g["mbb_P_batch"])
    sel = g["x_fix"][:, 2] < p_b
    _, (kld, ng) = golden_kld(
        g, SPEC_A, "A", g["x_fix"][sel].reshape(p_b, T, -1), g["z"],
        g["mu"][sel].reshape(p_b, T, L), g["log_var"][sel].reshape(p_b, T, L),
        P, p_b, P * T, float(g["eps"]),
    )
    assert rel(kld, g["mbb_kld"]) < 2e-8
    assert rel(ng.grad_m, g["mbb_grad_m"]) < 1e-7
    assert rel(ng.grad_H, g["mbb_grad_H"]) < 1e-7


def test_minibatch_kld_varying_T_matches_goldens(g):
    """The masked padded-block path equals the reference's per-subject loop
    on a ragged cohort."""
    blocks = build_subject_blocks(g["x_var"], 2)
    m = blocks.mask[..., None]
    _, (kld, ng) = golden_kld(
        g, SPEC_A, "A", g["x_var"][blocks.index] * m, g["z"], g["mu_var"][blocks.index] * m,
        g["log_var_var"][blocks.index] * m, blocks.num_subjects, blocks.num_subjects,
        g["x_var"].shape[0], float(g["eps"]), mask=t(blocks.mask),
    )
    assert rel(kld, g["it_kld"]) < 2e-8
    assert rel(ng.grad_m, g["it_grad_m"]) < 1e-7
    assert rel(ng.grad_H, g["it_grad_H"]) < 1e-7


def test_minibatch_kld_missing_masks_spec_matches_goldens(g):
    P, T, L = int(g["P"]), int(g["T"]), g["mu"].shape[1]
    _, (kld, ng) = golden_kld(
        g, SPEC_B, "B", g["x_B"].reshape(P, T, -1), g["z_B"], g["mu"].reshape(P, T, L),
        g["log_var"].reshape(P, T, L), P, P, P * T, float(g["eps_B"]),
    )
    assert rel(kld, g["Bspec_kld"]) < 2e-8
    assert rel(ng.grad_m, g["Bspec_grad_m"]) < 1e-7
    assert rel(ng.grad_H, g["Bspec_grad_H"]) < 1e-7


@pytest.mark.parametrize("fi", range(len(FUZZ_SPECS)))
def test_minibatch_kld_fuzz_specs_match_goldens(g, fi):
    P, T, L = int(g["P"]), int(g["T"]), g["mu"].shape[1]
    _, (kld, ng) = golden_kld(
        g, FUZZ_SPECS[fi], f"fz{fi}", g["x_fix"].reshape(P, T, -1), g["z"],
        g["mu"].reshape(P, T, L), g["log_var"].reshape(P, T, L), P, P, P * T, 1e-4,
    )
    assert rel(kld, g[f"fz{fi}_kld"]) < 2e-8
    assert rel(ng.grad_m, g[f"fz{fi}_grad_m"]) < 1e-6
    assert rel(ng.grad_H, g[f"fz{fi}_grad_H"]) < 1e-6


def test_natural_gradient_trajectory_matches_goldens(g):
    """5 natural-gradient steps on (m, H) equal the reference loop's."""
    P, T, L = int(g["P"]), int(g["T"]), g["mu"].shape[1]
    ops, _ = golden_kld(
        g, SPEC_A, "A", g["x_fix"].reshape(P, T, -1), g["z"], g["mu"].reshape(P, T, L),
        g["log_var"].reshape(P, T, L), P, P, P * T, float(g["eps"]),
    )
    mu_b, lv_b = t(g["mu"].reshape(P, T, L)), t(g["log_var"].reshape(P, T, L))
    m, H = t(g["m_var"]), t(g["H_var"])
    for step in range(5):
        kld, ng = teb.minibatch_kld(ops, m, H, mu_b, lv_b, P, P, P * T, natural_gradient=True)
        assert rel(kld, g["ng_kld_traj"][step]) < 1e-7
        m, H = teb.natural_gradient_update(m, H, ng, float(g["ng_lr"]))
        assert rel(m, g["ng_m_traj"][step]) < 1e-5
        assert rel(H, g["ng_H_traj"][step]) < 1e-5


# ------------------------------------------------------- against lvae_tpu
def tiny_inputs(seed=0, s=4, t_len=5, latent=3, m_ind=6, ragged=True):
    """A ragged batch (a short subject, a ghost) in the config's layout, or
    with ``ragged=False`` the same batch with every frame real."""
    rng = np.random.default_rng(seed)
    xb = np.zeros((s, t_len, 6))
    xb[:, :, 0] = np.arange(t_len)[None] + rng.uniform(size=(s, 1))
    xb[:, :, 1] = rng.normal(size=(s, t_len))
    xb[:, :, 2] = np.arange(s)[:, None]
    xb[:, :, 3:] = rng.integers(0, 2, size=(s, 1, 3))
    mask = np.ones((s, t_len))
    if ragged:
        mask[1, 3:] = 0.0
        mask[3] = 0.0
    xb *= mask[..., None]
    z = xb[0].copy()[:m_ind] if m_ind <= t_len else np.concatenate(
        [xb[0], xb[2]], axis=0)[:m_ind]
    z[:, 0] = np.linspace(0.0, 6.0, m_ind)
    c0, c1 = 3, 2
    return dict(
        xb=xb, mask=mask, z=z,
        s0=rng.normal(size=(latent, c0)) * 0.3, l0=rng.normal(size=(latent, c0)) * 0.3 + 1.0,
        s1=rng.normal(size=(latent, c1)) * 0.3, l1=rng.normal(size=(latent, c1)) * 0.3 + 1.0,
        noise=rng.uniform(size=latent) + 0.5,
        mu=rng.normal(size=(s, t_len, latent)), lv=rng.normal(size=(s, t_len, latent)) * 0.1,
        m=rng.normal(size=(latent, m_ind, 1)),
        H=(lambda h: h @ np.swapaxes(h, -1, -2) + 0.5 * np.eye(m_ind))(
            rng.normal(size=(latent, m_ind, m_ind)) / 3),
    )


def both_kld(a, p_batch, extra):
    """(value, grads) of minibatch_kld w.r.t. (s0, l0, s1, l1, noise, mu, lv)
    in both packages, and both natural gradients."""
    js0, js1 = jkx.split_kernel_spec(id_covariate=2, **SPEC_A)
    ts0, ts1 = tkx.split_kernel_spec(id_covariate=2, **SPEC_A)
    keys = ("s0", "l0", "s1", "l1", "noise", "mu", "lv")
    s_dim = a["xb"].shape[0]

    def j_fn(s0, l0, s1, l1, noise, mu, lv):
        H = jnp.asarray(a["H"])
        ops = jeb.gp_block_operators(
            js0, js1, jkx.KernelParams(s0, l0), jkx.KernelParams(s1, l1), noise,
            jnp.asarray(a["xb"]), jnp.asarray(a["z"]), mask=jnp.asarray(a["mask"]),
            eps=1e-5, extra_spd=H if extra else None,
        )
        return jeb.minibatch_kld(
            ops, jnp.asarray(a["m"]), H, mu, lv, P_tot=7, P_batch=p_batch, N_tot=31,
            natural_gradient=True,
            H_factor=(ops.extra_chol, ops.extra_inv) if extra else None,
        )

    (jk, jng), jg = jax.value_and_grad(j_fn, argnums=tuple(range(7)), has_aux=True)(
        *(jnp.asarray(a[k]) for k in keys)
    )
    leaves = [torch.tensor(a[k], requires_grad=True) for k in keys]
    s0, l0, s1, l1, noise, mu, lv = leaves
    H = t(a["H"])
    ops = teb.gp_block_operators(
        ts0, ts1, tkx.KernelParams(s0, l0), tkx.KernelParams(s1, l1), noise,
        t(a["xb"]), t(a["z"]), mask=t(a["mask"]), eps=1e-5, extra_spd=H if extra else None,
    )
    tk, tng = teb.minibatch_kld(
        ops, t(a["m"]), H, mu, lv, P_tot=7, P_batch=torch.tensor(float(p_batch)), N_tot=31,
        natural_gradient=True, H_factor=(ops.extra_chol, ops.extra_inv) if extra else None,
    )
    tk.backward()
    assert s_dim == 4
    return (jk, jng, jg), (tk, tng, [x.grad for x in leaves])


@pytest.mark.parametrize("extra", [True, False], ids=["stacked", "separate"])
def test_minibatch_kld_value_grads_and_natural_gradients_match_jax(extra):
    """P_batch (3 real subjects of 4 rows) < P_tot, a ragged mask, H stacked
    with K0zz or factored apart: the bound, its gradient w.r.t. the raw
    kernel parameters, noise and moments, and the natural gradients."""
    a = tiny_inputs()
    (jk, jng, jg), (tk, tng, tg) = both_kld(a, 3.0, extra)
    np.testing.assert_allclose(tk.item(), float(jk), rtol=1e-8)
    for got, want in zip(tg, jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-8, atol=1e-11)
    for got, want in zip(tng, jng):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-8, atol=1e-11)


def test_gp_block_operators_match_jax():
    a = tiny_inputs(seed=1)
    js0, js1 = jkx.split_kernel_spec(id_covariate=2, **SPEC_A)
    ts0, ts1 = tkx.split_kernel_spec(id_covariate=2, **SPEC_A)
    jops = jeb.gp_block_operators(
        js0, js1, jkx.KernelParams(jnp.asarray(a["s0"]), jnp.asarray(a["l0"])),
        jkx.KernelParams(jnp.asarray(a["s1"]), jnp.asarray(a["l1"])),
        jnp.asarray(a["noise"]), jnp.asarray(a["xb"]), jnp.asarray(a["z"]),
        mask=jnp.asarray(a["mask"]), eps=1e-5, extra_spd=jnp.asarray(a["H"]),
    )
    tops = teb.gp_block_operators(
        ts0, ts1, tkx.KernelParams(t(a["s0"]), t(a["l0"])),
        tkx.KernelParams(t(a["s1"]), t(a["l1"])), t(a["noise"]), t(a["xb"]), t(a["z"]),
        mask=t(a["mask"]), eps=1e-5, extra_spd=t(a["H"]),
    )
    for name in teb.GPBlockOperators._fields:
        got, want = getattr(tops, name), getattr(jops, name)
        if want is None:
            assert got is None, name
            continue
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-8,
                                   atol=1e-12, err_msg=name)


def test_natural_gradient_update_matches_jax_and_keeps_psd_cone():
    a = tiny_inputs(seed=2)
    (_, jng, _), (_, tng, _) = both_kld(a, 3.0, True)
    m, H = a["m"], a["H"]
    jm, jH = jeb.natural_gradient_update(jnp.asarray(m), jnp.asarray(H), jng, 0.01)
    tm, tH = teb.natural_gradient_update(t(m), t(H), tng, 0.01)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(tH.numpy(), np.asarray(jH), rtol=1e-8, atol=1e-12)
    assert np.linalg.eigvalsh(tH.numpy()).min() > 0
    # a step far out of the PSD cone keeps the previous (m, H), as JAX does
    jm2, jH2 = jeb.natural_gradient_update(jnp.asarray(m), jnp.asarray(H), jng, -1e3)
    tm2, tH2 = teb.natural_gradient_update(t(m), t(H), tng, -1e3)
    np.testing.assert_array_equal(np.asarray(jm2), m)
    torch.testing.assert_close(tm2, t(m), rtol=0, atol=0)
    torch.testing.assert_close(tH2, t(H), rtol=0, atol=0)


@pytest.mark.parametrize("factors", [True, False])
def test_natural_gradient_update_refuses_a_new_h_that_does_not_factor(monkeypatch, factors):
    """The port's own test: a step whose inverse-space update factors but
    whose new H does not (in f32, from a nearly singular H) keeps the
    previous (m, H); a new H that factors is taken, as in JAX."""
    a = tiny_inputs(seed=2)
    (_, jng, _), (_, tng, _) = both_kld(a, 3.0, True)
    m, H = a["m"], a["H"]
    jm, jH = jeb.natural_gradient_update(jnp.asarray(m), jnp.asarray(H), jng, 0.01)
    real = teb.la.cholesky_and_inverse
    calls = []

    def chol_inv(x):
        calls.append(x)
        l_fac, inv = real(x)
        if len(calls) == 2 and not factors:  # the factor of the new H
            l_fac = l_fac.clone()
            l_fac[0, -1, -1] = float("nan")
        return l_fac, inv

    monkeypatch.setattr(teb.la, "cholesky_and_inverse", chol_inv)
    tm, tH = teb.natural_gradient_update(t(m), t(H), tng, 0.01)
    assert len(calls) == 2  # iH_new's factor and inverse, then the new H's factor
    np.testing.assert_allclose(calls[1].numpy(), np.asarray(jH), rtol=1e-8, atol=1e-12)
    if factors:
        np.testing.assert_allclose(tH.numpy(), np.asarray(jH), rtol=1e-8, atol=1e-12)
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-8, atol=1e-12)
    else:
        torch.testing.assert_close(tm, t(m), rtol=0, atol=0)
        torch.testing.assert_close(tH, t(H), rtol=0, atol=0)


def test_f32_factorisation_of_the_initial_h_inverse_matches_jax():
    """At the reference's initial H (h hᵀ of a square Gaussian h/10, the
    HealthMNIST L=32, M=60, seed 0) H is nearly singular. In f32 on the CPU
    both packages factor H but not H⁻¹ in the same latents, so the PSD-cone
    guard of the natural-gradient update decides alike in both."""
    from lvae_tpu.ops import linalg as jla
    from lvae_tpu.train import state as jst
    from lvae_torch.ops import linalg as tla
    from lvae_torch.train import state as tst

    _, h_t = tst.init_variational(32, 60, True, seed=0)
    _, h_j = jst.init_variational(32, 60, True, seed=0)
    np.testing.assert_array_equal(h_t.numpy(), np.asarray(h_j))
    print("smallest eigenvalue per latent, f64:",
          np.sort(np.linalg.eigvalsh(h_t.double().numpy()).min(-1))[:3])
    l_t, ih_t = tla.cholesky_and_inverse(h_t)
    l_j, ih_j = jla.cholesky_and_inverse(jnp.asarray(h_j))
    assert torch.isfinite(l_t).all() and np.isfinite(np.asarray(l_j)).all()
    ok_t = torch.isfinite(tla.cholesky_and_inverse(ih_t)[0]).all(-1).all(-1).numpy()
    ok_j = np.isfinite(np.asarray(jla.cholesky_and_inverse(ih_j)[0])).all((-1, -2))
    print("latents whose f32 H⁻¹ does not factor:", np.flatnonzero(~ok_t))
    np.testing.assert_array_equal(ok_t, ok_j)
    assert not ok_t.all()


# ------------------------------------------- the standard regime's bounds
def golden_ops(g):
    P, T = int(g["P"]), int(g["T"])
    spec0, spec1 = tkx.split_kernel_spec(id_covariate=2, **SPEC_A)
    return teb.gp_block_operators(
        spec0, spec1, params_from(g["A_scales0"], g["A_ls0"]),
        params_from(g["A_scales1"], g["A_ls1"]), t(g["noise"]),
        t(g["x_fix"]).reshape(P, T, -1), t(g["z"]), eps=float(g["eps"]),
    )


def test_dubo_and_gp_elbo_match_goldens(g):
    P, T, L = int(g["P"]), int(g["T"]), g["mu"].shape[1]
    ops = golden_ops(g)
    vals = teb.dubo(ops, t(g["mu"]).reshape(P, T, L), t(g["log_var"]).reshape(P, T, L))
    assert rel(vals, g["dubo_per_dim"]) < 2e-8
    assert rel(vals.sum(), g["validation_dubo"]) < 2e-8
    el = teb.gp_elbo(ops, t(g["y_sample"]).reshape(P, T, L))
    assert rel(el, g["elbo_per_dim"]) < 2e-8


def test_kl_closed_matches_goldens(g):
    """Per latent dim, the dense N×N KL against the joined additive prior."""
    spec0, spec1 = tkx.split_kernel_spec(id_covariate=2, **SPEC_A)
    spec, kp = tkx.join_specs(spec0, spec1, params_from(g["A_scales0"], g["A_ls0"]),
                              params_from(g["A_scales1"], g["A_ls1"]))
    x = t(g["x_fix"])
    k = tkx.kernel_matrix(spec, kp, x, x)
    k = k + torch.diag_embed(t(g["noise"])[:, None].expand(-1, x.shape[0]))
    vals = teb.kl_closed(k, t(g["mu"]).T, t(g["log_var"]).T)
    assert vals.shape == (k.shape[0],)
    assert rel(vals, g["kl_closed_per_dim"]) < 2e-8


def both_bound(a, bound):
    """(value [L], grads) of ``bound`` (gp_elbo on a sample or dubo on the
    moments) summed with fixed weights, w.r.t. (s0, l0, s1, l1, noise, mu,
    lv), in both packages."""
    js0, js1 = jkx.split_kernel_spec(id_covariate=2, **SPEC_A)
    ts0, ts1 = tkx.split_kernel_spec(id_covariate=2, **SPEC_A)
    keys = ("s0", "l0", "s1", "l1", "noise", "mu", "lv")
    w = np.arange(1.0, a["s0"].shape[0] + 1.0)
    y_eps = np.random.default_rng(9).normal(size=a["mu"].shape)

    def apply(eb, ops, mu, lv, exp, eps):
        if bound == "gp_elbo":
            return eb.gp_elbo(ops, mu + eps * exp(0.5 * lv))
        return eb.dubo(ops, mu, lv)

    def j_fn(s0, l0, s1, l1, noise, mu, lv):
        ops = jeb.gp_block_operators(
            js0, js1, jkx.KernelParams(s0, l0), jkx.KernelParams(s1, l1), noise,
            jnp.asarray(a["xb"]), jnp.asarray(a["z"]), mask=jnp.asarray(a["mask"]), eps=1e-5)
        vals = apply(jeb, ops, mu, lv, jnp.exp, jnp.asarray(y_eps))
        return jnp.sum(vals * w), vals

    (_, jv), jg = jax.value_and_grad(j_fn, argnums=tuple(range(7)), has_aux=True)(
        *(jnp.asarray(a[k]) for k in keys))
    leaves = [torch.tensor(a[k], requires_grad=True) for k in keys]
    s0, l0, s1, l1, noise, mu, lv = leaves
    ops = teb.gp_block_operators(
        ts0, ts1, tkx.KernelParams(s0, l0), tkx.KernelParams(s1, l1), noise, t(a["xb"]),
        t(a["z"]), mask=t(a["mask"]), eps=1e-5)
    tv = apply(teb, ops, mu, lv, torch.exp, t(y_eps))
    torch.sum(tv * t(w)).backward()
    return (jv, jg), (tv, [x.grad for x in leaves])


@pytest.mark.parametrize("ragged", [True, False], ids=["ragged", "fixed_T"])
@pytest.mark.parametrize("bound", ["gp_elbo", "dubo"])
def test_sparse_bounds_value_and_grads_match_jax(bound, ragged):
    a = tiny_inputs(seed=4, ragged=ragged)
    (jv, jg), (tv, tg) = both_bound(a, bound)
    np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv), rtol=1e-8)
    for got, want in zip(tg, jg):
        assert np.isfinite(got.numpy()).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-8, atol=1e-11)


def test_dubo_gradients_finite_on_ragged_blocks():
    """d dubo/d log_var is finite, and zero, at padded slots: the double
    where keeps sqrt's infinite derivative at v = 0 out of the gradient."""
    a = tiny_inputs(seed=5)
    assert not a["mask"].all()
    ts0, ts1 = tkx.split_kernel_spec(id_covariate=2, **SPEC_A)
    ops = teb.gp_block_operators(
        ts0, ts1, tkx.KernelParams(t(a["s0"]), t(a["l0"])),
        tkx.KernelParams(t(a["s1"]), t(a["l1"])), t(a["noise"]), t(a["xb"]), t(a["z"]),
        mask=t(a["mask"]), eps=1e-5)
    mu = t(a["mu"]).requires_grad_(True)
    lv = t(a["lv"]).requires_grad_(True)
    total = torch.sum(teb.dubo(ops, mu, lv))
    total.backward()
    assert torch.isfinite(total)
    assert torch.isfinite(mu.grad).all() and torch.isfinite(lv.grad).all()
    pad = t(a["mask"]) == 0
    assert (lv.grad[pad] == 0).all() and (mu.grad[pad] == 0).all()


@pytest.mark.parametrize("ghost", [False, True], ids=["all_real", "ghost_rows"])
def test_kl_closed_batched_matches_jax_vmapped(ghost):
    """The batched kl_closed and its gradient w.r.t. the raw kernel
    parameters, the noise and the moments against jax.vmap of lvae_tpu's,
    with the standard regime's ghost-row decoupling."""
    rng = np.random.default_rng(6)
    n, latent = 9, 3
    x = np.stack([rng.normal(size=n), rng.integers(0, 3, n), rng.integers(0, 2, n),
                  rng.integers(0, 2, n), rng.integers(0, 2, n), rng.integers(0, 2, n)], 1)
    valid = np.ones(n)
    if ghost:
        valid[-2:] = 0.0
    spec_args = dict(cat_kernel=[2], sqexp_kernel=[0],
                     cat_int_kernel=[{"cont_covariate": 0, "cat_covariate": 1}])
    c = 3
    a = dict(s=rng.normal(size=(latent, c)) * 0.3, l=rng.normal(size=(latent, c)) * 0.3 + 1.0,
             noise=rng.uniform(size=latent) + 0.5, mu=rng.normal(size=(latent, n)),
             lv=rng.normal(size=(latent, n)) * 0.2)
    keys = ("s", "l", "noise", "mu", "lv")

    def prior(kx, spec, s, l, noise, xx, vv, diag_embed):
        k = kx.kernel_matrix(spec, kx.KernelParams(s, l), xx, xx) * (vv[:, None] * vv[None, :])
        return k + diag_embed(vv * noise[:, None] + (1.0 - vv))

    jspec = jkx.build_kernel_spec(**spec_args)

    def j_fn(s, l, noise, mu, lv):
        vv = jnp.asarray(valid)
        k = prior(jkx, jspec, s, l, noise, jnp.asarray(x), vv,
                  lambda d: d[:, :, None] * jnp.eye(n))
        vals = jax.vmap(jeb.kl_closed)(k, mu * vv, lv * vv)
        return jnp.sum(vals), vals

    (_, jv), jg = jax.value_and_grad(j_fn, argnums=tuple(range(5)), has_aux=True)(
        *(jnp.asarray(a[k]) for k in keys))
    leaves = [torch.tensor(a[k], requires_grad=True) for k in keys]
    s, l, noise, mu, lv = leaves
    vv = t(valid)
    k = prior(tkx, tkx.build_kernel_spec(**spec_args), s, l, noise, t(x), vv, torch.diag_embed)
    tv = teb.kl_closed(k, mu * vv, lv * vv)
    tv.sum().backward()
    np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv), rtol=1e-8)
    for got, want in zip((x.grad for x in leaves), jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-8, atol=1e-12)


def kl_closed_autograd(K, mu, log_var):
    """The oracle: kl_closed as autograd differentiates it through the
    Cholesky factor, the two triangular solves of the inverse and the
    eye-masked trace."""
    n = K.shape[-1]
    lk = torch.linalg.cholesky(K)
    eye = torch.eye(n, dtype=K.dtype).broadcast_to(K.shape)
    ik = torch.linalg.solve_triangular(lk.mT, torch.linalg.solve_triangular(lk, eye, upper=False),
                                       upper=True)
    v = torch.exp(log_var)
    tr = torch.sum(ik * torch.eye(n, dtype=K.dtype) * v[..., None, :], dim=(-2, -1))
    qf = torch.sum(mu * (ik @ mu[..., None])[..., 0], dim=-1)
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(lk, dim1=-2, dim2=-1)), dim=-1)
    return 0.5 * (tr + qf - n + logdet - torch.sum(log_var, dim=-1))


@pytest.mark.parametrize("ghost", [False, True], ids=["all_real", "ghost_rows"])
@pytest.mark.parametrize("n", [9, 64])
def test_closed_kl_backward_matches_autograd(n, ghost):
    """ClosedKL's value and its closed-form gradients in K, mu and log_var
    against autograd through the factorisation, in float64, under a random
    cotangent per latent; ghost rows (an identity row and column, zero
    moments) as the standard regime adds them."""
    rng = np.random.default_rng(n)
    latent = 3
    a = rng.normal(size=(latent, n, n))
    k = a @ a.transpose(0, 2, 1) / n + np.eye(n) * rng.uniform(0.3, 1.0, size=(latent, 1, 1))
    mu, lv = rng.normal(size=(latent, n)), rng.normal(size=(latent, n)) * 0.3
    if ghost:
        valid = np.ones(n)
        valid[-3:] = 0.0
        k = k * valid[:, None] * valid[None, :] + np.diag(1.0 - valid)
        mu, lv = mu * valid, lv * valid
    cot = t(rng.normal(size=latent))

    def run(fn):
        leaves = [t(x).requires_grad_(True) for x in (k, mu, lv)]
        out = fn(*leaves)
        torch.sum(out * cot).backward()
        return out.detach(), [x.grad for x in leaves]

    before = teb.ClosedKL.backward_calls
    got, got_g = run(teb.kl_closed)
    assert teb.ClosedKL.backward_calls == before + 1
    want, want_g = run(kl_closed_autograd)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-10)
    for name, a_, b_ in zip(("K", "mu", "log_var"), got_g, want_g):
        np.testing.assert_allclose(a_.numpy(), b_.numpy(), rtol=1e-10,
                                   atol=1e-13 * float(b_.abs().max()), err_msg=name)
