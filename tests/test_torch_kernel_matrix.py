"""Kernel K3's plain version and gradient (lvae_torch.kernels_cuda.kernel_matrix)
against lvae_tpu, on the CPU.

On the CPU ``kernel_matrix_kernel`` runs ``FusedKernelMatrix``, whose forward
is the plain version; the CUDA kernel itself is held against that plain
version on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
Tolerances: the plain version and its backward against the JAX package's XLA
``kernel_matrix`` and ``jax.grad`` of it in float64 at rtol 1e-8 (summation
order only); against the Pallas kernel in interpret mode in float32 at rtol
2e-5 / atol 2e-6 and against its analytic backward ``_fused_bwd`` at rtol
1e-4 / atol 1e-6, the JAX package's own tolerances for that kernel
(``tests/test_pallas_kernel_matrix.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvae_tpu.kernels_pallas import kernel_matrix as pkm
from lvae_tpu.ops import kernels as jkx
from lvae_torch.kernels_cuda import kernel_matrix as tkm
from lvae_torch.ops import kernels as tkx

HM_SPEC = dict(
    cat_kernel=[2], sqexp_kernel=[0],
    cat_int_kernel=[{"cont_covariate": 0, "cat_covariate": 2},
                    {"cont_covariate": 0, "cat_covariate": 3},
                    {"cont_covariate": 1, "cat_covariate": 4}],
    id_covariate=2,
)
PALLAS_SPEC = dict(cat_kernel=[2, 3], bin_kernel=[1], sqexp_kernel=[0],
                   cat_int_kernel=[{"cont_covariate": 0, "cat_covariate": 2}],
                   id_covariate=2)


def joined(kx, **args):
    spec0, spec1 = kx.split_kernel_spec(**args)
    return kx.KernelSpec(components=spec0.components + spec1.components)


def cat_mod_spec(kx):
    """A 4-class centred categorical on column 1, alone and times an RBF,
    and a both-one factor: every kind of factor the table holds."""
    comp = kx.KernelComponent
    return kx.KernelSpec(components=(
        comp(kind="cat_mod", rbf_col=-1, eq_cols=(), and_cols=(), cat_mod=(1, 4)),
        comp(kind="cat_mod_rbf", rbf_col=0, eq_cols=(), and_cols=(), cat_mod=(1, 4)),
        comp(kind="bin_rbf", rbf_col=0, eq_cols=(2,), and_cols=(3,)),
    ))


SPECS = {
    "healthmnist": lambda kx: joined(kx, **HM_SPEC),
    "pallas_test": lambda kx: joined(kx, **PALLAS_SPEC),
    "cat_mod": cat_mod_spec,
}


def problem(name, seed=0, n1=23, n2=17, latent=3, dtype=np.float64):
    """Raw parameters and covariates [N, 6] with few distinct discrete values
    (so the equality factors are both 0 and 1), and 0/1 row/column masks."""
    rng = np.random.default_rng(seed)
    c = len(SPECS[name](tkx).components)

    def x(n):
        cols = [rng.normal(size=n), rng.integers(0, 4, n), rng.integers(0, 3, n),
                rng.integers(0, 2, n), rng.integers(0, 2, n), rng.integers(0, 2, n)]
        return np.stack(cols, axis=1).astype(dtype)

    return dict(
        raw_s=(0.3 * rng.normal(size=(latent, c))).astype(dtype),
        raw_l=(0.3 * rng.normal(size=(latent, c)) + 0.5).astype(dtype),
        x1=x(n1), x2=x(n2),
        m1=(rng.uniform(size=n1) > 0.2).astype(dtype),
        m2=(rng.uniform(size=n2) > 0.2).astype(dtype),
        cot=rng.normal(size=(latent, n1, n2)).astype(dtype),
    )


def t(a):
    return torch.tensor(np.asarray(a))


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
@pytest.mark.parametrize("name", sorted(SPECS))
def test_kernel_and_gradient_match_jax_xla_f64(name, masked):
    """kernel_matrix_kernel (CPU: FusedKernelMatrix over the plain version)
    and its backward against kx.kernel_matrix and jax.grad of it."""
    a = problem(name)
    jspec, tspec = SPECS[name](jkx), SPECS[name](tkx)
    masks = (a["m1"], a["m2"]) if masked else (None, None)

    def j_fn(raw_s, raw_l):
        k = jkx.kernel_matrix(jspec, jkx.KernelParams(raw_s, raw_l), jnp.asarray(a["x1"]),
                              jnp.asarray(a["x2"]),
                              *(None if m is None else jnp.asarray(m) for m in masks))
        return jnp.sum(k * a["cot"]), k

    (_, want), jgrads = jax.value_and_grad(j_fn, argnums=(0, 1), has_aux=True)(
        jnp.asarray(a["raw_s"]), jnp.asarray(a["raw_l"]))
    raw_s, raw_l = t(a["raw_s"]).requires_grad_(True), t(a["raw_l"]).requires_grad_(True)
    got = tkm.kernel_matrix_kernel(tspec, tkx.KernelParams(raw_s, raw_l), t(a["x1"]),
                                   t(a["x2"]), *(None if m is None else t(m) for m in masks))
    torch.sum(got * t(a["cot"])).backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-8, atol=1e-14)
    for g, w in zip((raw_s.grad, raw_l.grad), jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-8, atol=1e-13)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_plain_version_matches_pallas_interpret_f32(name):
    """The plain version against _kernel_matrix_pallas run in interpret
    mode on the same constrained parameters (N1=70, N2=37: not tiles)."""
    a = problem(name, seed=1, n1=70, n2=37, dtype=np.float32)
    jspec, tspec = SPECS[name](jkx), SPECS[name](tkx)
    scale = jkx.constrain(jnp.asarray(a["raw_s"]))
    g = 0.5 / jkx.constrain(jnp.asarray(a["raw_l"])) ** 2
    want = pkm._kernel_matrix_pallas(jspec, scale, g, jnp.asarray(a["x1"]),
                                     jnp.asarray(a["x2"]), interpret=True)
    got = tkm.kernel_matrix_reference(tspec, t(scale), t(g), t(a["x1"]), t(a["x2"]))
    assert got.dtype == torch.float32 and got.shape == (3, 70, 37)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_backward_matches_pallas_fused_bwd_f32(name):
    a = problem(name, seed=2, dtype=np.float32)
    jspec, tspec = SPECS[name](jkx), SPECS[name](tkx)
    scale = jkx.constrain(jnp.asarray(a["raw_s"]))
    g = 0.5 / jkx.constrain(jnp.asarray(a["raw_l"])) ** 2
    x1, x2, cot = (jnp.asarray(a[k]) for k in ("x1", "x2", "cot"))
    want_s, want_g, _, _ = pkm._fused_bwd(jspec, (scale, g, x1, x2), cot)
    got_s, got_g = tkm.kernel_matrix_backward(tspec, t(scale), t(g), t(x1), t(x2), t(cot))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-4, atol=1e-6)


def test_gate_follows_the_jax_package():
    """f32, [L, C] parameters, [N, Q] covariates, N1 and N2 >= 512, a
    non-empty spec within the table."""
    spec = joined(tkx, **HM_SPEC)
    kp = tkx.init_kernel_params(spec, 4)

    def can(n1=512, n2=600, dtype=torch.float32, s=spec, p=kp, xb=()):
        return tkm.usable(s, p, torch.zeros(xb + (n1, 6), dtype=dtype),
                          torch.zeros(xb + (n2, 6), dtype=dtype))

    assert can() and can(n1=2000, n2=2000)
    assert not can(n1=511) and not can(n2=60)
    assert not can(dtype=torch.float64)
    assert not can(xb=(3,))
    assert not can(p=tkx.init_kernel_params(spec))  # [C] parameters
    assert not can(s=tkx.KernelSpec(components=()))
    assert not can(s=tkx.KernelSpec(components=spec.components * 4))  # 20 > 16


def test_cpu_evaluation_at_the_gated_shape_stays_plain():
    """A CPU tensor inside the gate's shapes takes the plain evaluation and
    launches nothing; it equals kernel_matrix_kernel's CPU result."""
    a = problem("healthmnist", seed=3, n1=512, n2=520, latent=2, dtype=np.float32)
    spec = joined(tkx, **HM_SPEC)
    kp = tkx.KernelParams(t(a["raw_s"]), t(a["raw_l"]))
    before = tkm.kernel_matrix_fused.launches
    got = tkx.kernel_matrix(spec, kp, t(a["x1"]), t(a["x2"]))
    want = tkm.kernel_matrix_kernel(spec, kp, t(a["x1"]), t(a["x2"]))
    assert tkm.kernel_matrix_fused.launches == before
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_spec_table_takes_any_number_of_specs():
    spec0, spec1 = tkx.split_kernel_spec(**HM_SPEC)
    full = joined(tkx, **HM_SPEC)
    assert tkm.spec_table(spec0, spec1) == tkm.spec_table(spec0) + tkm.spec_table(spec1)
    assert tkm.spec_table(full) == tkm.spec_table(spec0, spec1)
    row = 2 + tkm.MAX_EQ + 1 + tkm.MAX_AND + 2
    assert len(tkm.spec_table(cat_mod_spec(tkx), spec1)) == 5 * row
    with pytest.raises(ValueError):
        tkm.spec_table(tkx.KernelSpec(components=full.components * 4))
