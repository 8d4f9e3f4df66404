"""lvae_torch.ops.kernels against lvae_tpu.ops.kernels, on the CPU.

Kernel evaluation, block stacks and the B operator are compared in float64
at rtol 1e-8 (elementwise math, same formulas). The jitter helpers branch on
the dtype, so they are compared in float32 (rtol 1e-6: one f32 reduction in
another order) and float64 (rtol 1e-12).
"""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvae_tpu.config import load_flag_file
from lvae_tpu.ops import kernels as jkx
from lvae_torch.config import load_flag_file as t_load_flag_file
from lvae_torch.ops import kernels as tkx

RTOL64 = 1e-8
CONFIG = str(Path(__file__).resolve().parents[1] / "configs" / "healthmnist_lvae.txt")

# every factor type: categorical, binary, RBF, both interactions, a
# missing-value mask column, and a centred categorical (cat_mod)
SPEC_KW = dict(
    cat_kernel=[2],
    bin_kernel=[5],
    sqexp_kernel=[0],
    cat_int_kernel=[{"cont_covariate": 0, "cat_covariate": 3}],
    bin_int_kernel=[{"cont_covariate": 1, "bin_covariate": 4}],
    covariate_missing_val=[{"covariate": 1, "mask": 5}],
)


def _specs():
    jspec = jkx.build_kernel_spec(**SPEC_KW)
    tspec = tkx.build_kernel_spec(**SPEC_KW)
    jspec = jspec._replace(components=jspec.components + (
        jkx.KernelComponent("catmod", -1, (), (), (3, 3)),))
    tspec = tspec._replace(components=tspec.components + (
        tkx.KernelComponent("catmod", -1, (), (), (3, 3)),))
    return jspec, tspec


def _covariates(rng, n):
    # [time, cont, subject, class(3), bin, bin]
    return np.stack([
        rng.integers(0, 5, n).astype(float),
        rng.normal(size=n),
        rng.integers(0, 3, n).astype(float),
        rng.integers(0, 3, n).astype(float),
        rng.integers(0, 2, n).astype(float),
        rng.integers(0, 2, n).astype(float),
    ], axis=1)


def _params(rng, latent, c):
    raw_s = rng.normal(size=(latent, c)) * 0.3
    raw_l = rng.normal(size=(latent, c)) * 0.3 + 0.9
    return (
        jkx.KernelParams(jnp.asarray(raw_s), jnp.asarray(raw_l)),
        tkx.KernelParams(torch.from_numpy(raw_s), torch.from_numpy(raw_l)),
    )


def _close(got, want, rtol=RTOL64, atol=1e-12):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol)


def test_specs_build_alike():
    jspec, tspec = _specs()
    assert tuple(tspec) == tuple(jspec)
    assert tspec.has_rbf == jspec.has_rbf


def test_split_kernel_spec_of_config_file():
    jcfg, _ = load_flag_file(CONFIG)
    tcfg, _ = t_load_flag_file(CONFIG)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    j0, j1 = jkx.split_kernel_spec(id_covariate=jcfg.id_covariate, **jcfg.kernel_spec_kwargs())
    t0, t1 = tkx.split_kernel_spec(id_covariate=tcfg.id_covariate, **tcfg.kernel_spec_kwargs())
    assert tuple(t0) == tuple(j0) and tuple(t1) == tuple(j1)
    # spec0 = rbf(0) + cat_rbf(0,3) + cat_rbf(1,4); spec1 = cat(2) + cat_rbf(0,2)
    assert [(c.kind, c.rbf_col, c.eq_cols) for c in t0.components] == [
        ("rbf", 0, ()), ("cat_rbf", 0, (3,)), ("cat_rbf", 1, (4,))]
    assert [(c.kind, c.rbf_col, c.eq_cols) for c in t1.components] == [
        ("cat", -1, (2,)), ("cat_rbf", 0, (2,))]


def test_constrain_unconstrain_init_f64():
    rng = np.random.default_rng(0)
    raw = rng.normal(size=(4, 3)) * 3
    _close(tkx.constrain(torch.from_numpy(raw)), jkx.constrain(jnp.asarray(raw)))
    val = np.exp(rng.normal(size=(4, 3)))
    _close(tkx.unconstrain(torch.from_numpy(val)), jkx.unconstrain(jnp.asarray(val)))
    jspec, tspec = _specs()
    jp = jkx.init_kernel_params(jspec, 3, dtype=jnp.float64)
    tp = tkx.init_kernel_params(tspec, 3, dtype=torch.float64)
    _close(tp.raw_scale, jp.raw_scale)
    _close(tp.raw_lengthscale, jp.raw_lengthscale)


@pytest.mark.parametrize("masked", [False, True])
def test_kernel_matrix_f64(masked):
    rng = np.random.default_rng(1)
    jspec, tspec = _specs()
    jp, tp = _params(rng, 3, tspec.num_components)
    x1, x2 = _covariates(rng, 7), _covariates(rng, 5)
    m1 = (rng.uniform(size=7) > 0.3).astype(float) if masked else None
    m2 = (rng.uniform(size=5) > 0.3).astype(float) if masked else None
    want = jkx.kernel_matrix(
        jspec, jp, jnp.asarray(x1), jnp.asarray(x2),
        None if m1 is None else jnp.asarray(m1), None if m2 is None else jnp.asarray(m2),
    )
    got = tkx.kernel_matrix(
        tspec, tp, torch.from_numpy(x1), torch.from_numpy(x2),
        None if m1 is None else torch.from_numpy(m1),
        None if m2 is None else torch.from_numpy(m2),
    )
    assert got.shape == (3, 7, 5)
    _close(got, want)


def test_empty_spec_is_zero():
    jp = jkx.KernelParams(jnp.zeros((2, 0)), jnp.zeros((2, 0)))
    tp = tkx.KernelParams(torch.zeros(2, 0, dtype=torch.float64), torch.zeros(2, 0, dtype=torch.float64))
    x = _covariates(np.random.default_rng(2), 4)
    got = tkx.kernel_matrix(tkx.KernelSpec(()), tp, torch.from_numpy(x), torch.from_numpy(x))
    want = jkx.kernel_matrix(jkx.KernelSpec(()), jp, jnp.asarray(x), jnp.asarray(x))
    _close(got, want)


def _blocks(rng, p=4, t=5):
    xb = np.stack([_covariates(rng, t) for _ in range(p)])
    mask = np.ones((p, t))
    mask[1, 3:] = 0.0
    mask[3, 1:] = 0.0
    return xb * mask[..., None], mask


def test_block_kernel_matrix_f64():
    rng = np.random.default_rng(3)
    jspec, tspec = _specs()
    jp, tp = _params(rng, 2, tspec.num_components)
    xb, mask = _blocks(rng)
    for m in (None, mask):
        want = jkx.block_kernel_matrix(jspec, jp, jnp.asarray(xb), None if m is None else jnp.asarray(m))
        got = tkx.block_kernel_matrix(tspec, tp, torch.from_numpy(xb), None if m is None else torch.from_numpy(m))
        assert got.shape == (2, 4, 5, 5)
        _close(got, want)


def test_block_b_operator_f64():
    rng = np.random.default_rng(4)
    jcfg, _ = load_flag_file(CONFIG)
    _, j1 = jkx.split_kernel_spec(id_covariate=2, **jcfg.kernel_spec_kwargs())
    _, t1 = tkx.split_kernel_spec(id_covariate=2, **jcfg.kernel_spec_kwargs())
    jp, tp = _params(rng, 3, t1.num_components)
    xb, mask = _blocks(rng)
    noise = rng.uniform(0.5, 1.5, size=3)
    want = jkx.block_b_operator(j1, jp, jnp.asarray(xb), jnp.asarray(mask), jnp.asarray(noise))
    got = tkx.block_b_operator(t1, tp, torch.from_numpy(xb), torch.from_numpy(mask), torch.from_numpy(noise))
    assert got.shape == (3, 4, 5, 5)
    _close(got, want)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("which", ["adaptive", "rel"])
def test_jitter_branches(which, dtype):
    rng = np.random.default_rng(5)
    h = rng.normal(size=(3, 6, 6))
    kzz = (h @ np.swapaxes(h, -1, -2)).astype(dtype)
    if which == "adaptive":
        got = tkx.add_adaptive_jitter(torch.from_numpy(kzz), 1e-6)
        want = jkx.add_adaptive_jitter(jnp.asarray(kzz), 1e-6)
    else:
        got = tkx.add_rel_jitter(torch.from_numpy(kzz))
        want = jkx.add_rel_jitter(jnp.asarray(kzz))
    assert str(got.dtype) == f"torch.{dtype}"
    rtol = 1e-6 if dtype == "float32" else 1e-12
    _close(got, want, rtol=rtol, atol=0)
    if dtype == "float32":  # the relative floor, well above eps, was applied
        assert float((got - torch.from_numpy(kzz)).diagonal(dim1=-2, dim2=-1).min()) > 1e-4


def test_join_specs():
    rng = np.random.default_rng(6)
    jcfg, _ = load_flag_file(CONFIG)
    j0, j1 = jkx.split_kernel_spec(id_covariate=2, **jcfg.kernel_spec_kwargs())
    t0, t1 = tkx.split_kernel_spec(id_covariate=2, **jcfg.kernel_spec_kwargs())
    jp0, tp0 = _params(rng, 2, 3)
    jp1, tp1 = _params(rng, 2, 2)
    jspec, jp = jkx.join_specs(j0, j1, jp0, jp1)
    tspec, tp = tkx.join_specs(t0, t1, tp0, tp1)
    assert tuple(tspec) == tuple(jspec)
    _close(tp.raw_scale, jp.raw_scale)
    _close(tp.raw_lengthscale, jp.raw_lengthscale)
