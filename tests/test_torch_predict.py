"""lvae_torch.ops.predict against lvae_tpu.ops.predict, on the CPU.

The GP posterior, the basis fold, the basis refresh and the K-subject
request extension are compared in float64 at rtol 1e-8 on a ragged cohort
with the config file's kernel layout. One float32 case runs the f32 jitter
branches (adaptive K0zz floor, relative H jitter); it is held at rtol 1e-4,
the scale of f32 rounding carried through two Cholesky solves at these
condition numbers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvae_tpu.ops import kernels as jkx
from lvae_tpu.ops import predict as jpr
from lvae_torch.ops import kernels as tkx
from lvae_torch.ops import predict as tpr

RTOL64 = 1e-8
# the JAX side jitted (specs static): one compile per function instead of
# one dispatch compile per eager op
J_FOLD = jax.jit(jpr.precompute_predict_basis, static_argnums=(0, 1))
J_EXTEND = jax.jit(jpr.extend_predict_basis, static_argnums=(0, 1))
J_REQUEST = jax.jit(jpr.gp_predict_extend_batch, static_argnums=(0, 1))
J_ONE = jax.jit(jpr.gp_predict_extend, static_argnums=(0, 1))
KERNEL_KW = dict(
    cat_kernel=[2],
    sqexp_kernel=[0],
    cat_int_kernel=[
        {"cont_covariate": 0, "cat_covariate": 2},
        {"cont_covariate": 0, "cat_covariate": 3},
        {"cont_covariate": 1, "cat_covariate": 4},
    ],
)
L, M, T, Q = 3, 7, 5, 6


def cohort(rng, subjects, t_range=(2, T + 1)):
    """Ragged HealthMNIST-layout covariates
    [time_age, disease_time, subject, gender, disease, location]."""
    rows = []
    for s in subjects:
        dt, g, d, loc = rng.normal(), rng.integers(0, 2), rng.integers(0, 2), rng.integers(0, 4)
        for t in range(rng.integers(*t_range)):
            rows.append([t, dt + 0.1 * t, s, g, d, loc])
    return np.asarray(rows, np.float64)


class Setup:
    def __init__(self, dtype=np.float64, seed=0):
        rng = np.random.default_rng(seed)
        self.dtype = dtype
        self.train_x = cohort(rng, range(5)).astype(dtype)
        self.mu = rng.normal(size=(self.train_x.shape[0], L)).astype(dtype)
        self.z = self.train_x[rng.choice(self.train_x.shape[0], M, replace=False)]
        self.z = (self.z + 0.01 * rng.normal(size=self.z.shape)).astype(dtype)
        self.j0, self.j1 = jkx.split_kernel_spec(id_covariate=2, **KERNEL_KW)
        self.t0, self.t1 = tkx.split_kernel_spec(id_covariate=2, **KERNEL_KW)
        self.raw = [
            (rng.normal(size=(L, s.num_components)) * 0.3,
             rng.normal(size=(L, s.num_components)) * 0.3 + 0.9)
            for s in (self.t0, self.t1)
        ]
        self.noise = (0.6 + rng.uniform(0, 0.4, size=L)).astype(dtype)
        self.rng = rng

    def jargs(self):
        kp = [jkx.KernelParams(jnp.asarray(s, self.dtype), jnp.asarray(l, self.dtype))
              for s, l in self.raw]
        return self.j0, self.j1, kp[0], kp[1], jnp.asarray(self.noise)

    def targs(self):
        tdt = torch.float64 if self.dtype == np.float64 else torch.float32
        kp = [tkx.KernelParams(torch.tensor(s, dtype=tdt), torch.tensor(l, dtype=tdt))
              for s, l in self.raw]
        return self.t0, self.t1, kp[0], kp[1], torch.from_numpy(self.noise)

    def blocks(self, x, mu):
        """Padded blocks of a flat cohort (via each package's own packer)."""
        jin, _, _ = jpr.build_predict_inputs(x, mu, x[:1], 2, dtype=self.dtype)
        tin, _, _ = tpr.build_predict_inputs(x, mu, x[:1], 2, dtype=self.dtype)
        return jin, tin


def _close(got, want, rtol=RTOL64, atol=1e-10):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def test_build_predict_inputs_match():
    s = Setup()
    test_x = cohort(s.rng, [1, 3, 9], (2, 4))
    jin, jidx, jmask = jpr.build_predict_inputs(s.train_x, s.mu, test_x, 2, dtype=np.float64)
    tin, tidx, tmask = tpr.build_predict_inputs(s.train_x, s.mu, test_x, 2, dtype=np.float64)
    for name in jpr.PredictInputs._fields:
        np.testing.assert_array_equal(getattr(tin, name).numpy(), np.asarray(getattr(jin, name)))
    np.testing.assert_array_equal(tidx, jidx)
    np.testing.assert_array_equal(tmask, jmask)


def test_gp_predict_f64():
    """Known subjects at new times and an unseen subject (K1 term zero)."""
    s = Setup()
    test_x = cohort(s.rng, [1, 3, 9], (2, 4))
    got = tpr.predict_latents(*s.targs(), s.train_x, s.mu, test_x,
                              torch.from_numpy(s.z), 2, eps=1e-6)
    want = jpr.predict_latents(*s.jargs(), s.train_x, s.mu, test_x,
                               jnp.asarray(s.z), 2, eps=1e-6)
    assert got.shape == (test_x.shape[0], L)
    _close(got, want)


def _fold(s, x, mu):
    jin, tin = s.blocks(x, mu)
    jb = J_FOLD(*s.jargs(), jin.xb, jin.mask, jin.mu_b, jnp.asarray(s.z))
    tb = tpr.precompute_predict_basis(*s.targs(), tin.xb, tin.mask, tin.mu_b, torch.from_numpy(s.z))
    return jb, tb


def test_precompute_predict_basis_f64():
    s = Setup()
    jb, tb = _fold(s, s.train_x, s.mu)
    _close(tb.h_nojit, jb.h_nojit)
    _close(tb.c, jb.c)


def test_extend_predict_basis_f64():
    s = Setup()
    jb, tb = _fold(s, s.train_x, s.mu)
    new_x = cohort(s.rng, [20, 21])
    new_mu = s.rng.normal(size=(new_x.shape[0], L))
    jin, tin = s.blocks(new_x, new_mu)
    jg = J_EXTEND(*s.jargs(), jb, jin.xb, jin.mask, jin.mu_b, jnp.asarray(s.z))
    tg = tpr.extend_predict_basis(*s.targs(), tb, tin.xb, tin.mask, tin.mu_b, torch.from_numpy(s.z))
    _close(tg.h_nojit, jg.h_nojit)
    _close(tg.c, jg.c)
    # the refresh equals a full refold of the union cohort
    _, tfull = _fold(s, np.concatenate([s.train_x, new_x]), np.concatenate([s.mu, new_mu]))
    _close(tg.h_nojit, tfull.h_nojit, rtol=1e-10)
    _close(tg.c, tfull.c, rtol=1e-10)


def _request(s, k=2, t_obs=3, tq=2):
    x_new = np.stack([cohort(s.rng, [30 + j], (t_obs, t_obs + 1)) for j in range(k)])
    x_new = x_new.astype(s.dtype)
    mask_new = np.ones((k, t_obs), s.dtype)
    mask_new[-1] = 0.0  # a data-free row: shared term only
    mask_new[0, -1] = 0.0  # and a ragged one
    mu_new = s.rng.normal(size=(k, t_obs, L)).astype(s.dtype)
    xq = x_new[:, :1].repeat(tq, axis=1)
    xq[..., 0] = t_obs + np.arange(tq)
    xq_mask = np.ones((k, tq), s.dtype)
    return x_new, mask_new, mu_new, xq, xq_mask


@pytest.mark.parametrize("dtype,rtol", [(np.float64, RTOL64), (np.float32, 1e-4)])
def test_gp_predict_extend_batch(dtype, rtol):
    s = Setup(dtype=dtype)
    jb, tb = _fold(s, s.train_x, s.mu)
    req = _request(s)
    got = tpr.gp_predict_extend_batch(*s.targs(), tb, *(torch.from_numpy(a) for a in req),
                                      torch.from_numpy(s.z))
    want = J_REQUEST(*s.jargs(), jb, *(jnp.asarray(a) for a in req),
                                       jnp.asarray(s.z))
    assert got.shape == (2, 2, L) and got.dtype == (torch.float64 if dtype == np.float64 else torch.float32)
    _close(got, want, rtol=rtol, atol=rtol * 1e-2)


def test_gp_predict_extend_one_subject_f64():
    s = Setup()
    jb, tb = _fold(s, s.train_x, s.mu)
    x_new, mask_new, mu_new, xq, xq_mask = (a[0] for a in _request(s))
    got = tpr.gp_predict_extend(*s.targs(), tb, *(torch.from_numpy(a) for a in
                                (x_new, mask_new, mu_new, xq, xq_mask)), torch.from_numpy(s.z))
    want = J_ONE(*s.jargs(), jb, *(jnp.asarray(a) for a in
                                 (x_new, mask_new, mu_new, xq, xq_mask)), jnp.asarray(s.z))
    _close(got, want)
