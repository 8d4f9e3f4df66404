"""The block-pair kernel K4 (lvae_torch/kernels_cuda/block_pair.py), its
route through ``ops/elbo.gp_block_operators`` and the route switches,
against lvae_tpu on the CPU.

On the CPU ``block_pair`` is the plain version (two ``masked_block_stack``
calls) and ``BlockPair``'s backward the port of ``_block_pair_bwd_impl``.
Each is held, on the same numpy inputs, against:

* JAX ``block_kernel_matrix`` of each spec (the XLA route), in float64 at
  rtol 1e-8;
* ``_block_pair_pallas`` run in interpret mode, in float32 at the JAX
  package's own atol of 1e-6 (``tests/test_pallas_kernel_matrix.py``);
* the VJP of ``fused_block_pair`` in float32 at rtol 1e-4, and autograd of
  the plain version in float64 at rtol 1e-10.

Three spec pairs: the config file's split kernel, a small one, and one with
a centred-categorical (``cat_mod``) component; every input has a short
subject and a ghost subject. The K4 route of ``gp_block_operators`` (K1 off,
the block-pair switch on) and ``minibatch_kld`` are held against JAX with
``use_pallas_b_chain=False`` in float64 at 1e-8, values and gradients, and
against the port's plain route in float32 at 1e-6.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lvae_tpu.ops.kernels as jkx
from lvae_tpu.kernels_pallas import kernel_matrix as jkm
from lvae_tpu.ops import elbo as jeb
from lvae_torch.kernels_cuda import block_pair as bp
from lvae_torch.ops import elbo as teb
from lvae_torch.ops import kernels as tkx

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_SPEC = dict(
    cat_kernel=[2], sqexp_kernel=[0],
    cat_int_kernel=[{"cont_covariate": 0, "cat_covariate": 2},
                    {"cont_covariate": 0, "cat_covariate": 3},
                    {"cont_covariate": 1, "cat_covariate": 4}],
    id_covariate=2,
)
SMALL_SPEC = dict(cat_kernel=[2], sqexp_kernel=[0],
                  cat_int_kernel=[{"cont_covariate": 0, "cat_covariate": 2}], id_covariate=2)


def cat_mod_specs(kx):
    comp = kx.KernelComponent
    spec0 = kx.KernelSpec(components=(
        comp(kind="cat_mod", rbf_col=-1, eq_cols=(), and_cols=(), cat_mod=(3, 4)),
        comp(kind="sqexp", rbf_col=0, eq_cols=(), and_cols=(), cat_mod=(-1, 0)),
        comp(kind="bin_rbf", rbf_col=1, eq_cols=(), and_cols=(4,), cat_mod=(-1, 0)),
    ))
    spec1 = kx.KernelSpec(components=(
        comp(kind="cat", rbf_col=-1, eq_cols=(2,), and_cols=(), cat_mod=(-1, 0)),
        comp(kind="cat_rbf", rbf_col=0, eq_cols=(2,), and_cols=(), cat_mod=(-1, 0)),
    ))
    return spec0, spec1


CASES = {
    # name: (S, T, L)
    "config": (4, 5, 3),
    "small": (5, 3, 2),
    "cat_mod": (4, 4, 2),
}


def specs(name, kx):
    if name == "cat_mod":
        return cat_mod_specs(kx)
    return kx.split_kernel_spec(**(CONFIG_SPEC if name == "config" else SMALL_SPEC))


def make_case(name, dtype):
    """Numpy covariates ``[S, T, 6]`` in the HealthMNIST layout (a short
    subject, a ghost), the mask, and raw parameters of both specs."""
    s, t, latent = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    xb = np.zeros((s, t, 6))
    xb[:, :, 0] = np.arange(t)[None] + rng.uniform(size=(s, 1))
    xb[:, :, 1] = rng.normal(size=(s, t))
    xb[:, :, 2] = np.arange(s)[:, None]
    xb[:, :, 3] = rng.integers(0, 4, size=(s, t)) if name == "cat_mod" else \
        rng.integers(0, 2, size=(s, 1))
    xb[:, :, 4:] = rng.integers(0, 2, size=(s, 1, 2))
    mask = np.ones((s, t))
    mask[1, t - 1:] = 0.0
    mask[3] = 0.0
    xb *= mask[..., None]
    c0, c1 = (len(sp.components) for sp in specs(name, jkx))
    raw = {
        "s0": rng.normal(size=(latent, c0)) * 0.3, "l0": rng.normal(size=(latent, c0)) * 0.3 + 1,
        "s1": rng.normal(size=(latent, c1)) * 0.3, "l1": rng.normal(size=(latent, c1)) * 0.3 + 1,
    }
    out = {k: v.astype(dtype) for k, v in raw.items()}
    out.update(xb=xb.astype(dtype), mask=mask.astype(dtype))
    return out


def constrained(kx, raw_s, raw_l):
    ls = kx.constrain(raw_l)
    return kx.constrain(raw_s), 0.5 / (ls * ls)


def t(x):
    return torch.tensor(np.asarray(x))


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_version_matches_jax_block_kernels_f64(case):
    a = make_case(case, np.float64)
    js0, js1 = specs(case, jkx)
    ts0, ts1 = specs(case, tkx)
    xb, mask = jnp.asarray(a["xb"]), jnp.asarray(a["mask"])
    want0 = jkx.block_kernel_matrix(js0, jkx.KernelParams(a["s0"], a["l0"]), xb, mask)
    want1 = jkx.block_kernel_matrix(js1, jkx.KernelParams(a["s1"], a["l1"]), xb, mask)
    got0, got1 = bp.block_kernel_pair(ts0, ts1, tkx.KernelParams(t(a["s0"]), t(a["l0"])),
                                      tkx.KernelParams(t(a["s1"]), t(a["l1"])), t(a["xb"]),
                                      t(a["mask"]))
    assert got0.dtype == torch.float64
    np.testing.assert_allclose(got0.detach().numpy(), np.asarray(want0), rtol=1e-8, atol=1e-14)
    np.testing.assert_allclose(got1.detach().numpy(), np.asarray(want1), rtol=1e-8, atol=1e-14)
    # the ghost subject's blocks are exactly zero
    assert not got0[:, 3].any() and not got1[:, 3].any()


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_pallas_interpret_f32(case):
    a = make_case(case, np.float32)
    js0, js1 = specs(case, jkx)
    ts0, ts1 = specs(case, tkx)
    s0, g0 = constrained(jkx, jnp.asarray(a["s0"]), jnp.asarray(a["l0"]))
    s1, g1 = constrained(jkx, jnp.asarray(a["s1"]), jnp.asarray(a["l1"]))
    want = jkm._block_pair_pallas(js0, js1, s0, g0, s1, g1, jnp.asarray(a["xb"]),
                                  jnp.asarray(a["mask"]), interpret=True)
    ts0_, tg0 = constrained(tkx, t(a["s0"]), t(a["l0"]))
    ts1_, tg1 = constrained(tkx, t(a["s1"]), t(a["l1"]))
    got = bp.block_pair(ts0, ts1, ts0_, tg0, ts1_, tg1, t(a["xb"]), t(a["mask"]))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)


def cotangents(shape, dtype):
    n = int(np.prod(shape))
    return (np.cos(np.arange(n)).reshape(shape).astype(dtype),
            np.sin(0.5 * np.arange(n)).reshape(shape).astype(dtype))


def torch_grads(case, a, fn):
    """(d s0, d g0, d s1, d g1) of Σ cot ⊙ (K0, K1) through ``fn``."""
    ts0, ts1 = specs(case, tkx)
    s0, g0 = (x.detach().requires_grad_(True) for x in constrained(tkx, t(a["s0"]), t(a["l0"])))
    s1, g1 = (x.detach().requires_grad_(True) for x in constrained(tkx, t(a["s1"]), t(a["l1"])))
    leaves = [s0, g0, s1, g1]
    k0, k1 = fn(ts0, ts1, s0, g0, s1, g1, t(a["xb"]), t(a["mask"]))
    c0, c1 = cotangents(tuple(k0.shape), a["xb"].dtype)
    (torch.sum(k0 * t(c0)) + torch.sum(k1 * t(c1))).backward()
    return [x.grad.numpy() for x in leaves]


@pytest.mark.parametrize("case", sorted(CASES))
def test_backward_matches_jax_vjp_of_fused_block_pair_f32(case):
    a = make_case(case, np.float32)
    js0, js1 = specs(case, jkx)
    s0, g0 = constrained(jkx, jnp.asarray(a["s0"]), jnp.asarray(a["l0"]))
    s1, g1 = constrained(jkx, jnp.asarray(a["s1"]), jnp.asarray(a["l1"]))
    xb, mask = jnp.asarray(a["xb"]), jnp.asarray(a["mask"])
    (k0, _), vjp = jax.vjp(lambda *p: jkm.fused_block_pair(js0, js1, *p, xb, mask),
                           s0, g0, s1, g1)
    want = vjp(tuple(jnp.asarray(c) for c in cotangents(k0.shape, np.float32)))
    got = torch_grads(case, a, bp.BlockPair.apply)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-4 * np.abs(w).max())


@pytest.mark.parametrize("case", sorted(CASES))
def test_backward_matches_autograd_of_plain_version_f64(case):
    a = make_case(case, np.float64)
    want = torch_grads(case, a, bp.block_pair_reference)
    got = torch_grads(case, a, bp.BlockPair.apply)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-10, atol=1e-13)


# ---------------------------------------------------------------- routing
def batch(dtype, seed=0, latent=3, m_ind=6):
    """A Hensman batch in the config layout: covariates, mask, inducing
    points, raw parameters, noise, moments and a PSD H."""
    a = make_case("config", dtype)
    rng = np.random.default_rng(seed)
    s, t_len = a["mask"].shape
    z = np.concatenate([a["xb"][0], a["xb"][2]], axis=0)[:m_ind].copy()
    z[:, 0] = np.linspace(0.0, 6.0, m_ind)
    h = rng.normal(size=(latent, m_ind, m_ind)) / 3
    a.update(
        z=z.astype(dtype), noise=(rng.uniform(size=latent) + 0.5).astype(dtype),
        mu=rng.normal(size=(s, t_len, latent)).astype(dtype),
        lv=(rng.normal(size=(s, t_len, latent)) * 0.1).astype(dtype),
        m=rng.normal(size=(latent, m_ind, 1)).astype(dtype),
        H=(h @ np.swapaxes(h, -1, -2) + 0.5 * np.eye(m_ind)).astype(dtype),
    )
    return a


KEYS = ("s0", "l0", "s1", "l1", "noise", "mu", "lv")


def jax_kld(a):
    js0, js1 = specs("config", jkx)

    def fn(s0, l0, s1, l1, noise, mu, lv):
        H = jnp.asarray(a["H"])
        ops = jeb.gp_block_operators(
            js0, js1, jkx.KernelParams(s0, l0), jkx.KernelParams(s1, l1), noise,
            jnp.asarray(a["xb"]), jnp.asarray(a["z"]), mask=jnp.asarray(a["mask"]), eps=1e-5,
            extra_spd=H)
        kld, _ = jeb.minibatch_kld(ops, jnp.asarray(a["m"]), H, mu, lv, P_tot=7, P_batch=3.0,
                                   N_tot=31, natural_gradient=True,
                                   H_factor=(ops.extra_chol, ops.extra_inv))
        return kld

    val, grads = jax.value_and_grad(fn, argnums=tuple(range(7)))(
        *(jnp.asarray(a[k]) for k in KEYS))
    return float(val), [np.asarray(g) for g in grads]


def torch_kld(a):
    ts0, ts1 = specs("config", tkx)
    leaves = [t(a[k]).requires_grad_(True) for k in KEYS]
    s0, l0, s1, l1, noise, mu, lv = leaves
    H = t(a["H"])
    ops = teb.gp_block_operators(
        ts0, ts1, tkx.KernelParams(s0, l0), tkx.KernelParams(s1, l1), noise, t(a["xb"]),
        t(a["z"]), mask=t(a["mask"]), eps=1e-5, extra_spd=H)
    kld, _ = teb.minibatch_kld(ops, t(a["m"]), H, mu, lv, P_tot=7,
                               P_batch=torch.tensor(3.0, dtype=H.dtype), N_tot=31,
                               natural_gradient=True, H_factor=(ops.extra_chol, ops.extra_inv))
    kld.backward()
    return ops, float(kld.detach()), [x.grad.numpy() for x in leaves]


@pytest.fixture
def k4_route(monkeypatch):
    """K1 off and the block-pair switch on, in both packages."""
    monkeypatch.setattr(tkx, "use_b_chain_kernel", False)
    monkeypatch.setattr(tkx, "use_block_pair_kernel", True)
    monkeypatch.setattr(jkx, "use_pallas_b_chain", False)
    monkeypatch.setattr(jkx, "use_pallas_block_pair", True)


def test_k4_route_minibatch_kld_matches_jax_f64(k4_route, monkeypatch):
    """The K4 route's value and gradients against JAX's with the K1 route
    off. K4's gate takes f32 only; the CPU wrapper computes in any dtype, so
    the gate is opened to run ``BlockPair`` in float64 here."""
    monkeypatch.setattr(bp, "usable", lambda *args: True)
    a = batch(np.float64)
    want, want_g = jax_kld(a)
    ops, got, got_g = torch_kld(a)
    assert type(ops.K0_st.grad_fn).__name__ == "BlockPairBackward"
    assert ops.B is not None and ops.tr_iB_K0 is None
    np.testing.assert_allclose(got, want, rtol=1e-8)
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(g, w, rtol=1e-8, atol=1e-8 * np.abs(w).max())


def test_k4_route_equals_plain_route_f32(k4_route, monkeypatch):
    """In float32 (K4's own gate) the K4 route gives the plain route's bound
    and gradients. (Against JAX in f32 this batch is not a test: both
    packages' f32 bounds sit 15% from the f64 value, an ill-conditioned
    K0zz.)"""
    a = batch(np.float32)
    ops, got, got_g = torch_kld(a)
    assert type(ops.K0_st.grad_fn).__name__ == "BlockPairBackward"
    monkeypatch.setattr(tkx, "use_block_pair_kernel", False)
    plain_ops, want, want_g = torch_kld(a)
    assert type(plain_ops.K0_st.grad_fn).__name__ != "BlockPairBackward"
    np.testing.assert_allclose(got, want, rtol=1e-6)
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6 * np.abs(w).max())


@pytest.mark.parametrize("switch,route", [(None, "plain"), (True, "k1"), (False, "plain")])
def test_b_chain_switch_routes_cpu_tensors(monkeypatch, switch, route):
    """None (auto) takes K1 for CUDA tensors only, True forces the K1 route
    on every device (the CPU runs its plain version through BChain), False
    turns it off; with K1 off and the block-pair switch off the plain block
    kernels run."""
    monkeypatch.setattr(tkx, "use_b_chain_kernel", switch)
    monkeypatch.setattr(tkx, "use_block_pair_kernel", False)
    a = batch(np.float32)
    ops, _, _ = torch_kld(a)
    if route == "k1":
        assert ops.K0_st is None and ops.B is None and ops.tr_iB_K0 is not None
    else:
        assert ops.B is not None and type(ops.K0_st.grad_fn).__name__ != "BlockPairBackward"


@pytest.mark.parametrize("value,want", [
    ("1", True), ("true", True), ("ON", True), ("yes", True),
    ("0", False), ("false", False), ("off", False), ("No", False),
    ("", None), ("auto", None), (" auto ", None),
])
def test_lvae_bchain_parse(value, want):
    assert tkx.b_chain_from_env(value) is want


def test_lvae_bchain_bad_value_raises():
    with pytest.raises(ValueError, match="LVAE_BCHAIN"):
        tkx.b_chain_from_env("sometimes")


def test_lvae_bchain_environment_sets_the_switch():
    """The module reads $LVAE_BCHAIN at import, as the JAX package does, and
    refuses a bad value at import."""
    code = "import lvae_torch.ops.kernels as k; print(k.use_b_chain_kernel, k.use_block_pair_kernel)"
    env = {**os.environ, "PYTHONPATH": ROOT, "LVAE_BCHAIN": "0"}
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "False"]
    env["LVAE_BCHAIN"] = "maybe"
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and "LVAE_BCHAIN" in out.stderr


def test_extra_spd_of_another_shape_is_factored_apart():
    """An ``extra_spd`` whose shape differs from K0zz's is factored in a
    call of its own (it used to be concatenated with K0zz and raise)."""
    a = batch(np.float64)
    rng = np.random.default_rng(3)
    h = rng.normal(size=(2, 4, 4))
    extra = h @ np.swapaxes(h, -1, -2) + np.eye(4)
    js0, js1 = specs("config", jkx)
    ts0, ts1 = specs("config", tkx)
    jops = jeb.gp_block_operators(
        js0, js1, jkx.KernelParams(a["s0"], a["l0"]), jkx.KernelParams(a["s1"], a["l1"]),
        jnp.asarray(a["noise"]), jnp.asarray(a["xb"]), jnp.asarray(a["z"]),
        mask=jnp.asarray(a["mask"]), eps=1e-5, extra_spd=jnp.asarray(extra))
    tops = teb.gp_block_operators(
        ts0, ts1, tkx.KernelParams(t(a["s0"]), t(a["l0"])),
        tkx.KernelParams(t(a["s1"]), t(a["l1"])), t(a["noise"]), t(a["xb"]), t(a["z"]),
        mask=t(a["mask"]), eps=1e-5, extra_spd=t(extra))
    assert tuple(tops.extra_inv.shape) == (2, 4, 4)
    for name in ("extra_chol", "extra_inv", "LK0zz", "iK0zz", "iB", "logdet_B"):
        np.testing.assert_allclose(getattr(tops, name).detach().numpy(),
                                   np.asarray(getattr(jops, name)), rtol=1e-8, atol=1e-12,
                                   err_msg=name)


def test_usable_gate():
    """f32, ``[L, C]`` parameters, both specs within the table and a
    subject's covariates within a block's shared memory. No T limit below
    that, and no ``L·S·T²`` budget (the TPU's VMEM limit)."""
    ts0, ts1 = specs("config", tkx)
    kp = tkx.init_kernel_params(ts0, 3)

    def can(t_len, dtype=torch.float32, s0=ts0, s1=ts1, kp0=kp, q=6):
        return bp.usable(s0, s1, kp0, torch.zeros((2, t_len, q), dtype=dtype))

    assert all(can(t_len) for t_len in (1, 2, 20, 128, 150, 1000))
    assert not can(20, torch.float64)
    assert not can(20, kp0=tkx.init_kernel_params(ts0))  # [C] parameters
    assert not can(20, s1=tkx.KernelSpec(components=ts1.components * 9))  # > 16 components
    assert not can(20, s0=tkx.KernelSpec(components=()))
    assert not can(10000, q=6)  # 10000 × 6 covariates exceed the shared memory


def test_wrapper_refuses_other_devices():
    ts0, ts1 = specs("small", tkx)
    x = torch.zeros((2, 3, 6), device="meta")
    p = torch.zeros((2, 2), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        bp.block_pair(ts0, ts1, p, p, p, p, x, torch.zeros((2, 3), device="meta"))
