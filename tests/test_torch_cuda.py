"""The port's CUDA kernels K1 to K5 on the card (marked ``cuda``).

These tests need an NVIDIA GPU and ``nvcc``; without a card they skip. On a
machine with a card, where JAX may be absent, run them without the suite's
JAX conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: max |Δ| over max |reference| per matrix, 1e-4 at n <= 20 and
1e-3 at n = 64, on SPD stacks with condition number 1e2 (f32 rounding grows
with n and the condition number; the two versions sum in other orders). The
B-chain (K1) is held the same way per (latent, subject) block, its log|B|
and trace per latent at 1e-4 (2e-4 from T = 64), and every gradient at
max |Δ| over max |reference| ≤ 1e-3 per array: the backward is plain torch
on both sides, fed B⁻¹ from the kernel on one side and from
``torch.linalg`` on the other. The kernel matrix (K3) is held at max |Δ|
over max |reference| ≤ 1e-5 (one expf and a few products per term, summed in
the same order as the plain version) and its gradient at 1e-4; the fused
Adam (K5) at 1e-6 relative per step against its plain version (a fused
multiply-add may round once less) and at 1e-5 relative to the update
against ``torch.optim.Adam``, whose bias correction is written differently.
The block pair (K4) is held at max |Δ| over max |reference| ≤ 1e-6 (the
same expf and products per term as the plain version) and its gradient at
1e-4.
"""

import math

import pytest
import torch

from lvae_torch.kernels_cuda import adam as k5
from lvae_torch.kernels_cuda import b_chain as k1
from lvae_torch.kernels_cuda import block_pair as k4
from lvae_torch.kernels_cuda import cholesky as k2
from lvae_torch.kernels_cuda import kernel_matrix as k3
from lvae_torch.ops import elbo as eb
from lvae_torch.ops import kernels as kx
from lvae_torch.ops import linalg as la

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


def spd_stack(shape, n, gen, cond=1e2):
    x = torch.randn(*shape, n, n, generator=gen, dtype=torch.float64, device="cuda")
    q, _ = torch.linalg.qr(x)
    lam = torch.logspace(0, math.log10(cond), n, dtype=torch.float64, device="cuda")
    a = (q * lam) @ q.mT
    return (0.5 * (a + a.mT)).float().contiguous()


def rel_err(got, want):
    num = (got - want).abs().amax(dim=(-1, -2))
    return float((num / want.abs().amax(dim=(-1, -2))).max())


@pytest.mark.parametrize("shape,n,tol", [((5, 3), 2, 1e-4), ((32, 100), 20, 1e-4), ((7,), 64, 1e-3)])
def test_kernel_matches_plain_version(gen, shape, n, tol):
    a = spd_stack(shape, n, gen)
    before = k2.cholesky_inverse.launches
    l, inv = k2.cholesky_inverse(a)
    torch.cuda.synchronize()
    assert k2.cholesky_inverse.launches == before + 1
    lr, ir = k2.cholesky_inverse_reference(a)
    assert rel_err(l, lr) <= tol and rel_err(inv, ir) <= tol
    assert bool((torch.triu(l, 1) == 0).all())
    assert torch.equal(inv, inv.mT)


def test_non_spd_block_gives_nan_in_that_block_only(gen):
    a = spd_stack((4,), 20, gen)
    a[2] = -a[2]
    l, inv = k2.cholesky_inverse(a)
    torch.cuda.synchronize()
    assert torch.isnan(l[2]).any() and torch.isnan(inv[2]).any()
    assert torch.isfinite(l[[0, 1, 3]]).all() and torch.isfinite(inv[[0, 1, 3]]).all()


def test_cholesky_and_inverse_gate(gen):
    """f32 with 2 <= n <= 64 launches the kernel; other dtypes and sizes take
    the plain path, as the JAX package sends them to XLA."""
    a = spd_stack((3,), 20, gen)
    before = k2.cholesky_inverse.launches
    la.cholesky_and_inverse(a)
    assert k2.cholesky_inverse.launches == before + 1
    la.cholesky_and_inverse(a.double())
    la.cholesky_and_inverse(spd_stack((2,), 65, gen))
    assert k2.cholesky_inverse.launches == before + 1


def test_wrapper_rejects_what_the_kernel_does_not_take(gen):
    a = spd_stack((3,), 20, gen)
    with pytest.raises(ValueError):
        k2.cholesky_inverse(a.double())
    with pytest.raises(ValueError):
        k2.cholesky_inverse(a.mT)
    with pytest.raises(ValueError):
        k2.cholesky_inverse(spd_stack((2,), 65, gen))


# ------------------------------------------------------------ K2 gradient
@pytest.mark.parametrize("shape,n", [((64,), 60), ((32,), 60), ((5, 3), 2), ((32, 20), 20), ((7,), 64)])
def test_cholesky_inverse_gradient_on_the_card(gen, shape, n):
    """CholeskyInverse's backward (kernel forward) against torch.autograd
    through the plain torch.linalg version."""
    a = spd_stack(shape, n, gen)
    wl = torch.randn(a.shape, generator=gen, device="cuda")
    wi = torch.randn(a.shape, generator=gen, device="cuda")
    x = a.clone().requires_grad_(True)
    before = k2.cholesky_inverse.launches
    l, inv = la.cholesky_and_inverse(x)
    ((l * wl).sum() + (inv * wi).sum()).backward()
    assert k2.cholesky_inverse.launches == before + 1
    y = a.clone().requires_grad_(True)
    lr, ir = k2.cholesky_inverse_reference(y)
    ((lr * wl).sum() + (ir * wi).sum()).backward()
    sym = 0.5 * (y.grad + y.grad.mT)  # autograd's gradient need not be symmetric
    got = 0.5 * (x.grad + x.grad.mT)
    assert rel_err(got, sym) <= 1e-3


# -------------------------------------------------------------------- K1
SPEC_ARGS = dict(
    cat_kernel=[2], sqexp_kernel=[0],
    cat_int_kernel=[{"cont_covariate": 0, "cat_covariate": 2},
                    {"cont_covariate": 0, "cat_covariate": 3},
                    {"cont_covariate": 1, "cat_covariate": 4}],
    id_covariate=2,
)


def chain_inputs(gen, n_subj, t, n_lat=4):
    """Constrained params and a ragged HealthMNIST-layout batch on the card:
    subject 1 short, the last subject a ghost."""
    spec0, spec1 = kx.split_kernel_spec(**SPEC_ARGS)
    dev = "cuda"
    xb = torch.zeros(n_subj, t, 6, device=dev)
    xb[:, :, 0] = torch.arange(t, device=dev) + torch.rand(n_subj, 1, generator=gen, device=dev)
    xb[:, :, 1] = torch.randn(n_subj, t, generator=gen, device=dev)
    xb[:, :, 2] = torch.arange(n_subj, device=dev)[:, None].float()
    xb[:, :, 3:] = torch.randint(0, 2, (n_subj, 1, 3), generator=gen, device=dev).float()
    mask = torch.ones(n_subj, t, device=dev)
    mask[1, t // 2:] = 0.0
    mask[-1] = 0.0
    xb = (xb * mask[..., None]).contiguous()

    def params(c):
        scale = 0.5 + torch.rand(n_lat, c, generator=gen, device=dev)
        ls = 1.5 + torch.rand(n_lat, c, generator=gen, device=dev)
        return scale, 0.5 / (ls * ls)

    s0, g0 = params(len(spec0.components))
    s1, g1 = params(len(spec1.components))
    noise = 0.5 + torch.rand(n_lat, generator=gen, device=dev)
    return spec0, spec1, s0, g0, s1, g1, noise, xb, mask


@pytest.mark.parametrize("t", [2, 20, 64, 65, 128])
def test_b_chain_kernel_matches_plain_version(gen, t):
    args = chain_inputs(gen, 5, t)
    before = k1.b_chain.launches
    ib, ld, tr = k1.b_chain(*args)
    torch.cuda.synchronize()
    assert k1.b_chain.launches == before + 1
    ibr, ldr, trr = k1.b_chain_reference(*args)
    tol = 1e-4 if t <= 20 else 1e-3
    assert rel_err(ib, ibr) <= tol
    tol_s = 1e-4 if t < 64 else 2e-4
    assert float(((ld - ldr).abs() / ldr.abs().clamp(min=1.0)).max()) <= tol_s
    assert float(((tr - trr).abs() / trr.abs().clamp(min=1.0)).max()) <= tol_s
    assert torch.equal(ib, ib.mT)
    # ghost rows factor as the identity
    torch.testing.assert_close(ib[:, -1], torch.eye(t, device="cuda").expand_as(ib[:, -1]),
                               rtol=0, atol=0)


@pytest.mark.parametrize("t", [2, 20, 64, 65, 128])
def test_b_chain_gradient_matches_autograd_of_plain_version(gen, t):
    spec0, spec1, *leaves, xb, mask = chain_inputs(gen, 5, t)
    w = torch.randn(leaves[0].shape[0], 5, t, t, generator=gen, device="cuda")

    def grads(fn):
        xs = [x.clone().requires_grad_(True) for x in leaves]
        ib, ld, tr = fn(spec0, spec1, *xs, xb, mask)
        ((ib * w).sum() + 0.7 * ld.sum() + 1.3 * tr.sum()).backward()
        return [x.grad for x in xs]

    got = grads(k1.BChain.apply)
    want = grads(k1.b_chain_reference)
    for g, r in zip(got, want):
        assert float((g - r).abs().max() / r.abs().max()) <= 1e-3


def test_b_chain_non_spd_latent_gives_nan_there_only(gen):
    args = list(chain_inputs(gen, 5, 20))
    args[6] = args[6].clone()
    args[6][2] = -50.0  # sigma^2 of latent 2: every real block of it is indefinite
    ib, ld, tr = k1.b_chain(*args)
    torch.cuda.synchronize()
    assert torch.isnan(ib[2, 0]).any() and torch.isnan(ld[2]) and torch.isnan(tr[2])
    keep = [0, 1, 3]
    assert torch.isfinite(ib[keep]).all() and torch.isfinite(ld[keep]).all()
    assert torch.isfinite(tr[keep]).all()


def test_gp_block_operators_routes_to_the_kernels(gen):
    """A CUDA f32 batch inside usable()'s shapes runs K1 once and K2 once
    (the stacked [K0zz; H]); T = 129 takes the plain chain."""
    spec0, spec1, *_ = chain_inputs(gen, 3, 4)
    n_lat, m_ind = 4, 8
    kp0 = kx.init_kernel_params(spec0, n_lat, device="cuda")
    kp1 = kx.init_kernel_params(spec1, n_lat, device="cuda")
    noise = torch.ones(n_lat, device="cuda")
    for t, k1_runs in ((20, 1), (129, 0)):
        *_, xb, mask = chain_inputs(gen, 3, t, n_lat)
        z = xb[0, :m_ind].clone()
        z[:, 0] = torch.linspace(0, t, m_ind, device="cuda")
        h = spd_stack((n_lat,), m_ind, gen)
        b1, b2 = k1.b_chain.launches, k2.cholesky_inverse.launches
        ops = eb.gp_block_operators(spec0, spec1, kp0, kp1, noise, xb, z, mask=mask,
                                    eps=1e-4, extra_spd=h)
        torch.cuda.synchronize()
        assert k1.b_chain.launches - b1 == k1_runs
        assert k2.cholesky_inverse.launches - b2 == 1
        assert (ops.tr_iB_K0 is not None) == bool(k1_runs)
        assert torch.isfinite(ops.iB).all()


def test_b_chain_wrapper_rejects_what_the_kernel_does_not_take(gen):
    args = list(chain_inputs(gen, 3, 20))
    with pytest.raises(ValueError):
        k1.b_chain(*args[:7], args[7].double(), args[8])
    with pytest.raises(ValueError):
        k1.b_chain(*args[:7], args[7].transpose(0, 1).contiguous().transpose(0, 1), args[8])
    big = chain_inputs(gen, 2, 129)
    with pytest.raises(ValueError):
        k1.b_chain(*big)


# -------------------------------------------------------------------- K3
def covariates(gen, n):
    """HealthMNIST-layout covariates [n, 6] on the card: few distinct
    discrete values, so every equality factor is both 0 and 1."""
    x = torch.zeros(n, 6, device="cuda")
    x[:, 0] = torch.randint(0, 20, (n,), generator=gen, device="cuda").float()
    x[:, 1] = torch.randn(n, generator=gen, device="cuda")
    x[:, 2] = torch.randint(0, 30, (n,), generator=gen, device="cuda").float()
    x[:, 3:] = torch.randint(0, 2, (n, 3), generator=gen, device="cuda").float()
    return x


def k3_spec(name):
    spec0, spec1 = kx.split_kernel_spec(**SPEC_ARGS)
    if name == "healthmnist":
        return kx.KernelSpec(components=spec0.components + spec1.components)
    comp = kx.KernelComponent
    return kx.KernelSpec(components=(
        comp(kind="cat_mod", rbf_col=-1, eq_cols=(), and_cols=(), cat_mod=(3, 2)),
        comp(kind="cat_mod_rbf", rbf_col=0, eq_cols=(2,), and_cols=(4,), cat_mod=(5, 2)),
        *spec1.components,
    ))


def k3_params(gen, spec, n_lat):
    c = len(spec.components)
    return kx.KernelParams(0.3 * torch.randn(n_lat, c, generator=gen, device="cuda"),
                           0.3 * torch.randn(n_lat, c, generator=gen, device="cuda") + 1.0)


@pytest.mark.parametrize("name", ["healthmnist", "cat_mod"])
@pytest.mark.parametrize("shape", [(3, 517, 1030), (2, 70, 37), (32, 520, 520)])
def test_kernel_matrix_kernel_matches_plain_version(gen, name, shape):
    n_lat, n1, n2 = shape
    spec = k3_spec(name)
    kp = k3_params(gen, spec, n_lat)
    x1, x2 = covariates(gen, n1), covariates(gen, n2)
    scale = kx.constrain(kp.raw_scale)
    g = 0.5 / kx.constrain(kp.raw_lengthscale) ** 2
    before = k3.kernel_matrix_fused.launches
    got = k3.kernel_matrix_fused(spec, scale, g, x1, x2)
    torch.cuda.synchronize()
    assert k3.kernel_matrix_fused.launches == before + 1
    want = k3.kernel_matrix_reference(spec, scale, g, x1, x2)
    assert got.shape == want.shape == shape
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-5


def test_kernel_matrix_gradient_and_masks_on_the_card(gen):
    spec = k3_spec("cat_mod")
    kp = k3_params(gen, spec, 4)
    x1, x2 = covariates(gen, 600), covariates(gen, 530)
    m1 = (torch.rand(600, generator=gen, device="cuda") > 0.2).float()
    m2 = (torch.rand(530, generator=gen, device="cuda") > 0.2).float()
    cot = torch.randn(4, 600, 530, generator=gen, device="cuda")

    def run(fn):
        leaves = [t.clone().requires_grad_(True) for t in kp]
        out = fn(spec, kx.KernelParams(*leaves), x1, x2, m1, m2)
        (out * cot).sum().backward()
        return out.detach(), [t.grad for t in leaves]

    before = k3.kernel_matrix_fused.launches
    got, got_g = run(kx.kernel_matrix)  # the gate routes this shape to K3
    assert k3.kernel_matrix_fused.launches == before + 1

    def plain(spec, params, x1, x2, m1, m2):
        scale = kx.constrain(params.raw_scale)
        g = 0.5 / kx.constrain(params.raw_lengthscale) ** 2
        out = k3.kernel_matrix_reference(spec, scale, g, x1, x2)
        return out * m1[:, None] * m2[None, :]

    want, want_g = run(plain)
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-5
    assert bool((got[:, m1 == 0] == 0).all()) and bool((got[:, :, m2 == 0] == 0).all())
    for a, b in zip(got_g, want_g):
        assert float((a - b).abs().max() / b.abs().max()) <= 1e-4


def test_kernel_matrix_gate_on_the_card(gen):
    spec = k3_spec("healthmnist")
    kp = k3_params(gen, spec, 2)
    before = k3.kernel_matrix_fused.launches
    kx.kernel_matrix(spec, kp, covariates(gen, 511), covariates(gen, 600))
    kx.kernel_matrix(spec, kp.to(torch.float64), covariates(gen, 600).double(),
                     covariates(gen, 600).double())
    kx.kernel_matrix(spec, kp, covariates(gen, 600), covariates(gen, 60))
    assert k3.kernel_matrix_fused.launches == before
    kx.kernel_matrix(spec, kp, covariates(gen, 512), covariates(gen, 512))
    assert k3.kernel_matrix_fused.launches == before + 1


def test_kernel_matrix_wrapper_rejects_what_the_kernel_does_not_take(gen):
    spec = k3_spec("healthmnist")
    kp = k3_params(gen, spec, 2)
    scale, g = kx.constrain(kp.raw_scale), kx.constrain(kp.raw_lengthscale)
    x = covariates(gen, 40)
    with pytest.raises(ValueError):
        k3.kernel_matrix_fused(spec, scale.double(), g.double(), x.double(), x.double())
    with pytest.raises(ValueError):
        k3.kernel_matrix_fused(spec, scale, g, x.t().contiguous().t(), x)
    with pytest.raises(ValueError):
        k3.kernel_matrix_fused(spec, scale[:, :2].contiguous(), g[:, :2].contiguous(), x, x)


# -------------------------------------------------------------------- K5
def test_adam_kernel_matches_plain_version(gen):
    n = 1_000_003
    m = torch.zeros(n, device="cuda")
    v = torch.zeros(n, device="cuda")
    mr, vr = m.clone(), v.clone()
    for step in range(1, 4):
        g = torch.randn(n, generator=gen, device="cuda")
        c1, c2 = k5.bias_corrections(step, 0.9, 0.999)
        kw = dict(b1=0.9, b2=0.999, lr=1e-3, eps=1e-8, c1=c1, c2=c2)
        before = k5.fused_adam_update.launches
        d = k5.fused_adam_update(m, v, g, **kw)
        torch.cuda.synchronize()
        assert k5.fused_adam_update.launches == before + 1
        mr, vr, dr = k5.adam_reference(mr, vr, g, **kw)
        for got, want in ((m, mr), (v, vr), (d, dr)):
            assert float((got - want).abs().max() / want.abs().max()) <= 1e-6


def test_fused_adam_on_the_card_matches_torch_adam(gen):
    shapes = [(300, 2592), (30,), (1296,), (16, 1, 3, 3)]
    # from zero: an ulp of a unit-size weight is 1e-4 of a 1e-3 update
    init = [torch.zeros(s, device="cuda") for s in shapes]
    grads = [[torch.randn(s, generator=gen, device="cuda") for s in shapes] for _ in range(3)]

    def run(cls, **kw):
        ps = [p.clone().requires_grad_(True) for p in init]
        opt = cls(ps, lr=1e-3, **kw)
        for gs in grads:
            for p, gr in zip(ps, gs):
                p.grad = gr
            opt.step()
        return ps

    before = k5.fused_adam_update.launches
    ours = run(k5.FusedAdam)
    assert k5.fused_adam_update.launches == before + 3
    theirs = run(torch.optim.Adam, betas=(0.9, 0.999), eps=1e-8)
    for a, b in zip(ours, theirs):
        assert float((a - b).abs().max() / b.abs().max()) <= 1e-5


# -------------------------------------------------------------------- K4
def pair_args(gen, n_subj, t, n_lat=4):
    """The block pair's (spec0, spec1, s0, g0, s1, g1, xb, mask)."""
    spec0, spec1, s0, g0, s1, g1, _, xb, mask = chain_inputs(gen, n_subj, t, n_lat)
    return spec0, spec1, s0, g0, s1, g1, xb, mask


@pytest.mark.parametrize("shape", [(32, 20, 20), (4, 5, 2), (4, 3, 128), (3, 2, 150)])
def test_block_pair_kernel_matches_plain_version(gen, shape):
    n_lat, n_subj, t = shape
    args = pair_args(gen, n_subj, t, n_lat)
    before = k4.block_pair.launches
    k0, k1_ = k4.block_pair(*args)
    torch.cuda.synchronize()
    assert k4.block_pair.launches == before + 1
    r0, r1 = k4.block_pair_reference(*args)
    for got, want in ((k0, r0), (k1_, r1)):
        assert tuple(got.shape) == (n_lat, n_subj, t, t)
        assert float((got - want).abs().max() / want.abs().max()) <= 1e-6
    assert not k0[:, -1].any() and not k1_[:, -1].any()  # the ghost subject


@pytest.mark.parametrize("t", [20, 150])
def test_block_pair_gradient_matches_autograd_of_plain_version(gen, t):
    spec0, spec1, *leaves, xb, mask = pair_args(gen, 5, t)
    w = [torch.randn(leaves[0].shape[0], 5, t, t, generator=gen, device="cuda") for _ in range(2)]

    def grads(fn):
        xs = [x.clone().requires_grad_(True) for x in leaves]
        k0, k1_ = fn(spec0, spec1, *xs, xb, mask)
        ((k0 * w[0]).sum() + (k1_ * w[1]).sum()).backward()
        return [x.grad for x in xs]

    for g, r in zip(grads(k4.BlockPair.apply), grads(k4.block_pair_reference)):
        assert float((g - r).abs().max() / r.abs().max()) <= 1e-4


def test_gp_block_operators_k4_route_on_the_card(gen, monkeypatch):
    """With K1 off and the block-pair switch on, a CUDA f32 batch launches
    K4 once and K1 never, also past K1's T limit."""
    monkeypatch.setattr(kx, "use_b_chain_kernel", False)
    monkeypatch.setattr(kx, "use_block_pair_kernel", True)
    spec0, spec1, *_ = chain_inputs(gen, 3, 4)
    n_lat, m_ind = 4, 8
    kp0 = kx.init_kernel_params(spec0, n_lat, device="cuda")
    kp1 = kx.init_kernel_params(spec1, n_lat, device="cuda")
    noise = torch.ones(n_lat, device="cuda")
    for t in (20, 150):
        *_, xb, mask = chain_inputs(gen, 3, t, n_lat)
        z = xb[0, :m_ind].clone()
        z[:, 0] = torch.linspace(0, t, m_ind, device="cuda")
        b1, b4 = k1.b_chain.launches, k4.block_pair.launches
        ops = eb.gp_block_operators(spec0, spec1, kp0, kp1, noise, xb, z, mask=mask, eps=1e-4)
        torch.cuda.synchronize()
        assert k1.b_chain.launches == b1 and k4.block_pair.launches == b4 + 1
        plain0 = kx.block_kernel_matrix(spec0, kp0, xb, mask)
        assert float((ops.K0_st - plain0).abs().max() / plain0.abs().max()) <= 1e-6
        assert torch.isfinite(ops.iB).all()


def test_block_pair_wrapper_rejects_what_the_kernel_does_not_take(gen):
    args = list(pair_args(gen, 3, 20))
    with pytest.raises(ValueError):
        k4.block_pair(*args[:6], args[6].double(), args[7])
    with pytest.raises(ValueError):
        k4.block_pair(*args[:2], args[2][:, :1].contiguous(), *args[3:])
    with pytest.raises(ValueError):
        k4.block_pair(*args[:6], args[6].transpose(0, 1).contiguous().transpose(0, 1), args[7])
