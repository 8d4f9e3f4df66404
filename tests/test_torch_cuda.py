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
K2 is held at every n from 2 to 64 and at batches that leave the last
block partly filled, K1 at such a batch too, and another packing of warp
teams must give bit-equal results (every entry is computed in the same
order whatever thread does it). The block pair (K4) is held at max |Δ| over max |reference| ≤ 1e-6 (the
same expf and products per term as the plain version) and its gradient at
1e-4. For the same reason K3's symmetric walk (x1 is x2) must give the
general walk's bits on a copy, with each ``K[l]`` bitwise symmetric, and
K4's scalar stores the 16-byte stores' bits. Last, one VI phase-1 step
(K1 once, K2 at least once) and the RNN encoder under cuDNN with TF32 off
are held against the CPU.
"""

import math

import pytest
import torch

from lvae_torch.kernels_cuda import adam as k5
from lvae_torch.kernels_cuda import b_chain as k1
from lvae_torch.kernels_cuda import block_pair as k4
from lvae_torch.kernels_cuda import chol_plan as cp
from lvae_torch.kernels_cuda import cholesky as k2
from lvae_torch.kernels_cuda import kernel_matrix as k3
from lvae_torch.kernels_cuda import km_plan
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


def card_sms():
    return cp.num_sms(torch.device("cuda", torch.cuda.current_device()))


def k2_batches(n):
    """1, 7, an odd multiple (265 on 132 SMs) of the teams a block of a batch
    large enough for packed warp teams, and, where a block holds several
    teams, one matrix more, which leaves the last block one team."""
    sms = card_sms()
    odd = (cp.WARP_TEAMS_AN_SM * sms // cp.MAX_WARP_TEAMS) | 1
    teams = cp.chol_inv_plan(n, odd * cp.MAX_WARP_TEAMS, sms).teams
    return [1, 7, odd * teams] + ([odd * teams + 1] if teams > 1 else [])


@pytest.mark.parametrize("n", range(2, 65))
def test_kernel_matches_plain_version_at_every_n(gen, n):
    """Every n in 2..64 (warp teams up to 32, block teams above), at batches
    that leave the last block partly filled."""
    tol = 1e-4 if n <= 20 else 1e-3
    for batch in k2_batches(n):
        a = spd_stack((batch,), n, gen)
        l, inv = k2.cholesky_inverse(a)
        torch.cuda.synchronize()
        lr, ir = k2.cholesky_inverse_reference(a)
        assert rel_err(l, lr) <= tol and rel_err(inv, ir) <= tol
        assert bool((torch.triu(l, 1) == 0).all())
        assert torch.equal(inv, inv.mT)


@pytest.mark.parametrize("n", [20, 60])
def test_non_spd_block_among_teams_gives_nan_there_only(gen, n):
    """Non-SPD matrices 5 and the last (alone in the last block for n = 20)."""
    batch = k2_batches(n)[-1]
    a = spd_stack((batch,), n, gen)
    bad = [5, batch - 1]
    a[bad] = -a[bad]
    l, inv = k2.cholesky_inverse(a)
    torch.cuda.synchronize()
    good = torch.ones(batch, dtype=torch.bool, device="cuda")
    good[bad] = False
    for i in bad:
        assert torch.isnan(l[i]).any() and torch.isnan(inv[i]).any()
    assert torch.isfinite(l[good]).all() and torch.isfinite(inv[good]).all()


@pytest.mark.parametrize("n,batch", [(20, 3200), (20, 3201), (32, 700), (32, 701), (60, 32),
                                     (64, 7)])
def test_team_shape_does_not_change_the_result(gen, n, batch):
    """Every entry is computed in the same order whatever thread computes it,
    so another packing of warp teams (a last block full or not), or another
    count of threads a row, gives bit-equal L and A⁻¹."""
    a = spd_stack((batch,), n, gen)
    want = k2.cholesky_inverse(a)
    floats, sms = cp.chol_team_floats(n), card_sms()
    for v in (1, 2, 8):
        p = (cp.make_plan(n, batch, floats, sms, max_warp_teams=v, lanes=1)
             if n <= 32 else cp.make_plan(n, batch, floats, sms, lanes=v))
        got = k2._launch(a, p)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


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


@pytest.mark.parametrize("t", [2, 20, 31, 32, 33, 64, 65, 128])
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


@pytest.mark.parametrize("t", [2, 20, 31, 32, 33, 64, 65, 128])
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


@pytest.mark.parametrize("t", [20, 64, 128])
def test_b_chain_team_shape_changes_only_the_trace_rounding(gen, t):
    """The trace's partial sums follow the threads, so only tr(B⁻¹K0) may
    round differently under another team shape (packed warp teams for
    T <= 32, or another count of threads a row)."""
    args = chain_inputs(gen, 20, t, n_lat=32)
    q = args[7].shape[2]
    want = k1.b_chain(*args)
    floats, sms = cp.b_chain_team_floats(t, q), card_sms()
    plans = [cp.make_plan(t, 640, floats, sms, lanes=v) for v in (2, 8) if t > 32 or v > 1]
    if t <= 32:
        plans += [cp.make_plan(t, 640, floats, sms, max_warp_teams=v, lanes=1)
                  for v in (1, 2, 8)]
    for p in plans:
        ib, ld, tr = k1._launch(*args, p)
        assert torch.equal(ib, want[0]) and torch.equal(ld, want[1])
        assert float(((tr - want[2]).abs() / want[2].abs().clamp(min=1.0)).max()) <= 1e-5


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


def test_b_chain_partly_filled_last_block(gen):
    """L·S = 11 × 97 = 1,067 blocks: packed warp teams, the last thread block
    partly filled (its last team the ghost subject). Against the plain
    version, then with latent 10's σ² negative: NaN in its real blocks,
    the ghost beside them in the last thread block still the identity."""
    args = list(chain_inputs(gen, 97, 20, n_lat=11))
    p = cp.b_chain_plan(20, 11 * 97, args[7].shape[2], card_sms())
    assert p.team == cp.WARP and p.blocks * p.teams > 11 * 97
    ib, ld, tr = k1.b_chain(*args)
    ibr, ldr, trr = k1.b_chain_reference(*args)
    assert rel_err(ib, ibr) <= 1e-4
    assert float(((ld - ldr).abs() / ldr.abs().clamp(min=1.0)).max()) <= 1e-4
    assert float(((tr - trr).abs() / trr.abs().clamp(min=1.0)).max()) <= 1e-4
    args[6] = args[6].clone()
    args[6][-1] = -50.0
    ib, ld, tr = k1.b_chain(*args)
    torch.cuda.synchronize()
    assert torch.isnan(ib[-1, -2]).any() and torch.isnan(ld[-1]) and torch.isnan(tr[-1])
    assert torch.equal(ib[-1, -1], torch.eye(20, device="cuda"))
    assert torch.isfinite(ib[:-1]).all() and torch.isfinite(ld[:-1]).all()
    assert torch.isfinite(tr[:-1]).all()


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
@pytest.mark.parametrize("shape", [(3, 517, 1030), (2, 70, 37), (32, 520, 520),
                                   (32, 2000, 2000)])
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


@pytest.mark.parametrize("name", ["healthmnist", "cat_mod"])
@pytest.mark.parametrize("shape", [(32, 2000, 2000), (32, 520, 520), (9, 517, 517),
                                   (3, 70, 70), (1, 1, 1)])
def test_kernel_matrix_symmetric_walk_is_bit_equal_to_the_general_walk(gen, name, shape):
    """x1 is x2: the symmetric walk (tiles I >= J, mirrored through shared
    memory) against the general walk on a copy, bitwise, and each K[l]
    bitwise symmetric; also with scalar stores. N = 517 and 70 leave rows
    that take no 16-byte store."""
    n_lat, n, _ = shape
    spec = k3_spec(name)
    kp = k3_params(gen, spec, n_lat)
    x = covariates(gen, n)
    scale = kx.constrain(kp.raw_scale)
    g = 0.5 / kx.constrain(kp.raw_lengthscale) ** 2
    before = k3.kernel_matrix_fused.launches
    sym = k3.kernel_matrix_fused(spec, scale, g, x, x)
    general = k3.kernel_matrix_fused(spec, scale, g, x, x.clone())
    plan = km_plan.k3_plan(n_lat, n, n, x.shape[1], len(spec.components), True)
    scalar = k3._launch(spec, scale, g, x, x, plan._replace(vec=False))
    torch.cuda.synchronize()
    assert k3.kernel_matrix_fused.launches == before + 3
    bits = [t.view(torch.int32) for t in (sym, general, scalar)]
    assert torch.equal(bits[0], bits[1]) and torch.equal(bits[0], bits[2])
    assert torch.equal(bits[0], sym.mT.contiguous().view(torch.int32))
    want = k3.kernel_matrix_reference(spec, scale, g, x, x)
    assert float((sym - want).abs().max() / want.abs().max()) <= 1e-5


def test_kernel_matrix_symmetric_gradient_on_the_card(gen):
    """The closed-KL prior's call, x1 is x2 through ``kx.kernel_matrix``: K3's
    symmetric walk forward, FusedKernelMatrix's backward, against autograd of
    the plain version."""
    spec = k3_spec("healthmnist")
    kp = k3_params(gen, spec, 4)
    x = covariates(gen, 600)
    cot = torch.randn(4, 600, 600, generator=gen, device="cuda")

    def run(fn):
        leaves = [t.clone().requires_grad_(True) for t in kp]
        out = fn(spec, kx.KernelParams(*leaves), x, x)
        (out * cot).sum().backward()
        return out.detach(), [t.grad for t in leaves]

    def plain(spec, params, x1, x2):
        scale = kx.constrain(params.raw_scale)
        g = 0.5 / kx.constrain(params.raw_lengthscale) ** 2
        return k3.kernel_matrix_reference(spec, scale, g, x1, x2)

    before = k3.kernel_matrix_fused.launches
    got, got_g = run(kx.kernel_matrix)
    assert k3.kernel_matrix_fused.launches == before + 1
    want, want_g = run(plain)
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-5
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


@pytest.mark.parametrize("shape", [(32, 20, 20), (4, 5, 2), (4, 3, 128), (3, 2, 150),
                                   (4, 3, 3), (4, 3, 37), (5, 7, 3)])
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


@pytest.mark.parametrize("shape", [(32, 20, 20), (4, 3, 37), (5, 7, 3), (3, 2, 150)])
def test_block_pair_scalar_stores_and_transpose_are_bit_equal(gen, shape):
    """The plan with scalar stores gives the wrapper's bits; each block is
    bitwise symmetric. S·T² = 4107 and 63 take no 16-byte store."""
    n_lat, n_subj, t = shape
    args = pair_args(gen, n_subj, t, n_lat)
    k0, k1_ = k4.block_pair(*args)
    o0, o1 = k4._launch(*args, km_plan.k4_plan(n_lat, n_subj, t)._replace(vec=False))
    for got, want in ((o0, k0), (o1, k1_)):
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        assert torch.equal(want.view(torch.int32), want.mT.contiguous().view(torch.int32))


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


def vi_trainers(gen, p=6, t=20, n_lat=4, m_ind=8, num_dim=30):
    """One VI cohort (f32, every subject t frames) and a trainer for it on
    the card and on the CPU, from the same weights and GP parameters."""
    import numpy as np

    from lvae_torch.data.blocks import build_subject_blocks
    from lvae_torch.data.datasets import ArrayDataset
    from lvae_torch.models.vae import make_vae
    from lvae_torch.train.state import init_gp_params
    from lvae_torch.train.vi import VIConfig, VITrainer

    rng = np.random.default_rng(0)
    labels = np.asarray([[i, (i - 3.0) * (s % 2), s, s % 2, s % 2, (s // 2) % 2]
                         for s in range(p) for i in range(t)], np.float32)
    ds = ArrayDataset(data=rng.uniform(size=(p * t, num_dim)).astype(np.float32), labels=labels,
                      mask=(rng.uniform(size=(p * t, num_dim)) > 0.2).astype(np.float32))
    spec0, spec1 = kx.split_kernel_spec(
        id_covariate=2, cat_kernel=[2], sqexp_kernel=[0],
        cat_int_kernel=[{"cont_covariate": 0, "cat_covariate": 2}])
    cfg = VIConfig(spec0, spec1, latent_dim=n_lat, weight=0.15, loss_function="mse",
                   constrain_scales=True, eps=1e-5)
    blocks = build_subject_blocks(labels, 2)
    z = labels[rng.choice(p * t, m_ind, replace=False)]
    gp = init_gp_params(spec0, spec1, n_lat, constrain_scales=True)
    return [VITrainer(make_vae("simple", n_lat, num_dim, generator=torch.Generator().manual_seed(1)),
                      cfg, ds, blocks, z, gp, device=dev) for dev in ("cuda", "cpu")]


def test_vi_phase1_step_on_the_card_matches_the_cpu(gen):
    """One phase-1 step launches K1 once and K2 at least once on the card;
    losses and the updated moments agree with the CPU's plain versions
    (recon 1e-3, the GP term and net 1e-2, as chip_smoke.py holds them)."""
    card, cpu = vi_trainers(gen)
    eps = torch.randn(card.state.mu.shape, generator=torch.Generator().manual_seed(2))
    b1, b2 = k1.b_chain.launches, k2.cholesky_inverse.launches
    got = card.train_step(eps=eps).cpu()
    torch.cuda.synchronize()
    assert k1.b_chain.launches - b1 == 1 and k2.cholesky_inverse.launches - b2 >= 1
    want = cpu.train_step(eps=eps)
    rel = ((got - want).abs() / want.abs()).tolist()
    assert rel[1] <= 1e-3 and rel[0] <= 1e-2 and rel[3] <= 1e-2, rel
    for a, b in ((card.state.mu, cpu.state.mu), (card.state.log_var, cpu.state.log_var)):
        assert float((a.detach().cpu() - b.detach()).abs().max() / b.detach().abs().max()) <= 1e-2


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_rnn_encode_on_the_card_matches_the_cpu(gen, cell, monkeypatch):
    """cuDNN's recurrence with TF32 off against the CPU's, f32, at the
    config file's widths (hidden 64, 1296 pixels, T = 20): the encoding
    within 1e-4 and every gradient within 1e-3 of its largest entry."""
    import copy

    from lvae_torch.models.vae import make_vae

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    cpu = make_vae("rnn", 32, 1296, T=20, hidden_dim=64, type_rnn=cell,
                   generator=torch.Generator().manual_seed(0))
    card = copy.deepcopy(cpu).cuda()
    x = torch.rand(5 * 20, 1296, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want, got = cpu.encode(x), card.encode(x.cuda())
    for g, w in zip(got, want):
        assert float((g.cpu() - w).abs().max() / w.abs().max()) <= 1e-4
    # the gradient in eval mode (the trainers' mode without dropout): cuDNN
    # differentiates only a training-mode forward, which encode() selects
    for model, inp in ((cpu, x), (card, x.cuda())):
        model.eval()
        mu, lv = model.encode(inp)
        (mu.square().sum() + lv.sum()).backward()
    for (name, a), b in zip(card.named_parameters(), cpu.parameters()):
        assert (a.grad is None) == (b.grad is None), name
        if b.grad is None:  # the decoder
            continue
        scale = float(b.grad.abs().max())
        assert float((a.grad.cpu() - b.grad).abs().max()) <= 1e-3 * max(scale, 1e-30), name
