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
are held against the CPU. The sharded Hensman trainer runs on 2 gloo ranks
sharing the card (meshes (1, 2) and (2, 1), f32, 2 epochs of injected
batches): every step launches K1 and K2 on each rank, and the losses match
one process on the card within the card-vs-CPU limits (KL and net 1e-2).
The Hensman step captured as a CUDA graph: it captures on the K1 and the
K4 route and counts each replay's launches; graph and eager steps, and a
run resumed through the state setter, give the same bits (cuDNN held to
its deterministic algorithms); K5 reading its step count from the device
gives the host-scalar launch's bits over 1,000 steps. The serving bundle's
captured programs (encode, decode, recon, the trajectory program with K2
once a replay) and the VI programs (phase 1, K1 and K2 once a replay;
phase 2) give the eager programs' bits, and assigning a VI state drops
its graphs. The launches of those replays are counted by kernel name in a
``torch.profiler`` trace, and the launch counters agree with the trace.
The Hensman step with the VAE in bf16 replays bit-equal to its eager twin
too, and the f32 and bf16 steps capture and replay bit-equal while another
thread of the process queries events. The evaluation programs (validation
in GPapprox_closed and GPapprox on the K1 and the K4 route, encode,
decode, the VAE forward, the test MSEs, the GP posterior) replay with the
eager programs' bits, read parameters updated in place, and capture again
on new storages; a dataset's arrays go to the card once. The standard
epoch program replays each mode's step (closed with K3, fused Adam's K5,
the sparse and GPPVAE steps with K1 and K2, by name in a trace and on the
counters) with the eager epochs' bits at N = 520 (a captured closed
step's gradients, through ClosedKL's closed-form backward, too, which at
``[4, 2000, 2000]`` matches float64 on the CPU), captures again after a
state is assigned, and draws fresh dropout masks each replay; the serving
bundle's basis fold (K2 inside it) and refresh replay with the eager
programs' bits, a second ``aot_compile`` captures nothing, and a predictor
on new GP storages folds through the same graph with its own values. A
background checkpoint save (``orbax_async``) snapshots on the stream: it
holds the state between the replayed epochs queued before and after it,
and a new graph captures while its writer waits and writes.
"""

import contextlib
import math
import time

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


def vi_trainers(gen, p=6, t=20, n_lat=4, m_ind=8, num_dim=30, devices=("cuda", "cpu")):
    """One VI cohort (f32, every subject t frames) and a trainer for it on
    each of ``devices``, from the same weights and GP parameters."""
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
                      cfg, ds, blocks, z, gp, device=dev) for dev in devices]


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


@pytest.mark.parametrize("shape", [(1, 2), (2, 1)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_hensman_on_two_ranks_sharing_the_card(gen, shape, tmp_path):
    import os
    import sys

    import numpy as np

    # by its file's directory: a machine may have another package named
    # ``tests``; the spawned ranks inherit this path
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch_parallel_worker as w

    rng = np.random.default_rng(1)
    orders = [rng.permutation(w.P).reshape(-1, w.S) for _ in range(2)]
    eps = rng.normal(size=(2, w.P // w.S, w.S * w.T, w.L)).astype(np.float32)
    ctx = w.launch(2, "world_card_hensman", (shape, orders, eps), str(tmp_path), device="cuda")
    one = w.hensman_steps(w.hensman_trainer(dtype=torch.float32, device="cuda"), orders, eps)
    steps = 2 * (w.P // w.S)
    for rank in w.collect(ctx, str(tmp_path)):
        assert rank["launches"][0] == steps and rank["launches"][1] == 3 * steps
        np.testing.assert_allclose(rank["epochs"], one["epochs"], rtol=1e-2)
        np.testing.assert_allclose(rank["H"], one["H"], rtol=1e-2, atol=1e-5)


# ------------------------------------------------- the captured Hensman step
def card_trainer(optimizer=None, p=5, t=4, n_lat=3, m_ind=6, s=2, compute=None):
    """A Hensman trainer on the card (f32, ConvVAE, natural gradients) over a
    small HealthMNIST-layout cohort with a ghost in the last batch; every
    call starts from the same state, H + 0.1·I (f32 factors the card's
    H⁻¹ either way). ``optimizer`` names ``make_optimizer``'s kind;
    ``compute`` the VAE's compute dtype (its parameters stay f32)."""
    import numpy as np

    from lvae_torch.data.blocks import build_subject_blocks
    from lvae_torch.data.datasets import ArrayDataset
    from lvae_torch.models.vae import make_vae
    from lvae_torch.train import hensman as th
    from lvae_torch.train.state import make_optimizer

    rng = np.random.default_rng(0)
    labels = np.asarray([[i, (i - 1.0) * (k % 2), k, k % 2, k % 2, (k // 2) % 2]
                         for k in range(p) for i in range(t)], np.float32)
    ds = ArrayDataset(data=rng.uniform(size=(p * t, 36, 36, 1)).astype(np.float32),
                      labels=labels,
                      mask=(rng.uniform(size=(p * t, 1296)) > 0.2).astype(np.float32))
    spec0, spec1 = kx.split_kernel_spec(
        id_covariate=2, cat_kernel=[2], sqexp_kernel=[0],
        cat_int_kernel=[{"cont_covariate": 0, "cat_covariate": 2},
                        {"cont_covariate": 1, "cat_covariate": 4}])
    cfg = th.HensmanConfig(spec0, spec1, latent_dim=n_lat, P_tot=p, N_tot=p * t, weight=0.15,
                           loss_function="mse", natural_gradient=True, natural_gradient_lr=0.01,
                           constrain_scales=True, eps=1e-5, dropout=False)
    trainer = th.HensmanTrainer(
        make_vae("conv", n_lat, 1296, dropout=0.0, generator=torch.Generator().manual_seed(1),
                 compute_dtype=compute),
        cfg, ds, build_subject_blocks(labels, 2), labels[rng.choice(p * t, m_ind, replace=False)],
        subjects_per_batch=s, seed=0, device="cuda")
    h = trainer.state.H_nat
    state = trainer.state._replace(H_nat=h + 0.1 * torch.eye(m_ind, device="cuda"))
    if optimizer is not None:
        state = state._replace(opt_state=make_optimizer(
            state.trainables.parameters(), 1e-3, optimizer))
    trainer.state = state
    return trainer


def trainer_arrays(trainer):
    st = trainer.state
    return [st.m_nat, st.H_nat, *(p.detach() for p in st.trainables.parameters())]


@pytest.mark.parametrize("route", ["k1", "k4"])
def test_hensman_step_captures_and_replays_on_each_route(gen, route, monkeypatch):
    """``run_epochs`` on the card captures the step (on the K1 and the K4
    route) and replays it: the counters add each step's launches per replay,
    the same as an eager step's, and flipping a route switch captures
    again."""
    monkeypatch.setattr(kx, "use_b_chain_kernel", None if route == "k1" else False)
    monkeypatch.setattr(kx, "use_block_pair_kernel", route == "k4")
    trainer = card_trainer()
    before = (k1.b_chain.launches, k2.cholesky_inverse.launches, k4.block_pair.launches)
    ms = trainer.run_epochs(2)
    steps = 2 * trainer.steps_per_epoch
    got = (k1.b_chain.launches - before[0], k2.cholesky_inverse.launches - before[1],
           k4.block_pair.launches - before[2])
    assert got == ((steps, 3 * steps, 0) if route == "k1" else (0, 4 * steps, steps))
    assert len(trainer._graphs) == 1 and all(math.isfinite(v) for m in ms for v in m)
    assert all(kept for _, kept in trainer.last_steps)
    monkeypatch.setattr(kx, "use_block_pair_kernel", route != "k4")
    trainer.run_epochs(1)
    assert len(trainer._graphs) == 2


@pytest.mark.parametrize("owner", ["hensman", "vi_phase1", "pretrain"])
def test_cudnn_switch_flip_captures_again(gen, owner, monkeypatch):
    """Each trainer keys its captured step on ``train/graph.route_key()``:
    an epoch after ``cudnn.deterministic`` flips captures a second graph
    (its warm-up picks the algorithms again), and flipping back replays
    the first one."""
    import numpy as np

    from lvae_torch.data.datasets import ArrayDataset
    from lvae_torch.models.vae import make_vae
    from lvae_torch.train.pretrain import VAEPretrainer

    if owner == "hensman":
        trainer = card_trainer()
        epoch = lambda: trainer.run_epochs(1)  # noqa: E731
    elif owner == "vi_phase1":
        (trainer,) = vi_trainers(gen, devices=("cuda",))
        epoch = lambda: trainer.fit(1, log_every=0, chunk=1)  # noqa: E731
    else:
        rng = np.random.default_rng(0)
        ds = ArrayDataset(data=rng.uniform(size=(24, 36, 36, 1)).astype(np.float32),
                          labels=np.zeros((24, 6), np.float32),
                          mask=(rng.uniform(size=(24, 1296)) > 0.2).astype(np.float32))
        model = make_vae("conv", 3, 1296, dropout=0.0, generator=torch.Generator().manual_seed(1))
        trainer = VAEPretrainer(model, ds, loss_function="nll", dropout=False, seed=0,
                                batch_size=8, device="cuda")
        epoch = lambda: trainer.run_epochs(1)  # noqa: E731
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    epoch()
    first = dict(trainer._graphs)
    assert len(first) == 1
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    epoch()
    (key,) = set(trainer._graphs) - set(first)
    assert len(trainer._graphs) == 2 and key[-3] is True
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    epoch()
    assert len(trainer._graphs) == 2 and all(trainer._graphs[k] is g for k, g in first.items())


@pytest.mark.parametrize("optimizer", ["adam", "fused"])
def test_graph_and_eager_steps_are_bit_equal(gen, optimizer, monkeypatch):
    """Three steps replayed from the captured graph and the same three steps
    of the step function run eagerly, from one state on the same draws,
    give the same bits: metrics, (m, H) and every parameter (cuDNN held to
    its deterministic algorithms: its default weight gradient adds with
    atomics, so two eager runs differ too). With the fused optimizer K5
    launches once a step inside the graph."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    graph, eager = card_trainer(optimizer), card_trainer(optimizer)
    order = [[[4, 5], [0, 3], [2, 1]]]
    k5_before = k5.fused_adam_update.launches
    graph.run_epoch(order=order[0])
    assert k5.fused_adam_update.launches - k5_before == (3 if optimizer == "fused" else 0)

    def eager_step(b, rows, eps, out):
        out.copy_(eager._step(eager.tables[b], rows, eps))
        eager._advance()

    eager._run_step = eager_step
    eager.run_epoch(order=order[0])
    assert not eager._graphs and graph._graphs
    assert graph.history == eager.history
    assert graph.last_steps == eager.last_steps
    for a, b in zip(trainer_arrays(graph), trainer_arrays(eager)):
        assert torch.equal(a, b)


def test_bf16_graph_and_eager_steps_are_bit_equal(gen, monkeypatch):
    """The Hensman step with the VAE in bf16 captures and replays as in f32
    (K1 once and K2 three times a replay), its parameters stay f32, and
    three replayed steps give the bits of the same three steps run eagerly
    (cuDNN held to its deterministic algorithms)."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    graph, eager = card_trainer(compute=torch.bfloat16), card_trainer(compute=torch.bfloat16)
    order = [[4, 5], [0, 3], [2, 1]]
    before = (k1.b_chain.launches, k2.cholesky_inverse.launches)
    graph.run_epoch(order=order)
    assert (k1.b_chain.launches - before[0], k2.cholesky_inverse.launches - before[1]) == (3, 9)

    def eager_step(b, rows, eps, out):
        out.copy_(eager._step(eager.tables[b], rows, eps))
        eager._advance()

    eager._run_step = eager_step
    eager.run_epoch(order=order)
    assert len(graph._graphs) == 1 and not eager._graphs
    assert graph.model.compute_dtype == torch.bfloat16
    assert graph.history == eager.history and all(math.isfinite(v) for v in graph.history[0])
    for a, b in zip(trainer_arrays(graph), trainer_arrays(eager)):
        assert a.dtype == torch.float32 and torch.equal(a, b)


def test_capture_holds_while_another_thread_queries_events(gen, monkeypatch):
    """The Hensman step captures while another thread of the process
    queries events without pause (as a process group's watchdog does):
    only the capturing thread is held to the capture's rules, and the
    replayed steps give the eager steps' bits (cuDNN deterministic)."""
    import threading

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    stop, queries = threading.Event(), [0]

    def poll():
        stream = torch.cuda.Stream()
        while not stop.is_set():
            ev = torch.cuda.Event()
            ev.record(stream)
            ev.query()
            queries[0] += 1

    poller = threading.Thread(target=poll, daemon=True)
    poller.start()
    try:
        graphs = [card_trainer(compute=c) for c in (None, torch.bfloat16)]
        for trainer in graphs:
            trainer.run_epoch(order=[[4, 5], [0, 3], [2, 1]])
    finally:
        stop.set()
        poller.join()
    assert queries[0] > 0 and all(len(g._graphs) == 1 for g in graphs)
    for graph, compute in zip(graphs, (None, torch.bfloat16)):
        eager = card_trainer(compute=compute)

        def eager_step(b, rows, eps, out, eager=eager):
            out.copy_(eager._step(eager.tables[b], rows, eps))
            eager._advance()

        eager._run_step = eager_step
        eager.run_epoch(order=[[4, 5], [0, 3], [2, 1]])
        assert graph.history == eager.history
        for a, b in zip(trainer_arrays(graph), trainer_arrays(eager)):
            assert torch.equal(a, b)


def test_adam_kernel_count_on_the_device_matches_host_scalars(gen):
    """K5 reading the step count from device memory gives the bits of the
    launch that takes the bias corrections as host scalars, over 1,000
    steps."""
    n = 4099
    m_a, v_a = torch.zeros(n, device="cuda"), torch.zeros(n, device="cuda")
    m_b, v_b = m_a.clone(), v_a.clone()
    count = torch.zeros((), dtype=torch.int64, device="cuda")
    kw = dict(b1=0.9, b2=0.999, lr=1e-3, eps=1e-8)
    for step in range(1, 1001):
        g = torch.randn(n, generator=gen, device="cuda")
        c1, c2 = k5.bias_corrections(step, 0.9, 0.999)
        d_a = k5.fused_adam_update(m_a, v_a, g, c1=c1, c2=c2, **kw)
        count.add_(1)
        d_b = k5.fused_adam_update(m_b, v_b, g, count=count, **kw)
        assert torch.equal(m_a, m_b) and torch.equal(v_a, v_b) and torch.equal(d_a, d_b), step


def test_state_assignment_drops_the_graphs(gen, tmp_path, monkeypatch):
    """A state assigned after a chunk (here a checkpoint loaded into a new
    trainer) trains on: the next chunk captures again, and its epoch is
    bit-equal to the run that went straight through (cuDNN deterministic)."""
    from lvae_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    straight = card_trainer()
    straight.run_epochs(2)
    first = card_trainer()
    first.run_epochs(1)
    path = save_checkpoint(str(tmp_path / "s.ckpt"), first.state)
    resumed = card_trainer()
    resumed.run_epochs(1)  # a graph on the old state
    resumed.state = load_checkpoint(path, like=resumed.state)
    assert not resumed._graphs
    resumed.run_epochs(1)
    assert resumed.history[-1] == straight.history[-1]
    for a, b in zip(trainer_arrays(resumed), trainer_arrays(straight)):
        assert torch.equal(a, b)


# ----------------------------------------------- background checkpoint saves
def held_payload(trainer):
    """Device copies, queued on the current stream, of what a checkpoint of
    the trainer's state holds on the card: the VAE, GP, m_nat, H_nat."""
    st = trainer.state
    gp = st.trainables.gp
    return {"vae": {k: v.clone() for k, v in st.trainables.vae.state_dict().items()},
            "gp": [t.detach().clone() for t in (gp.kp0.raw_scale, gp.kp0.raw_lengthscale,
                                                gp.kp1.raw_scale, gp.kp1.raw_lengthscale,
                                                gp.raw_noise)],
            "m_nat": st.m_nat.clone(), "H_nat": st.H_nat.clone()}


def assert_snapshot(got, want):
    gp = [got["gp"][k] for k in ("kp0.raw_scale", "kp0.raw_lengthscale", "kp1.raw_scale",
                                 "kp1.raw_lengthscale", "raw_noise")]
    for g, w in [(got["m_nat"], want["m_nat"]), (got["H_nat"], want["H_nat"]),
                 *zip(gp, want["gp"]), *((got["vae"][k], v) for k, v in want["vae"].items())]:
        assert torch.equal(g, w.cpu())


def test_background_save_holds_against_the_replays_that_follow(gen, tmp_path, monkeypatch):
    """A background save enqueued behind a replayed epoch still in flight
    and followed at once by another (each replay updates the state in
    place) writes the state between the two: bit-equal to device copies
    taken there, though the state has moved on."""
    from lvae_torch.utils import checkpoint as ck

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    trainer = card_trainer()
    trainer.run_epochs(1)  # captures
    second = trainer._dispatch_epochs(1)  # not waited for
    want = held_payload(trainer)
    step = trainer.state.step
    ck.save_checkpoint_async(str(tmp_path / "snap"), trainer.state, {"epoch": 2})
    third = trainer._dispatch_epochs(1)  # queued behind the snapshot's copies
    ck.wait_for_async_saves()
    trainer._materialize_metrics(second, 1)
    trainer._materialize_metrics(third, 1)
    got = ck.read_checkpoint(str(tmp_path / "snap"))
    assert got["step"] == step and got["metadata"] == {"epoch": 2}
    assert_snapshot(got, want)
    assert not torch.equal(got["H_nat"], trainer.state.H_nat.cpu())


def test_capture_holds_while_a_background_save_is_in_flight(gen, tmp_path, monkeypatch):
    """A background save waits on its event and writes while the trainer,
    given a new state (a checkpoint restored into the live tensors, queued
    behind the snapshot's copies), captures a new graph: the capture
    succeeds, the replayed epoch is finite and the snapshot holds the state
    before the restore."""
    from lvae_torch.utils import checkpoint as ck

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    real, writing = ck._write_dir, []

    def slow(*args):
        writing.append(True)
        time.sleep(0.5)  # still writing while the capture runs
        real(*args)

    monkeypatch.setattr(ck, "_write_dir", slow)
    trainer = card_trainer()
    trainer.run_epochs(1)
    first = ck.save_checkpoint(str(tmp_path / "first.ckpt"), trainer.state)
    trainer.run_epochs(1)
    want = held_payload(trainer)
    torch.cuda._sleep(int(2e8))  # device work ahead of the copies: the writer waits
    ck.save_checkpoint_async(str(tmp_path / "snap"), trainer.state)
    trainer.state = ck.load_checkpoint(first, like=trainer.state)
    assert not trainer._graphs
    ms = trainer.run_epochs(1)
    assert len(trainer._graphs) == 1 and all(math.isfinite(v) for m in ms for v in m)
    ck.wait_for_async_saves()
    assert writing
    assert_snapshot(ck.read_checkpoint(str(tmp_path / "snap")), want)


# ------------------------------------------- captured serving and VI programs
def card_predictor(p=6, t=5, n_lat=4, m_ind=8):
    """A ConvVAE predictor on the card (f32, random weights and frames) over
    a basis of ``p`` subjects × ``t`` frames, and one request of 2 new
    subjects (3 observed frames, 2 queries each)."""
    import numpy as np

    from lvae_torch.evaluation.encode import encode_dataset
    from lvae_torch.inference import LVAEPredictor
    from lvae_torch.models.vae import make_vae
    from lvae_torch.train.state import init_gp_params

    rng = np.random.default_rng(0)

    def cohort(ids):
        labels = np.asarray([[i, (i - 2.0) * (s % 2), s, s % 2, s % 2, (s // 2) % 2]
                             for s in ids for i in range(t)], np.float32)
        return rng.uniform(size=(len(labels), 36, 36, 1)).astype(np.float32), labels

    frames, labels = cohort(range(p))
    spec0, spec1 = kx.split_kernel_spec(
        id_covariate=2, cat_kernel=[2], sqexp_kernel=[0],
        cat_int_kernel=[{"cont_covariate": 0, "cat_covariate": 2}])
    model = make_vae("conv", n_lat, 1296, dropout=0.0, generator=torch.Generator().manual_seed(1))
    mu, _ = encode_dataset(model, frames, device="cuda")
    pred = LVAEPredictor(model=model, gp_params=init_gp_params(spec0, spec1, n_lat),
                         noise=torch.ones(n_lat), spec0=spec0, spec1=spec1,
                         z=labels[rng.choice(len(labels), m_ind, replace=False)],
                         id_covariate=2, basis_labels=labels, basis_mu=mu, device="cuda")
    new_f, new_l = cohort(range(100, 102))
    req = (new_f.reshape(2, t, 36, 36, 1)[:, :3], new_l.reshape(2, t, -1)[:, :3],
           new_l.reshape(2, t, -1)[:, 3:])
    return pred, frames, req, cohort(range(200, 202))


def traced_launches(fn):
    """K1's and K2's launches in one call of ``fn``: counted by kernel name
    (``b_chain_*``, ``chol_inv_*``) in a ``torch.profiler`` trace of the
    card, and by the launch counters."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    before = (k1.b_chain.launches, k2.cholesky_inverse.launches)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    traced = tuple(sum(e.count for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA and f"{name}_" in e.key)
                   for name in ("b_chain", "chol_inv"))
    return traced, (k1.b_chain.launches - before[0], k2.cholesky_inverse.launches - before[1])


def serve_all(bundle, sib, frames, req, refresh):
    """Every answer of a bundle and its K=1 sibling, before and after a
    refresh of the parent."""
    one = tuple(x[:1] for x in req)
    out = [bundle.encode(frames[:11]), bundle.impute(frames[:11]),
           bundle.predict_trajectories(*req), sib.predict_trajectories(*one)]
    out.append(bundle.decode(out[0]))
    bundle.refresh_basis(*refresh)
    out += [bundle.predict_trajectories(*req), sib.predict_trajectories(*one)]
    return out


def test_replayed_serving_programs_are_bit_equal_to_eager(gen, monkeypatch):
    """Each request replays a graph captured at construction (the
    trajectory program launches K2 once a replay: 3 replayed requests show
    3 in the trace, and the counters agree) and gives the eager programs'
    bits (cuDNN deterministic); a sibling's answer is unchanged by its
    parent's refresh."""
    import numpy as np

    from lvae_torch.train.graph import eager_steps

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    pred, frames, req, refresh = card_predictor()
    answers = []
    for eager in (False, True):
        bundle = pred.aot_compile(batch_size=8, t_obs=3, n_query=2, k_subjects=2)
        sib = bundle.for_k_subjects(1)
        assert sorted(bundle._graphs) == ["decode", "encode", "recon", "trajectory"]
        assert sib._graphs["encode"] is bundle._graphs["encode"]
        assert sib._graphs["trajectory"] is not bundle._graphs["trajectory"]
        with eager_steps() if eager else contextlib.nullcontext():
            if not eager:
                def requests():
                    for _ in range(3):
                        bundle.predict_trajectories(*req)

                assert traced_launches(requests) == ((0, 3), (0, 3))
                assert traced_launches(lambda: bundle.impute(frames[:11])) == ((0, 0), (0, 0))
            answers.append(serve_all(bundle, sib, frames, req, refresh))
    replayed, eager = answers
    for a, b in zip(replayed, eager):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(replayed[3], replayed[6])  # the sibling after the refresh
    assert not np.array_equal(replayed[2], replayed[5])  # the parent's answer moved


def vi_card_pair(gen):
    """Two VI trainers on the card from one state; every call of the second
    (``run``) steps eagerly, in both phases."""
    from lvae_torch.train.graph import eager_steps

    graph, eager = (vi_trainers(gen, devices=("cuda",))[0] for _ in range(2))

    def run(method, *args, **kwargs):
        with eager_steps():
            return getattr(eager, method)(*args, **kwargs)

    return graph, eager, run


def vi_arrays(trainer):
    st = trainer.state
    return [p.detach() for p in st.opt_state.param_groups[0]["params"]]


def test_vi_replayed_chunk_is_bit_equal_to_eager(gen):
    """Phase 1's replayed steps (K1 and K2 once a step: the capture's
    warm-up step and 2 replays show 3 of each in the trace, and the counters
    agree) and phase 2's (K1 and K2 once, in the operators' build) give the
    eager steps' bits from one state on the same draws."""
    import numpy as np

    from lvae_torch.data.datasets import ArrayDataset

    graph, eager, eager_run = vi_card_pair(gen)
    got = traced_launches(lambda: graph.fit(3, log_every=0, chunk=3))
    assert got == ((3, 3), (3, 3))
    (captured,) = graph._graphs.values()
    assert captured.launches[:2] == (1, 1)
    eager_run("fit", 3, log_every=0, chunk=3)
    assert not eager._graphs
    assert graph.history == eager.history
    for a, b in zip(vi_arrays(graph), vi_arrays(eager)):
        assert torch.equal(a, b)
    rng = np.random.default_rng(3)
    labels = np.asarray([[i, 0.0, 50 + s, s % 2, 0, 1] for s in range(2) for i in range(20)],
                        np.float32)
    pred_ds = ArrayDataset(data=rng.uniform(size=(40, 30)).astype(np.float32), labels=labels,
                           mask=np.ones((40, 30), np.float32))
    kw = dict(epochs=7, log_every=0, chunk=3)
    got = []
    launches = traced_launches(lambda: got.append(graph.optimize_prediction_set(pred_ds, **kw)))
    assert launches == ((1, 1), (1, 1))
    got.append(eager_run("optimize_prediction_set", pred_ds, **kw))
    assert graph.pred_history == eager.pred_history and len(graph.pred_history) == 7
    for a, b in zip(*got):
        np.testing.assert_array_equal(a, b)


def test_vi_state_assignment_drops_the_graphs(gen):
    """A state assigned after a chunk drops phase 1's graph; the next chunk
    captures again on it and steps as the trainer that went on eagerly."""
    graph, eager, eager_run = vi_card_pair(gen)
    graph.fit(2, log_every=0, chunk=1)
    eager_run("fit", 2, log_every=0, chunk=1)
    assert len(graph._graphs) == 1
    graph.state = graph.state
    assert not graph._graphs
    graph.fit(2, log_every=0, chunk=1)
    eager_run("fit", 2, log_every=0, chunk=1)
    assert len(graph._graphs) == 1 and graph.history == eager.history
    for a, b in zip(vi_arrays(graph), vi_arrays(eager)):
        assert torch.equal(a, b)


# ------------------------------------------------ captured evaluation programs
def card_eval_world(n_lat=4, m_ind=8):
    """A ConvVAE on the card (f32, random weights), GP parameters, inducing
    points and three cohorts: a ragged validation cohort of 3 subjects, a
    test cohort of 2 and a prediction cohort of 4 (5 frames a subject)."""
    import numpy as np

    from lvae_torch.data.datasets import ArrayDataset
    from lvae_torch.models.vae import make_vae
    from lvae_torch.train.state import init_gp_params

    rng = np.random.default_rng(0)

    def cohort(ids, ragged=False):
        labels = np.asarray([[i, (i - 2.0) * (s % 2), s, s % 2, s % 2, (s // 2) % 2]
                             for s in ids for i in range(5 - (s % 2 if ragged else 0))],
                            np.float32)
        n = len(labels)
        return ArrayDataset(data=rng.uniform(size=(n, 36, 36, 1)).astype(np.float32),
                            labels=labels,
                            mask=(rng.uniform(size=(n, 1296)) > 0.2).astype(np.float32))

    spec0, spec1 = kx.split_kernel_spec(
        id_covariate=2, cat_kernel=[2], sqexp_kernel=[0],
        cat_int_kernel=[{"cont_covariate": 0, "cat_covariate": 2}])
    model = make_vae("conv", n_lat, 1296, dropout=0.0,
                     generator=torch.Generator().manual_seed(1)).cuda()
    pred = cohort(range(4))
    return dict(model=model, gp=init_gp_params(spec0, spec1, n_lat).to(device="cuda"),
                noise=torch.ones(n_lat, device="cuda"), specs=(spec0, spec1),
                z=torch.as_tensor(pred.labels[rng.choice(len(pred.labels), m_ind, replace=False)],
                                  device="cuda"),
                valid=cohort(range(10, 13), ragged=True), test=cohort([0, 1]), pred=pred,
                pred_mu=rng.normal(size=(len(pred.labels), n_lat)).astype(np.float32))


def evaluate_all(w, type_kl="GPapprox_closed"):
    """Every evaluation program's answer on ``w``, as host arrays."""
    import numpy as np

    from lvae_torch.evaluation import encode as enc
    from lvae_torch.evaluation import testing
    from lvae_torch.evaluation.validate import validate
    from lvae_torch.ops.predict import predict_latents

    model, (spec0, spec1) = w["model"], w["specs"]
    val = validate(model, w["gp"], w["noise"], spec0, spec1, w["valid"], w["z"], 2, 0.15,
                   type_kl=type_kl, num_samples=3, verbose=False)
    mu, lv = enc.encode_dataset(model, w["valid"].data, batch_size=4)
    frames = enc.decode_latents(model, mu, batch_size=4)
    recon, fmu, flv = enc.vae_forward(model, torch.as_tensor(w["test"].data, device="cuda"))
    zp = predict_latents(spec0, spec1, w["gp"].kp0, w["gp"].kp1, w["noise"], w["pred"].labels,
                         w["pred_mu"], w["test"].labels, w["z"], 2)
    gp_test = testing.mse_test_gp_approx(model, w["gp"], w["noise"], spec0, spec1, w["test"],
                                         w["pred"].labels, w["pred_mu"], w["z"], 2,
                                         verbose=False)
    spec_full, kp_full = kx.join_specs(spec0, spec1, w["gp"].kp0, w["gp"].kp1)
    exact = testing.mse_test_exact(model, kp_full, spec_full, w["noise"], w["test"],
                                   w["pred"].labels, w["pred_mu"], verbose=False)
    return [np.asarray(val), mu, lv, frames, *(t.cpu().numpy() for t in (recon, fmu, flv)), zp,
            np.asarray(gp_test), np.asarray(exact)]


@pytest.mark.parametrize("route", ["k1", "k4"])
def test_evaluation_programs_replay_bit_equal_to_eager(gen, route, monkeypatch):
    """The second call of each evaluation program replays the graph its
    first call captured (a replayed validation launches K1 and K2 once, on
    the K4 route K4 once and K2 twice, as the trace shows and the counters
    say) and gives the bits of the programs run eagerly (cuDNN
    deterministic), in GPapprox_closed and GPapprox with 3 samples."""
    import numpy as np

    from lvae_torch.evaluation import programs
    from lvae_torch.evaluation.validate import validate
    from lvae_torch.train.graph import eager_steps

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(kx, "use_b_chain_kernel", None if route == "k1" else False)
    monkeypatch.setattr(kx, "use_block_pair_kernel", route == "k4")
    w = card_eval_world()
    dev = torch.device("cuda", 0)

    def keys():
        return set(programs.graphs_of(w["model"], dev)) | set(programs.graphs_of(None, dev))

    for type_kl in ("GPapprox_closed", "GPapprox"):
        evaluate_all(w, type_kl)  # the captures
        captured = keys()
        replayed = evaluate_all(w, type_kl)
        assert keys() == captured  # replays only
        with eager_steps():
            eager = evaluate_all(w, type_kl)
        for a, b in zip(replayed, eager):
            np.testing.assert_array_equal(a, b)
    names = {k[0] for k in programs.graphs_of(w["model"], dev)}
    assert names == {"validate", "encode", "decode", "vae_forward", "recon_mse"}
    assert any(k[0] == "gp_predict" for k in programs.graphs_of(None, dev))

    def validation():  # a replay: the key of evaluate_all's GPapprox_closed validation
        validate(w["model"], w["gp"], w["noise"], *w["specs"], w["valid"], w["z"], 2, 0.15,
                 num_samples=3, verbose=False)

    block_pair_before = k4.block_pair.launches
    traced = traced_launches(validation)
    k4_launches = k4.block_pair.launches - block_pair_before
    want = (1, 1) if route == "k1" else (0, 2)
    assert traced == (want, want) and k4_launches == (route == "k4")


def test_evaluation_replay_reads_parameters_updated_in_place(gen, monkeypatch):
    """An update in place (an optimizer step) is read by the next replay:
    it equals the eager programs on the updated model."""
    import numpy as np

    from lvae_torch.train.graph import eager_steps

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    w = card_eval_world()
    before = evaluate_all(w)
    with torch.no_grad():
        for p in w["model"].parameters():
            p.mul_(1.01)
    replayed = evaluate_all(w)
    with eager_steps():
        eager = evaluate_all(w)
    for a, b in zip(replayed, eager):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(before[0], replayed[0])


def test_evaluation_programs_capture_again_on_new_storages(gen, monkeypatch):
    """After ``load_state_dict(..., assign=True)`` (new storages, the old
    ones freed and overwritten) each program captures again, its old graph
    dropped, and gives the eager programs' bits on the new weights."""
    import numpy as np

    from lvae_torch.evaluation import programs
    from lvae_torch.train.graph import eager_steps

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    w = card_eval_world()
    evaluate_all(w)
    graphs = programs.graphs_of(w["model"], torch.device("cuda", 0))
    old = set(graphs)
    w["model"].load_state_dict({k: v.clone() * 1.01 for k, v in w["model"].state_dict().items()},
                               assign=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    junk = torch.full((1 << 26,), float("nan"), device="cuda")  # over the freed storages
    replayed = evaluate_all(w)
    del junk
    assert not (set(graphs) & old) and len(graphs) == len(old)
    with eager_steps():
        eager = evaluate_all(w)
    for a, b in zip(replayed, eager):
        np.testing.assert_array_equal(a, b)
    assert all(np.isfinite(a).all() for a in replayed)


def test_dataset_arrays_move_to_the_card_once(gen):
    """A dataset's arrays and blocks go to the card once per array object."""
    from lvae_torch.evaluation import programs

    w = card_eval_world()
    dev = torch.device("cuda", 0)
    ds = w["valid"]
    a = programs.dataset_tensor(ds.data, torch.float32, dev)
    assert programs.dataset_tensor(ds.data, torch.float32, dev) is a
    assert programs.dataset_tensor(ds.data.copy(), torch.float32, dev) is not a
    blocks = programs.dataset_blocks(ds.labels, 2, torch.float32, dev)
    assert programs.dataset_blocks(ds.labels, 2, torch.float32, dev) is blocks
    assert blocks[1].shape == (3, 5) and int(blocks[1].sum()) == len(ds.labels)


def test_capture_holds_while_the_collector_frees_a_graph(gen):
    """A captured graph that becomes a dead reference cycle once the next
    capture has begun, which the collector (threshold 1) would free at the
    step's next allocations: a graph freed inside a capture breaks it
    (``tools/torch_capture_gc.py``); ``CapturedStep`` turns the collector
    off during its capture, captures and replays right, and the cycle goes
    at the next collection."""
    import gc
    import weakref

    from lvae_torch.train import graph

    x = torch.randn(1 << 16, device="cuda", generator=gen)
    holder = [graph.CapturedStep(lambda a: a * 2, [x])]
    gone = weakref.ref(holder[0])

    def step(a):
        y = a + 1
        if holder and torch.cuda.is_current_stream_capturing():
            cycle = {"held": holder.pop()}  # a young dead cycle, the graph's only holder
            cycle["self"] = cycle
            del cycle
            _ = [[] for _ in range(64)]  # allocations: the collector's turn
        return y * 3

    prev = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        captured = graph.CapturedStep(step, [x])
    finally:
        gc.set_threshold(*prev)
    assert not holder  # the cycle became garbage inside the capture
    gc.collect()
    assert gone() is None
    x1 = x + 1
    torch.testing.assert_close(captured.replay(x1), (x1 + 1) * 3, rtol=0, atol=0)


# --------------------------------------------- captured standard epoch program
# (type_KL, pseudo_minibatch, optimizer): the launches of one step, by wrapper
STD_RUNS = {
    ("closed", False, "adam"): {"kernel_matrix": 1, "adam": 0, "b_chain": 0, "chol_inv": 0},
    ("closed", False, "fused"): {"kernel_matrix": 1, "adam": 1, "b_chain": 0, "chol_inv": 0},
    ("GPapprox", False, "adam"): {"kernel_matrix": 0, "adam": 0, "b_chain": 1},
    ("GPapprox_closed", False, "adam"): {"kernel_matrix": 0, "adam": 0, "b_chain": 1},
    ("GPapprox_closed", True, "adam"): {"kernel_matrix": 0, "adam": 0, "b_chain": 1},
}
STD_WRAPPERS = {"b_chain": (k1, "b_chain"), "chol_inv": (k2, "cholesky_inverse"),
                "kernel_matrix": (k3, "kernel_matrix_fused"), "adam": (k5, "fused_adam_update")}


def card_standard_trainer(type_kl="closed", pseudo=False, optimizer="adam", dropout=0.0,
                          p=26, t=20, n_lat=4, m_ind=8):
    """A standard trainer on the card (f32, ConvVAE, random weights and
    frames) over ``p`` subjects × ``t`` frames: N = 520, inside K3's gate.
    Every call starts from the same state."""
    import numpy as np

    from lvae_torch.data.blocks import build_subject_blocks
    from lvae_torch.data.datasets import ArrayDataset
    from lvae_torch.models.vae import make_vae
    from lvae_torch.train.standard import StandardConfig, StandardTrainer
    from lvae_torch.train.state import init_inducing_points, make_optimizer

    rng = np.random.default_rng(0)
    labels = np.asarray([[i, (i - 2.0) * (k % 2), k, k % 2, k % 2, (k // 2) % 2]
                         for k in range(p) for i in range(t)], np.float32)
    ds = ArrayDataset(data=rng.uniform(size=(p * t, 36, 36, 1)).astype(np.float32),
                      labels=labels,
                      mask=(rng.uniform(size=(p * t, 1296)) > 0.2).astype(np.float32))
    spec0, spec1 = kx.split_kernel_spec(
        id_covariate=2, cat_kernel=[2], sqexp_kernel=[0],
        cat_int_kernel=[{"cont_covariate": 0, "cat_covariate": 2}])
    cfg = StandardConfig(spec0, spec1, latent_dim=n_lat, P_tot=p, T=t, weight=0.15,
                         loss_function="mse", type_KL=type_kl, num_samples=2,
                         constrain_scales=True, eps=1e-5, dropout=dropout > 0)
    model = make_vae("conv", n_lat, 1296, dropout=dropout,
                     generator=torch.Generator().manual_seed(1))
    trainer = StandardTrainer(model, cfg, ds, build_subject_blocks(labels, 2),
                              init_inducing_points(labels, m_ind, seed=0), seed=0,
                              pseudo_minibatch=pseudo, device="cuda")
    trainer.state = trainer.state._replace(opt_state=make_optimizer(
        trainer.state.trainables.parameters(), 1e-3, optimizer))
    return trainer


def traced_by_name(fn, names):
    """The launches of the kernels ``names`` (keys of STD_WRAPPERS) in one
    call of ``fn``: by kernel name in a trace of the card, and by the
    counters."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def counts():
        return {n: getattr(*STD_WRAPPERS[n]).launches for n in names}

    before = counts()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    traced = {n: sum(e.count for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA and f"{n}_" in e.key) for n in names}
    return traced, {n: v - before[n] for n, v in counts().items()}


def std_arrays(trainer):
    return [p.detach() for p in trainer.state.trainables.parameters()]


@pytest.mark.parametrize("run", list(STD_RUNS), ids=lambda r: "-".join(map(str, r)))
def test_standard_replayed_epochs_are_bit_equal_to_eager(gen, run, monkeypatch):
    """Three epochs through the captured step (its warm-up and 2 replays)
    give the bits of the same epochs run eagerly from one state (cuDNN
    deterministic); each step launches its kernels (the closed step K3 once
    and, under the fused optimizer, K5 once; the sparse and GPPVAE steps K1
    once and K2), by name in the trace and on the counters alike."""
    from lvae_torch.train.graph import eager_steps

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    graph, eager = card_standard_trainer(*run), card_standard_trainer(*run)
    traced, counted = traced_by_name(lambda: graph.fit(3, log_every=0, chunk=3), list(STD_WRAPPERS))
    assert traced == counted and len(graph._graphs) == 1
    for name, n in STD_RUNS[run].items():
        assert traced[name] == 3 * n, (name, traced)
    assert traced["chol_inv"] >= 3 * STD_RUNS[run].get("chol_inv", 1)
    with eager_steps():
        eager.fit(3, log_every=0, chunk=3)
    assert not eager._graphs
    assert graph.history == eager.history and all(math.isfinite(v) for v in graph.history[-1])
    for a, b in zip(std_arrays(graph), std_arrays(eager)):
        assert torch.equal(a, b)


def test_closed_kl_gradients_on_the_card_match_float64(gen, monkeypatch):
    """ClosedKL at the closed cell's N, ``[4, 2000, 2000]`` in f32, against
    the same computation in float64 on the CPU: the value at 1e-5 relative,
    each gradient at max |Δ| over max |reference| ≤ 1e-4 (f32 rounding
    reads 2e-6 at condition number 1e2). TF32 is switched on around the
    call: the forward and the backward hold their products to full f32
    themselves and leave the switches as they found them."""
    n_lat, n = 4, 2000
    k = spd_stack((n_lat,), n, gen)
    mu = torch.randn(n_lat, n, generator=gen, device="cuda")
    lv = 0.3 * torch.randn(n_lat, n, generator=gen, device="cuda")
    cot = torch.randn(n_lat, generator=gen, device="cuda")

    def run(device, dtype):
        leaves = [x.to(device, dtype, copy=True).requires_grad_(True) for x in (k, mu, lv)]
        out = eb.kl_closed(*leaves)
        torch.sum(out * cot.to(device, dtype)).backward()
        return out.detach().cpu().double(), [x.grad.cpu().double() for x in leaves]

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    before = eb.ClosedKL.backward_calls
    got, got_g = run("cuda", torch.float32)
    assert eb.ClosedKL.backward_calls == before + 1
    assert torch.backends.cuda.matmul.allow_tf32
    want, want_g = run("cpu", torch.float64)
    assert float(((got - want).abs() / want.abs()).max()) <= 1e-5
    for a, b in zip(got_g, want_g):
        assert float((a - b).abs().max() / b.abs().max()) <= 1e-4


def test_captured_closed_step_gradients_equal_the_eager_step(gen, monkeypatch):
    """A closed step's gradients (ConvVAE, K3's prior, ClosedKL and their
    backward) captured as a CUDA graph give the eager step's bits on two
    noises (cuDNN deterministic). The warm-up and the capture run
    ClosedKL's backward on the host, a replay does not."""
    from lvae_torch.train.graph import CapturedStep
    from lvae_torch.train.standard import full_batch_loss
    from lvae_torch.utils.metrics import phase_end

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    trainer = card_standard_trainer("closed")
    params = list(trainer.state.trainables.parameters())

    def grads(eps):
        for p in params:
            p.grad = None
        net, _ = full_batch_loss(trainer.model, trainer.cfg, trainer.state.trainables,
                                 trainer.tdata, trainer.block_mask, eps=eps)
        net.backward()
        phase_end()
        return torch.cat([torch.zeros_like(p).reshape(-1) if p.grad is None
                          else p.grad.reshape(-1) for p in params])

    (shape, dtype), = trainer._epoch_specs()
    noises = [torch.randn(shape, dtype=dtype, generator=gen, device="cuda") for _ in range(2)]
    before = eb.ClosedKL.backward_calls
    captured = CapturedStep(grads, noises[:1])
    assert eb.ClosedKL.backward_calls == before + 2
    replayed = [captured.replay(e).clone() for e in noises]
    assert eb.ClosedKL.backward_calls == before + 2
    eager = [grads(e) for e in noises]
    assert not torch.equal(eager[0], eager[1])
    for a, b in zip(replayed, eager):
        assert torch.equal(a, b)


def test_standard_state_assignment_captures_again(gen, monkeypatch):
    """A state assigned between chunks drops the graph; the next chunk
    captures again on it and trains as the eager run straight through."""
    from lvae_torch.train.graph import eager_steps

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    graph, eager = (card_standard_trainer("GPapprox_closed") for _ in range(2))
    graph.fit(2, log_every=0, chunk=1)
    first = next(iter(graph._graphs.values()))
    graph.state = graph.state
    assert not graph._graphs
    graph.fit(2, log_every=0, chunk=1)
    assert len(graph._graphs) == 1 and next(iter(graph._graphs.values())) is not first
    with eager_steps():
        eager.fit(4, log_every=0, chunk=1)
    assert graph.history == eager.history
    for a, b in zip(std_arrays(graph), std_arrays(eager)):
        assert torch.equal(a, b)


def test_standard_replays_draw_fresh_dropout_masks(gen, monkeypatch):
    """Two replays from one state (its tensors and Adam's written back in
    place between them) on one noise: with dropout their metrics differ
    (each replay draws its masks anew), without it they are the same bits
    (cuDNN deterministic)."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    for p, differ in ((0.25, True), (0.0, False)):
        trainer = card_standard_trainer("GPapprox_closed", dropout=p)
        noise = [torch.randn(shape, dtype=dtype, generator=gen, device="cuda")
                 for shape, dtype in trainer._epoch_specs()]
        row = torch.empty(4, device="cuda")
        trainer._run_step(*noise, row)  # the capture, its warm-up this step
        opt = trainer.state.opt_state
        held = [*trainer.state.trainables.parameters(),
                *(v for s in opt.state.values() for v in s.values() if torch.is_tensor(v))]
        saved = [t.detach().clone() for t in held]
        rows = []
        for _ in range(2):
            with torch.no_grad():
                for t, s in zip(held, saved):
                    t.copy_(s)
            trainer._run_step(*noise, row)
            rows.append(row.clone())
        assert len(trainer._graphs) == 1
        assert (not torch.equal(rows[0], rows[1])) == differ, (p, rows)


def test_replayed_basis_fold_and_refresh_are_bit_equal_to_eager(gen, monkeypatch):
    """The bundle's basis fold (K2 once inside its graph) and a refresh give
    the eager programs' bits; a second ``aot_compile`` of the same shapes
    replays the fold and captures nothing; a predictor on new GP storages
    (other values) folds through the same graph and serves its own
    values."""
    import dataclasses

    import numpy as np

    from lvae_torch.evaluation import programs
    from lvae_torch.train.graph import eager_steps

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    pred, frames, req, refresh = card_predictor()
    kw = dict(batch_size=8, t_obs=3, n_query=2, k_subjects=2)

    def basis_graphs():
        return {k: g for k, g in programs.graphs_of(None, pred.z.device).items()
                if k[0] in ("fold_basis", "extend_basis")}

    def answers(p):
        bundle = p.aot_compile(**kw)
        out = [t.cpu().numpy().copy() for t in bundle._basis]
        bundle.refresh_basis(*refresh)
        out += [t.cpu().numpy().copy() for t in bundle._basis]
        return out + [bundle.predict_trajectories(*req)]

    replayed = answers(pred)
    graphs = basis_graphs()
    assert sorted(k[0] for k in graphs) == ["extend_basis", "fold_basis"]
    second = pred.aot_compile(**kw)
    assert basis_graphs() == graphs  # the same graph objects: nothing captured
    assert traced_launches(second._fold_basis) == ((0, 1), (0, 1))
    with eager_steps():
        eager = answers(pred)
    for a, b in zip(replayed, eager):
        np.testing.assert_array_equal(a, b)
    gp = pred.gp_params.to(copy=True)
    with torch.no_grad():
        for t in gp.tensors():
            t.mul_(1.1)
    other = dataclasses.replace(pred, gp_params=gp)
    got = answers(other)
    assert basis_graphs() == graphs
    with eager_steps():
        want = answers(other)
    for a, b, c in zip(got, want, replayed):
        np.testing.assert_array_equal(a, b)
        assert not np.array_equal(a, c)
