"""Kernel K5's plain version and the fused flat Adam optimizer
(lvae_torch.kernels_cuda.adam) against lvae_tpu and torch.optim.Adam, on
the CPU.

On the CPU ``fused_adam_update`` runs the plain version; the CUDA kernel is
held against it on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``). Tolerances: ``FusedAdam`` against the JAX package's
``fused_adam`` (its plain path off the TPU) over 8 steps at 1e-12 in float64
and 2e-6 in float32, the JAX package's own tolerance against optax; the
plain version against ``_adam_pallas`` in interpret mode at 1e-6 relative
per step (f32; both round the same products, but a fused multiply-add may
round once less); against ``torch.optim.Adam``, whose bias correction is
``√v/√bc2`` rather than optax's ``√(v·c2)``, at 1e-12 in float64 and 1e-5
relative to the largest update in float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lvae_tpu.kernels_pallas.adam import _adam_pallas, _padded_len, fused_adam
from lvae_torch.kernels_cuda import adam as tad
from lvae_torch.train import state as tst

SIZES = ((64, 3), (7,), (1,), (30, 20))


def tree_and_grads(seed, dtype, steps, sizes=SIZES):
    rng = np.random.default_rng(seed)
    params = {f"w{i}": rng.normal(size=s).astype(dtype) for i, s in enumerate(sizes)}
    grads = [{k: rng.normal(size=v.shape).astype(dtype) for k, v in params.items()}
             for _ in range(steps)]
    return params, grads


def torch_run(opt_cls, params, grads, lr, **kw):
    """Parameters (in the tree's sorted-key order) after the steps, and the
    optimizer."""
    ps = [torch.tensor(params[k], requires_grad=True) for k in sorted(params)]
    opt = opt_cls(ps, lr=lr, **kw)
    for g in grads:
        for p, k in zip(ps, sorted(params)):
            p.grad = torch.tensor(g[k])
        opt.step()
    return ps, opt


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12), (np.float32, 2e-6)],
                         ids=["f64", "f32"])
def test_fused_adam_matches_jax_fused_adam(dtype, tol):
    params, grads = tree_and_grads(0, dtype, 8)
    lr = 3e-3
    opt = fused_adam(lr)
    jp = jax.tree.map(jnp.asarray, params)
    state = opt.init(jp)
    for g in grads:
        updates, state = opt.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, updates)
    ps, topt = torch_run(tad.FusedAdam, params, grads, lr)
    for p, k in zip(ps, sorted(params)):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=tol, atol=tol)
    # moments: both flat in the same leaf order (sorted keys)
    np.testing.assert_allclose(topt.mu.numpy(), np.asarray(state.mu), rtol=tol, atol=tol)
    np.testing.assert_allclose(topt.nu.numpy(), np.asarray(state.nu), rtol=tol, atol=tol)
    assert topt.count == int(state.count) == 8


def test_plain_version_matches_pallas_interpret():
    """adam_reference against the Pallas body in interpret mode, on the
    padded flat layout the TPU kernel takes (two grid blocks), 4 steps."""
    n = 70_000
    npad = _padded_len(n)
    assert npad > 512 * 128
    rng = np.random.default_rng(1)
    b1, b2, lr, eps = 0.9, 0.999, 1e-2, 1e-8
    m = np.zeros(npad, np.float32)
    v = np.zeros(npad, np.float32)
    tm, tv = torch.tensor(m), torch.tensor(v)
    for step in range(1, 5):
        g = np.zeros(npad, np.float32)
        g[:n] = rng.normal(size=n)
        c1, c2 = tad.bias_corrections(step, b1, b2)
        c = jnp.asarray([[c1, c2]], jnp.float32)
        m, v, d = _adam_pallas(jnp.asarray(m), jnp.asarray(v), jnp.asarray(g), c,
                               b1=b1, b2=b2, lr=lr, eps=eps, interpret=True)
        td = tad.fused_adam_update(tm, tv, torch.tensor(g), b1=b1, b2=b2, lr=lr, eps=eps,
                                   c1=float(np.float32(c1)), c2=float(np.float32(c2)))
        for got, want in ((tm, m), (tv, v), (td, d)):
            want = np.asarray(want)
            assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()
        m, v = np.asarray(m), np.asarray(v)


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
def test_fused_adam_matches_torch_adam(dtype):
    params, grads = tree_and_grads(2, dtype, 5)
    lr = 1e-2
    ours, _ = torch_run(tad.FusedAdam, params, grads, lr)
    theirs, _ = torch_run(torch.optim.Adam, params, grads, lr, betas=(0.9, 0.999), eps=1e-8)
    for a, b, k in zip(ours, theirs, sorted(params)):
        moved = np.abs(b.detach().numpy() - params[k]).max()
        err = np.abs(a.detach().numpy() - b.detach().numpy()).max()
        assert err <= (1e-12 if dtype == np.float64 else 1e-5) * moved, (k, err, moved)


def test_fused_adam_passes_none_gradients_through():
    """A parameter without a gradient keeps its value and its moments; the
    others take the same step as without it."""
    params, grads = tree_and_grads(3, np.float64, 3, sizes=((5,), (4,), (6,)))
    ps = [torch.tensor(params[k], requires_grad=True) for k in sorted(params)]
    opt = tad.FusedAdam(ps, lr=1e-2)
    for g in grads[:2]:
        for p, k in zip(ps, sorted(params)):
            p.grad = torch.tensor(g[k])
        opt.step()
    frozen = ps[1].detach().clone()
    mu, nu = opt.mu[5:9].clone(), opt.nu[5:9].clone()
    ps[1].grad = None
    ps[0].grad, ps[2].grad = torch.tensor(grads[2]["w0"]), torch.tensor(grads[2]["w2"])
    opt.step()
    torch.testing.assert_close(ps[1].detach(), frozen, rtol=0, atol=0)
    torch.testing.assert_close(opt.mu[5:9], mu, rtol=0, atol=0)
    torch.testing.assert_close(opt.nu[5:9], nu, rtol=0, atol=0)
    ref, _ = torch_run(tad.FusedAdam, params, grads, 1e-2)
    torch.testing.assert_close(ps[0].detach(), ref[0].detach(), rtol=1e-12, atol=0)


def test_fused_adam_state_dict_round_trip():
    params, grads = tree_and_grads(4, np.float64, 2)
    ps, opt = torch_run(tad.FusedAdam, params, grads, 1e-2)
    other = tad.FusedAdam([p.detach().clone().requires_grad_(True) for p in ps], lr=1e-2)
    other.load_state_dict(opt.state_dict())
    assert other.count == 2
    torch.testing.assert_close(other.mu, opt.mu, rtol=0, atol=0)
    torch.testing.assert_close(other.nu, opt.nu, rtol=0, atol=0)


def test_make_optimizer_kinds_and_lvae_opt(monkeypatch):
    """kind=None means $LVAE_OPT, else "adam", as in the JAX package;
    "flatten" is the same Adam; "fused" is FusedAdam."""
    params = [torch.zeros(3, requires_grad=True), torch.ones(2, 2, requires_grad=True)]
    monkeypatch.delenv("LVAE_OPT", raising=False)
    assert type(tst.make_optimizer(params)) is torch.optim.Adam
    monkeypatch.setenv("LVAE_OPT", "fused")
    opt = tst.make_optimizer(params, 1e-3)
    assert isinstance(opt, tad.FusedAdam) and opt.mu.numel() == 7
    assert type(tst.make_optimizer(params, kind="adam")) is torch.optim.Adam
    assert type(tst.make_optimizer(params, kind="flatten")) is torch.optim.Adam
    with pytest.raises(ValueError):
        tst.make_optimizer(params, kind="sgd")


def test_cpu_update_launches_nothing():
    m, v, g = torch.zeros(10), torch.zeros(10), torch.ones(10)
    before = tad.fused_adam_update.launches
    d = tad.fused_adam_update(m, v, g, b1=0.9, b2=0.999, lr=0.1, eps=1e-8, c1=10.0,
                              c2=1000.0)
    assert tad.fused_adam_update.launches == before
    torch.testing.assert_close(d, torch.full((10,), -0.1), rtol=1e-6, atol=0)
