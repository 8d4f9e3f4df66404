"""The port's standard (full-batch) and GPPVAE training
(lvae_torch.train.standard) against lvae_tpu's, on the CPU in float64.

Both packages start from one state: lvae_tpu's ``StandardTrainer`` makes it
(its VAE params cast to float64) and ``utils/convert.standard_state_from_jax``
carries it to the port, the optimizer's moments included. The noise is
injected on both sides, on the JAX side by replacing
``lvae_tpu.models.vae.sample_latent`` in the test: the encoder's
reparameterisation noise ``[N, L]`` and the GPapprox bound's latent-sample
noise ``[P, T, L]`` (JAX draws its samples under ``vmap``, so every sample
gets the same injected noise). The GPPVAE replay scans over subjects, so it
is compared with z = mu (zero noise). Tolerances: a loss value and every
trainable's gradient at rtol 1e-8 (summation order only); the five-phase
gradient against the port's own full-batch gradient at 1e-10, as
``tests/test_gppvae.py`` proves it for JAX; 3-step trajectories at rtol
1e-6, where Adam's division by √v̂ + eps magnifies the 1e-12-level
differences of near-zero gradients. The cohort is P=4 subjects × T=3 frames,
SimpleVAE on 12 features, L=2, M=6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from lvae_tpu.data import blocks as jbk
from lvae_tpu.data.datasets import ArrayDataset
from lvae_tpu.models import vae as jv
from lvae_tpu.ops import kernels as jkx
from lvae_tpu.train import standard as jts
from lvae_tpu.train import state as jst
from lvae_torch.data import blocks as tbk
from lvae_torch.kernels_cuda import adam as tad
from lvae_torch.kernels_cuda import kernel_matrix as tkm
from lvae_torch.models import vae as tv
from lvae_torch.ops import elbo as teb
from lvae_torch.ops import kernels as tkx
from lvae_torch.train import standard as tts
from lvae_torch.utils.convert import standard_state_from_jax, vae_state_dict_from_jax

P, T, L, M, D = 4, 3, 2, 6, 12
SPEC = dict(cat_kernel=[2], sqexp_kernel=[0],
            cat_int_kernel=[{"cont_covariate": 0, "cat_covariate": 2}], id_covariate=2)
# mode name: (type_KL, loss_function, constrain_scales)
MODES = {
    "closed": ("closed", "mse", True),
    "gpapprox_nll": ("GPapprox", "nll", False),
    "gpapprox_closed": ("GPapprox_closed", "mse", False),
}


def cohort(seed=0, ragged=False):
    rng = np.random.default_rng(seed)
    rows = []
    for s in range(P):
        level, group = rng.normal(), int(rng.integers(0, 2))
        for i in range(T - (s % 2 if ragged else 0)):
            rows.append([i + 0.3 * rng.uniform(), level, s, group])
    labels = np.asarray(rows)
    n = labels.shape[0]
    data = rng.uniform(size=(n, D))
    mask = (rng.uniform(size=(n, D)) > 0.2).astype(np.float64)
    return ArrayDataset(data=data, labels=labels, mask=mask)


def make_pair(mode="closed", pseudo_minibatch=False, num_samples=2, opt="adam",
              monkeypatch=None):
    """(JAX trainer with a float64 state, port trainer from that state)."""
    type_kl, loss, constrain = MODES[mode]
    ds = cohort()
    cfg_args = dict(latent_dim=L, P_tot=P, T=T, weight=0.3, loss_function=loss,
                    type_KL=type_kl, num_samples=num_samples, constrain_scales=constrain,
                    eps=1e-5, dropout=False)
    jcfg = jts.StandardConfig(*jkx.split_kernel_spec(**SPEC), **cfg_args)
    tcfg = tts.StandardConfig(*tkx.split_kernel_spec(**SPEC), **cfg_args)
    z = jst.init_inducing_points(ds.labels, M, seed=0, dtype=np.float64)
    if monkeypatch is not None:
        monkeypatch.setenv("LVAE_OPT", opt)
    jtr = jts.StandardTrainer(jv.SimpleVAE(latent_dim=L, num_dim=D, dtype=jnp.float64), jcfg,
                              ds, jbk.build_subject_blocks(ds.labels, 2), z, seed=0,
                              dtype=jnp.float64, pseudo_minibatch=pseudo_minibatch)
    tr64 = jax.tree.map(lambda x: x.astype(jnp.float64), jtr.state.trainables)
    jtr.state = jtr.state._replace(trainables=tr64, opt_state=jtr.optimizer.init(tr64))
    ttr = tts.StandardTrainer(tv.make_vae("simple", L, D, dtype=torch.float64), tcfg, ds,
                              tbk.build_subject_blocks(ds.labels, 2), z, seed=0,
                              dtype=torch.float64, pseudo_minibatch=pseudo_minibatch,
                              device="cpu")
    ttr.state = standard_state_from_jax(jtr.state, ttr.model, dtype=torch.float64)
    return jtr, ttr


@pytest.fixture
def inject(monkeypatch):
    """JAX's sample_latent takes the test's noise: ``eps`` for the encoder
    ([N, L] moments), ``gp_eps`` for the GP samples ([P, T, L]); zero noise
    (z = mu) where the holder has none."""
    holder = {}

    def sample_latent(rng, mu, log_var):
        e = holder.get("eps" if mu.ndim == 2 else "gp_eps")
        e = 0.0 if e is None else jnp.asarray(e)
        return mu + e * jnp.exp(0.5 * log_var)

    monkeypatch.setattr(jv, "sample_latent", sample_latent)
    return holder


def noises(seed, num_samples=2):
    rng = np.random.default_rng(seed)
    eps = rng.normal(size=(P * T, L))
    gp = rng.normal(size=(P, T, L))
    return eps, gp, np.broadcast_to(gp, (num_samples, P, T, L)).copy()


def trainable_arrays(jtrainables, ttrainables):
    """Matching (name, JAX numpy, port numpy) triples of every trainable."""
    jsd = vae_state_dict_from_jax(jtrainables.vae, np.float64)
    out = [(n, jsd[n].numpy(), p.detach().numpy())
           for n, p in ttrainables.vae.named_parameters()]
    jgp = [*jtrainables.gp.kp0, *jtrainables.gp.kp1, jtrainables.gp.raw_noise]
    out += [(f"gp{i}", np.asarray(a), b.detach().numpy())
            for i, (a, b) in enumerate(zip(jgp, ttrainables.gp.tensors()))]
    return out


def port_grads(trainables):
    out = {n: p.grad for n, p in trainables.vae.named_parameters()}
    out.update({f"gp{i}": x.grad for i, x in enumerate(trainables.gp.tensors())})
    return out


def assert_grads_match(jgrads, trainables, rtol):
    got = port_grads(trainables)
    for name, want, _ in trainable_arrays(jgrads, trainables):
        g = np.zeros_like(want) if got[name] is None else got[name].numpy()
        np.testing.assert_allclose(g, want, rtol=rtol, atol=1e-13 * max(np.abs(want).max(), 1),
                                   err_msg=name)


def clear_grads(trainables):
    for p in trainables.parameters():
        p.grad = None


@pytest.mark.parametrize("mode", sorted(MODES))
def test_full_batch_loss_value_and_grads_match_jax(mode, inject):
    jtr, ttr = make_pair(mode)
    eps, gp, gp_eps = noises(1)
    inject.update(eps=eps, gp_eps=gp)
    (_, jm), jgrads = jax.value_and_grad(
        lambda tr: jts.full_batch_loss(jtr.model, jtr.cfg, tr, jtr.tdata, jtr.block_mask,
                                       jax.random.key(0)),
        has_aux=True,
    )(jtr.state.trainables)
    st = ttr.state
    clear_grads(st.trainables)
    net, tm = tts.full_batch_loss(ttr.model, ttr.cfg, st.trainables, ttr.tdata,
                                  ttr.block_mask, eps=torch.tensor(eps),
                                  gp_eps=torch.tensor(gp_eps))
    net.backward()
    for got, want in zip(tm, jm):
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-8)
    assert_grads_match(jgrads, st.trainables, 1e-8)


@pytest.mark.parametrize("mode", ["gpapprox_closed", "gpapprox_nll"])
def test_gppvae_grads_equal_the_full_batch_gradient(mode):
    """The five-phase splice equals one full-batch gradient of the same
    loss with the same noise (the likelihood noise aside: the regime gives
    it none, so the comparison pins it)."""
    _, ttr = make_pair(mode)
    ttr.cfg = ttr.cfg._replace(constrain_scales=True)
    eps, _, gp_eps = noises(2)
    st = ttr.state
    clear_grads(st.trainables)
    net, fm = tts.full_batch_loss(ttr.model, ttr.cfg, st.trainables, ttr.tdata,
                                  ttr.block_mask, eps=torch.tensor(eps),
                                  gp_eps=torch.tensor(gp_eps))
    net.backward()
    want = {k: None if g is None else g.clone() for k, g in port_grads(st.trainables).items()}
    clear_grads(st.trainables)
    gm = tts.gppvae_grads(ttr.model, ttr.cfg, st.trainables, ttr.tdata, ttr.block_mask,
                          eps=torch.tensor(eps), gp_eps=torch.tensor(gp_eps))
    got = port_grads(st.trainables)
    for name, w in want.items():
        if w is None:
            assert got[name] is None, name
            continue
        rel = ((got[name] - w).abs() / (w.abs() + 1e-12)).max().item()
        assert rel < 1e-10, (name, rel)
    for a, b in zip(gm, fm):
        np.testing.assert_allclose(a.item(), b.item(), rtol=1e-12)


@pytest.mark.parametrize("mode", ["gpapprox_closed", "gpapprox_nll"])
def test_gppvae_grads_match_jax(mode, inject):
    """Against lvae_tpu's gppvae_grads with z = mu, likelihood noise
    unconstrained (it must still get a zero gradient)."""
    jtr, ttr = make_pair(mode, pseudo_minibatch=True)
    jgrads, jm = jts.gppvae_grads(jtr.model, jtr.cfg, jtr.state.trainables, jtr.tdata,
                                  jtr.block_mask, jax.random.key(3))
    st = ttr.state
    clear_grads(st.trainables)
    zeros = torch.zeros(P * T, L, dtype=torch.float64)
    tm = tts.gppvae_grads(ttr.model, ttr.cfg, st.trainables, ttr.tdata, ttr.block_mask,
                          eps=zeros, gp_eps=torch.zeros(2, P, T, L, dtype=torch.float64))
    for got, want in zip(tm, jm):
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-8)
    assert st.trainables.gp.raw_noise.grad is None
    assert np.all(np.asarray(jgrads.gp.raw_noise) == 0.0)
    assert_grads_match(jgrads, st.trainables, 1e-8)


# name: (mode, pseudo_minibatch, optimizer kind)
TRAJECTORIES = {
    "closed_adam": ("closed", False, "adam"),
    "gpapprox_nll_fused": ("gpapprox_nll", False, "fused"),
    "gppvae_gpapprox_closed": ("gpapprox_closed", True, "adam"),
}


@pytest.mark.parametrize("name", sorted(TRAJECTORIES))
def test_three_step_trajectory_matches_jax(name, inject, monkeypatch):
    """Three optimizer steps (optax Adam or the fused flat Adam, the noise
    re-pin under constrain_scales) from a state with nonzero moments (one
    JAX epoch first)."""
    mode, pseudo, opt = TRAJECTORIES[name]
    jtr, _ = make_pair(mode, pseudo, opt=opt, monkeypatch=monkeypatch)
    make = jts.make_gppvae_step if pseudo else jts.make_standard_step
    body = make(jtr.model, jtr.cfg, jtr.optimizer)
    rng = np.random.default_rng(11)
    inject.update(eps=rng.normal(size=(P * T, L)), gp_eps=rng.normal(size=(P, T, L)))
    if pseudo:
        inject.clear()
    jtr.state, _ = body(jtr.state, jtr.tdata, jtr.block_mask)
    _, ttr = make_pair(mode, pseudo, opt=opt, monkeypatch=monkeypatch)
    ttr.state = standard_state_from_jax(jtr.state, ttr.model, dtype=torch.float64)
    assert isinstance(ttr.state.opt_state, tad.FusedAdam) == (opt == "fused")
    for _ in range(3):
        eps, gp, gp_eps = noises(int(rng.integers(1 << 30)))
        if pseudo:
            eps, gp_eps = np.zeros_like(eps), np.zeros_like(gp_eps)
        else:
            inject.update(eps=eps, gp_eps=gp)
        jtr.state, want = body(jtr.state, jtr.tdata, jtr.block_mask)
        got = ttr.run_epoch(eps=torch.tensor(eps), gp_eps=torch.tensor(gp_eps))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, float(w), rtol=1e-6)
    for pname, want, got in trainable_arrays(jtr.state.trainables, ttr.state.trainables):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12, err_msg=pname)
    assert ttr.state.step == int(jtr.state.step) == 4


@pytest.mark.parametrize("opt", ["adam", "fused"])
def test_standard_state_from_jax_carries_everything(opt, monkeypatch):
    jtr, ttr = make_pair("gpapprox_closed", opt=opt, monkeypatch=monkeypatch)
    jtr.run_epoch()
    jtr.run_epoch()
    st = standard_state_from_jax(jtr.state, ttr.model, dtype=torch.float64)
    for name, want, got in trainable_arrays(jtr.state.trainables, st.trainables):
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert st.step == int(jtr.state.step) == 2
    params = list(st.trainables.parameters())
    if opt == "fused":
        jstate = jtr.state.opt_state
        _, unravel = ravel_pytree(jtr.state.trainables)
        n = sum(p.numel() for p in params)
        assert st.opt_state.count == int(jstate.count) == 2
        for buf, flat in ((st.opt_state.mu, jstate.mu), (st.opt_state.nu, jstate.nu)):
            tree = unravel(jnp.asarray(flat)[:n])
            for (name, want, _), piece in zip(trainable_arrays(tree, st.trainables),
                                              buf.split([p.numel() for p in params])):
                np.testing.assert_array_equal(piece.numpy(), want.reshape(-1), err_msg=name)
        return
    adam = jtr.state.opt_state[0]
    state = st.opt_state.state
    assert len(state) == len(params)
    for (name, mu, _), (_, nu, _), p in zip(trainable_arrays(adam.mu, st.trainables),
                                            trainable_arrays(adam.nu, st.trainables), params):
        np.testing.assert_array_equal(state[p]["exp_avg"].numpy(), mu, err_msg=name)
        np.testing.assert_array_equal(state[p]["exp_avg_sq"].numpy(), nu, err_msg=name)
        assert float(state[p]["step"]) == float(adam.count)


def test_fit_replays_rolled_back_chunks_and_repeats_itself():
    runs = []
    for _ in range(2):
        _, ttr = make_pair("closed")
        calls = []

        def callback(trainer, done, last):
            calls.append(done)
            return "rollback" if calls == [1, 2] else None

        history = ttr.fit(3, log_every=0, callback=callback, chunk=1)
        assert calls == [1, 2, 2, 3]
        assert len(history) == 4 and ttr.state.step == 4
        assert all(np.isfinite(m.net) for m in history)
        runs.append(history)
    assert runs[0] == runs[1]  # the CPU generator draws the same noise


def test_noise_is_repinned_and_no_kernel_launches_on_the_cpu():
    _, ttr = make_pair("closed")
    before = tkm.kernel_matrix_fused.launches, tad.fused_adam_update.launches
    ttr.run_epochs(2)
    assert (tkm.kernel_matrix_fused.launches, tad.fused_adam_update.launches) == before
    np.testing.assert_array_equal(ttr.state.trainables.gp.raw_noise.detach().numpy(),
                                  float(tkx.unconstrain(1.0)))


def test_closed_step_runs_the_closed_kl_backward_once():
    """One eager closed-regime step differentiates kl_closed through
    ClosedKL's closed-form backward, once."""
    _, ttr = make_pair("closed")
    before = teb.ClosedKL.backward_calls
    ttr.run_epochs(1)
    assert teb.ClosedKL.backward_calls == before + 1


def test_trainer_rejects_what_the_regime_does_not_take():
    ds = cohort()
    tcfg = tts.StandardConfig(*tkx.split_kernel_spec(**SPEC), latent_dim=L, P_tot=P, T=T,
                              weight=0.3, loss_function="mse", type_KL="closed",
                              num_samples=1, constrain_scales=True, eps=1e-5, dropout=False)
    blocks = tbk.build_subject_blocks(ds.labels, 2)
    z = ds.labels[:M]

    def build(cfg=tcfg, dataset=ds, blk=blocks, **kw):
        return tts.StandardTrainer(tv.make_vae("simple", L, D), cfg, dataset, blk, z, **kw)

    # GPPVAE takes only the sparse bounds, as the reference asserts
    with pytest.raises(ValueError, match="mini_batch"):
        build(pseudo_minibatch=True, device="cpu")
    with pytest.raises(ValueError, match="mini_batch"):
        tts.gppvae_grads(None, tcfg, None, None, torch.ones(P, T))
    # fixed-T cohorts only
    ragged = cohort(ragged=True)
    with pytest.raises(ValueError, match="fixed-T"):
        build(dataset=ragged, blk=tbk.build_subject_blocks(ragged.labels, 2), device="cpu")
    with pytest.raises(ValueError, match="type_KL"):
        build(cfg=tcfg._replace(type_KL="other"), device="cpu").run_epoch()
    # the card by default
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
