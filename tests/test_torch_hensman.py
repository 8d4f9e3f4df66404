"""The port's Hensman training (lvae_torch.train) against lvae_tpu's, on the
CPU in float64.

Both packages start from one state: lvae_tpu's ``HensmanTrainer`` makes it
(its VAE params cast to float64) and ``utils/convert.hensman_state_from_jax``
carries it to the port, Adam moments included. The reparameterisation noise
is injected on both sides, on the JAX side by replacing
``lvae_tpu.models.vae.sample_latent`` in the test, and both take the same
explicit batch rows. Tolerances: one ``batch_loss`` value and its gradient
for every trainable at rtol 1e-8 (summation order only); a 3-step trajectory
(Adam and the natural-gradient update) at rtol 1e-6, where Adam's division
by √v̂ + eps magnifies the 1e-12-level differences of near-zero gradients.
The cohort is P=5 subjects × T=4 frames in the HealthMNIST label layout with
the config file's kernel spec, L=3, M=6, two subjects per batch, so the
third batch holds one real subject and one ghost.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lvae_tpu.data import blocks as jbk
from lvae_tpu.data.datasets import ArrayDataset
from lvae_tpu.models import vae as jv
from lvae_tpu.ops import elbo as jeb
from lvae_tpu.ops import kernels as jkx
from lvae_tpu.train import hensman as jth
from lvae_tpu.train import state as jst
from lvae_torch.data import blocks as tbk
from lvae_torch.models import vae as tv
from lvae_torch.ops import elbo as teb
from lvae_torch.ops import kernels as tkx
from lvae_torch.train import hensman as tth
from lvae_torch.train import state as tst
from lvae_torch.utils.convert import hensman_state_from_jax, vae_state_dict_from_jax

P, T, L, M, S = 5, 4, 3, 6, 2
SPEC = dict(
    cat_kernel=[2], sqexp_kernel=[0],
    cat_int_kernel=[
        {"cont_covariate": 0, "cat_covariate": 2},
        {"cont_covariate": 0, "cat_covariate": 3},
        {"cont_covariate": 1, "cat_covariate": 4},
    ],
)
# regime name: (model, natural_gradient, loss_function, constrain_scales)
REGIMES = {
    "conv_ng_mse": ("conv", True, "mse", True),
    "simple_adam_nll": ("simple", False, "nll", False),
}


def cohort(kind, seed=0, ragged=False):
    rng = np.random.default_rng(seed)
    rows = []
    for s in range(P):
        sick, gender, loc = (int(v) for v in rng.integers(0, 2, 3))
        t_len = T - (s % 2) if ragged else T
        for i in range(t_len):
            rows.append([i + rng.uniform(), (i - 1.0) if sick else 0.0, s, gender, sick, loc])
    labels = np.asarray(rows)
    n = labels.shape[0]
    shape = (n, 36, 36, 1) if kind == "conv" else (n, 20)
    data = rng.uniform(size=shape)
    mask = (rng.uniform(size=(n, int(np.prod(shape[1:])))) > 0.2).astype(np.float64)
    return ArrayDataset(data=data, labels=labels, mask=mask)


def make_pair(regime, ragged=False, t_buckets=1):
    """(JAX trainer with a float64 state, port trainer from that state)."""
    kind, ng, loss, constrain = REGIMES[regime]
    ds = cohort(kind, ragged=ragged)
    num_dim = int(np.prod(ds.data.shape[1:]))
    cfg_args = dict(
        latent_dim=L, P_tot=P, N_tot=len(ds), weight=0.15, loss_function=loss,
        natural_gradient=ng, natural_gradient_lr=0.01, constrain_scales=constrain,
        eps=1e-5, dropout=False,
    )
    jcfg = jth.HensmanConfig(*jkx.split_kernel_spec(id_covariate=2, **SPEC), **cfg_args)
    tcfg = tth.HensmanConfig(*tkx.split_kernel_spec(id_covariate=2, **SPEC), **cfg_args)
    z = jst.init_inducing_points(ds.labels, M, seed=0, dtype=np.float64)
    jmodel = (jv.ConvVAE(latent_dim=L, num_dim=num_dim, p=0.0, dtype=jnp.float64)
              if kind == "conv" else jv.SimpleVAE(latent_dim=L, num_dim=num_dim,
                                                  dtype=jnp.float64))
    jtr = jth.HensmanTrainer(jmodel, jcfg, ds, jbk.build_subject_blocks(ds.labels, 2), z,
                             subjects_per_batch=S, seed=0, dtype=jnp.float64,
                             t_buckets=t_buckets)
    tr64 = jax.tree.map(lambda x: x.astype(jnp.float64), jtr.state.trainables)
    jtr.state = jtr.state._replace(trainables=tr64, opt_state=jtr.optimizer.init(tr64))
    tmodel = tv.make_vae(kind, L, num_dim, dropout=0.0, dtype=torch.float64)
    ttr = tth.HensmanTrainer(tmodel, tcfg, ds, tbk.build_subject_blocks(ds.labels, 2), z,
                             subjects_per_batch=S, seed=0, dtype=torch.float64,
                             t_buckets=t_buckets, device="cpu")
    ttr.state = hensman_state_from_jax(jtr.state, ttr.model, dtype=torch.float64)
    return jtr, ttr


@pytest.fixture
def inject_eps(monkeypatch):
    """Make JAX's sample_latent use the test's noise."""
    holder = {}

    def sample_latent(rng, mu, log_var):
        return mu + jnp.asarray(holder["eps"]) * jnp.exp(0.5 * log_var)

    monkeypatch.setattr(jv, "sample_latent", sample_latent)
    return holder


def jax_batch(jtr, rows):
    table = jtr.tables[0]
    rows = jnp.asarray(rows)
    idx = jnp.take(table.index, rows, axis=0)
    bmask = jnp.take(table.mask, rows, axis=0)
    p_batch = jnp.sum(rows < table.num_real).astype(bmask.dtype)
    return idx, bmask, p_batch


def jax_step(jtr, rows, eps, holder):
    """The JAX step body (train/hensman.py make_step) on explicit rows."""
    holder["eps"] = eps
    st = jtr.state
    idx, bmask, p_batch = jax_batch(jtr, rows)
    (net, (metrics, ng)), grads = jax.value_and_grad(
        lambda tr: jth.batch_loss(jtr.model, jtr.cfg, tr, st.m_nat, st.H_nat, jtr.tdata,
                                  idx, bmask, p_batch, jax.random.key(0)),
        has_aux=True,
    )(st.trainables)
    updates, opt_state = jtr.optimizer.update(grads, st.opt_state, st.trainables)
    m_nat, H_nat = st.m_nat, st.H_nat
    if jtr.cfg.natural_gradient:
        m_nat, H_nat = jeb.natural_gradient_update(m_nat, H_nat, ng, jtr.cfg.natural_gradient_lr)
    jtr.state = st._replace(trainables=optax.apply_updates(st.trainables, updates),
                            opt_state=opt_state, m_nat=m_nat, H_nat=H_nat, step=st.step + 1)
    return metrics, grads


def trainable_arrays(jtrainables, ttrainables):
    """Matching (name, JAX numpy, port numpy) triples of every trainable."""
    jsd = vae_state_dict_from_jax(jtrainables.vae, np.float64)
    out = [(n, jsd[n].numpy(), p.detach().numpy())
           for n, p in ttrainables.vae.named_parameters()]
    jgp = [*jtrainables.gp.kp0, *jtrainables.gp.kp1, jtrainables.gp.raw_noise]
    out += [(f"gp{i}", np.asarray(a), b.detach().numpy())
            for i, (a, b) in enumerate(zip(jgp, ttrainables.gp.tensors()))]
    for name in ("m", "h_factor"):
        a, b = getattr(jtrainables, name), getattr(ttrainables, name)
        assert (a is None) == (b is None)
        if a is not None:
            out.append((name, np.asarray(a), b.detach().numpy()))
    return out


def port_grads(ttrainables):
    """The port's gradients under the names of :func:`trainable_arrays`."""
    out = {n: p.grad for n, p in ttrainables.vae.named_parameters()}
    out.update({f"gp{i}": x.grad for i, x in enumerate(ttrainables.gp.tensors())})
    for name in ("m", "h_factor"):
        if getattr(ttrainables, name) is not None:
            out[name] = getattr(ttrainables, name).grad
    return out


@pytest.mark.parametrize("rows", [[0, 3], [4, 5]], ids=["full", "ghost_padded"])
@pytest.mark.parametrize("regime", sorted(REGIMES))
def test_batch_loss_value_and_grads_match_jax(regime, rows, inject_eps):
    jtr, ttr = make_pair(regime)
    eps = np.random.default_rng(5).normal(size=(S * T, L))
    metrics, jgrads = jax_step(jtr, rows, eps, inject_eps)
    table = ttr.tables[0]
    order = torch.tensor(rows)
    st = ttr.state
    for p in st.trainables.parameters():
        p.grad = None
    net, (tmetrics, tng) = tth.batch_loss(
        ttr.model, ttr.cfg, st.trainables, st.m_nat, st.H_nat, ttr.tdata,
        table.index[order], table.mask[order],
        torch.sum(order < table.num_real).to(torch.float64), eps=torch.tensor(eps),
    )
    net.backward()
    for got, want in zip(tmetrics, metrics):
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-8)
    got_grads = port_grads(st.trainables)
    for name, want, _ in trainable_arrays(jgrads, st.trainables):
        got = got_grads[name]
        # a trainable the loss does not reach has no port gradient; JAX's is 0
        got = np.zeros_like(want) if got is None else got.numpy()
        np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-13 * np.abs(want).max(),
                                   err_msg=name)


@pytest.mark.parametrize("regime", sorted(REGIMES))
def test_three_step_trajectory_matches_jax(regime, inject_eps):
    """Adam plus the natural-gradient update, from a state with nonzero
    Adam moments (one JAX epoch first), over three steps incl. a ghost."""
    jtr, _ = make_pair(regime)
    inject_eps["eps"] = np.zeros((S * T, L))
    jtr.run_epoch()
    tmodel = tv.make_vae(REGIMES[regime][0], L, jtr.tdata.data[0].size, dropout=0.0,
                         dtype=torch.float64)
    _, ttr = make_pair(regime)
    ttr.model = tmodel
    ttr.state = hensman_state_from_jax(jtr.state, tmodel, dtype=torch.float64)
    rng = np.random.default_rng(11)
    for rows in ([1, 2], [4, 5], [0, 3]):
        eps = rng.normal(size=(S * T, L))
        want, _ = jax_step(jtr, rows, eps, inject_eps)
        got = ttr.train_step(ttr.tables[0], torch.tensor(rows), eps=torch.tensor(eps))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.item(), float(w), rtol=1e-6)
    for name, want, got in trainable_arrays(jtr.state.trainables, ttr.state.trainables):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12, err_msg=name)
    if jtr.cfg.natural_gradient:
        np.testing.assert_allclose(ttr.state.m_nat.numpy(), np.asarray(jtr.state.m_nat),
                                   rtol=1e-6, atol=1e-12)
        np.testing.assert_allclose(ttr.state.H_nat.numpy(), np.asarray(jtr.state.H_nat),
                                   rtol=1e-6, atol=1e-12)
    assert ttr.state.step == int(jtr.state.step)


def test_hensman_state_from_jax_carries_everything():
    jtr, ttr = make_pair("simple_adam_nll")
    jtr.run_epoch()
    st = hensman_state_from_jax(jtr.state, ttr.model, dtype=torch.float64)
    for name, want, got in trainable_arrays(jtr.state.trainables, st.trainables):
        np.testing.assert_array_equal(got, want, err_msg=name)
    adam = jtr.state.opt_state[0]
    opt_state = st.opt_state.state
    params = list(st.trainables.parameters())
    assert len(opt_state) == len(params)
    for (name, want_mu, _), (_, want_nu, _), p in zip(
        trainable_arrays(adam.mu, st.trainables), trainable_arrays(adam.nu, st.trainables),
        params,
    ):
        np.testing.assert_array_equal(opt_state[p]["exp_avg"].numpy(), want_mu, err_msg=name)
        np.testing.assert_array_equal(opt_state[p]["exp_avg_sq"].numpy(), want_nu, err_msg=name)
        assert float(opt_state[p]["step"]) == float(adam.count)
    assert st.step == int(jtr.state.step) == 3


def test_fit_replays_rolled_back_chunks():
    _, ttr = make_pair("simple_adam_nll")
    calls = []

    def callback(trainer, done, last):
        calls.append(done)
        return "rollback" if calls == [1, 2] else None

    history = ttr.fit(3, log_every=0, callback=callback, chunk=1)
    assert calls == [1, 2, 2, 3]
    assert len(history) == 4 and ttr.state.step == 4 * 3
    assert all(np.isfinite(m.net) for m in history)


def test_epochs_are_reproducible_and_cover_every_subject():
    """The CPU generator gives the same run twice; each epoch visits every
    real subject once (three batches, the last with one ghost)."""
    runs = []
    for _ in range(2):
        _, ttr = make_pair("conv_ng_mse")
        seen = []
        real = ttr._run_step  # the epoch program's step

        def spy(b, rows, eps, out):
            seen.append(rows.tolist())
            return real(b, rows, eps, out)

        ttr._run_step = spy
        runs.append((ttr.run_epochs(2), seen))
    assert runs[0][0] == runs[1][0] and runs[0][1] == runs[1][1]
    first = runs[0][1][:3]
    assert sorted(sum(first, [])) == list(range(P + 1))
    assert first[-1] == [first[-1][0], P]


def test_run_epoch_takes_an_explicit_batch_order():
    """An injected order replaces the drawn permutation and nothing else:
    the epoch equals its steps run one by one on those rows."""
    order = [[4, 5], [0, 3], [2, 1]]
    _, a = make_pair("conv_ng_mse")
    got = a.run_epoch(order=[order])
    _, b = make_pair("conv_ng_mse")
    steps = [b.train_step(b.tables[0], torch.tensor(rows)) for rows in order]
    want = [float(torch.stack(col).mean()) for col in zip(*steps)]
    assert list(got) == want
    assert torch.equal(a.state.m_nat, b.state.m_nat) and a.state.step == b.state.step == 3


def test_hensman_step_leaves_the_closed_kl_backward_alone():
    """A Hensman step runs minibatch_kld, never kl_closed: ClosedKL's
    backward counter stays where it was."""
    _, ttr = make_pair("conv_ng_mse")
    before = teb.ClosedKL.backward_calls
    metrics = ttr.train_step(ttr.tables[0], torch.tensor([4, 5]))
    assert all(np.isfinite(float(v)) for v in metrics)
    assert teb.ClosedKL.backward_calls == before


def test_ragged_cohort_in_t_buckets_trains():
    _, ttr = make_pair("conv_ng_mse", ragged=True, t_buckets=2)
    assert [tb.index.shape[1] for tb in ttr.tables] == [T - 1, T]
    m = ttr.run_epoch()
    assert all(np.isfinite(v) for v in m)
    assert np.linalg.eigvalsh(ttr.state.H_nat.numpy()).min() > 0


def test_bucketing_matches_jax():
    t_lens = np.array([3, 3, 5, 8, 8, 9, 12, 4])
    for k in (1, 2, 3, 10):
        assert tbk.bucket_boundaries(t_lens, k) == jbk.bucket_boundaries(t_lens, k)
    ds = cohort("simple", ragged=True)
    jb = jbk.bucket_subject_blocks(jbk.build_subject_blocks(ds.labels, 2), 2)
    tb = tbk.bucket_subject_blocks(tbk.build_subject_blocks(ds.labels, 2), 2)
    assert len(jb) == len(tb) == 2
    for a, b in zip(jb, tb):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_vae_loss_and_vy_match_jax():
    rng = np.random.default_rng(3)
    raw = rng.normal(size=20) * 0.3
    recon, x = rng.uniform(size=(4, 20)), rng.uniform(size=(4, 20))
    mask = (rng.uniform(size=(4, 20)) > 0.4).astype(np.float64)
    mask[2] = 0.0  # an all-missing row: the MSE divides by max(0, 1)
    want = jv.vae_loss(jnp.asarray(raw), jnp.asarray(recon), jnp.asarray(x), jnp.asarray(mask))
    got = tv.vae_loss(*(torch.tensor(a) for a in (raw, recon, x, mask)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12)
    model = tv.make_vae("simple", L, 20, dtype=torch.float64)
    with torch.no_grad():
        model.raw_log_vy.copy_(torch.tensor(raw))
    np.testing.assert_allclose(
        tv.vy_from_params(model).detach().numpy(),
        np.asarray(jv.vy_from_params({"params": {"raw_log_vy": jnp.asarray(raw)}})),
        rtol=1e-12,
    )


def test_state_helpers():
    m_t, h_t = tst.init_variational(L, M, True, seed=4, dtype=torch.float64)
    m_j, h_j = jst.init_variational(L, M, True, seed=4, dtype=jnp.float64)
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    np.testing.assert_array_equal(h_t.numpy(), np.asarray(h_j))
    np.testing.assert_allclose(tst.psd_from_factor(h_t).numpy(),
                               np.asarray(jst.psd_from_factor(h_j)), rtol=1e-12)
    params = [torch.zeros(3, requires_grad=True), torch.ones(2, 2, requires_grad=True)]
    assert bool(tst.tree_finite(params))
    with torch.no_grad():
        params[1][0, 1] = float("nan")
    assert not bool(tst.tree_finite(params))
    fused = tst.make_optimizer(params, kind="fused")
    assert type(fused).__name__ == "FusedAdam" and fused.mu.numel() == 7
    opt = tst.make_optimizer(params, 1e-3, kind="adam")
    assert opt.defaults["betas"] == (0.9, 0.999) and opt.defaults["eps"] == 1e-8
