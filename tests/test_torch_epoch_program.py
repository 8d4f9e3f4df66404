"""The port's epoch program (``HensmanTrainer.run_epochs``/``fit`` and the
pre-training epochs) on the CPU, where the step function runs eagerly.

The whole slice is held against ``lvae_tpu``'s ``make_epochs_fn``: two
epochs from one float64 state, JAX's permutations and noise rebuilt from its
key chain and handed to the port in place of its own draws; the epoch
metrics and (m, H) at rtol 1e-8 (summation order only), every trainable at
rtol 1e-6, where Adam's division by √v̂ + eps magnifies the 1e-12-level
differences of near-zero gradients (as ``test_torch_hensman.py`` holds its
trajectory). The ways to run the program (one chunk, chunks with and
without the one-chunk lag, epochs with explicit orders, a chunk whose draws
go to the device an epoch at a time) must give the same bits, and so must
the chunk's slab of draws and the draws the steps would take one by one. The cohort is P=5 subjects × T=4 frames in the
HealthMNIST label layout, L=3, M=6, two subjects a batch (the third batch
holds one real subject and a ghost), SimpleVAE in float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvae_tpu.data import blocks as jbk
from lvae_tpu.data.datasets import ArrayDataset
from lvae_tpu.models import vae as jv
from lvae_tpu.ops import kernels as jkx
from lvae_tpu.train import hensman as jth
from lvae_torch.data import blocks as tbk
from lvae_torch.models import vae as tv
from lvae_torch.ops import kernels as tkx
from lvae_torch.train import graph as tgraph
from lvae_torch.train import hensman as tth
from lvae_torch.train import pretrain as tpre
from lvae_torch.train import state as tst
from lvae_torch.utils.convert import hensman_state_from_jax, vae_state_dict_from_jax

P, T, L, M, S, D = 5, 4, 3, 6, 2, 20
SPEC = dict(
    cat_kernel=[2], sqexp_kernel=[0],
    cat_int_kernel=[
        {"cont_covariate": 0, "cat_covariate": 2},
        {"cont_covariate": 0, "cat_covariate": 3},
        {"cont_covariate": 1, "cat_covariate": 4},
    ],
)
CFG = dict(latent_dim=L, P_tot=P, weight=0.15, loss_function="mse", natural_gradient=True,
           natural_gradient_lr=0.01, constrain_scales=True, eps=1e-5, dropout=False)


def cohort():
    rng = np.random.default_rng(0)
    rows = []
    for s in range(P):
        sick, gender, loc = (int(v) for v in rng.integers(0, 2, 3))
        for i in range(T):
            rows.append([i + rng.uniform(), (i - 1.0) if sick else 0.0, s, gender, sick, loc])
    labels = np.asarray(rows)
    n = labels.shape[0]
    return ArrayDataset(data=rng.uniform(size=(n, D)), labels=labels,
                        mask=(rng.uniform(size=(n, D)) > 0.2).astype(np.float64))


def port_trainer(ds=None):
    """A float64 port trainer on the CPU; every call starts from one state."""
    ds = ds or cohort()
    cfg = tth.HensmanConfig(*tkx.split_kernel_spec(id_covariate=2, **SPEC), N_tot=len(ds), **CFG)
    z = tst.init_inducing_points(ds.labels, M, seed=0, dtype=np.float64)
    model = tv.make_vae("simple", L, D, dtype=torch.float64,
                        generator=torch.Generator().manual_seed(0))
    return tth.HensmanTrainer(model, cfg, ds, tbk.build_subject_blocks(ds.labels, 2), z,
                              subjects_per_batch=S, seed=0, dtype=torch.float64, device="cpu")


def state_arrays(trainer):
    st = trainer.state
    return [st.m_nat, st.H_nat, *(p.detach() for p in st.trainables.parameters())]


def jax_draws(key, epochs: int):
    """The permutations and noise ``make_epochs_fn`` draws from its carried
    key: per epoch a split for the permutation, then per step a split whose
    key splits again into dropout and sampling keys."""
    nb = -(-P // S)
    rows = np.zeros((epochs, nb, S), np.int64)
    eps = np.zeros((epochs, nb, S * T, L))
    for e in range(epochs):
        key, perm_key = jax.random.split(key)
        perm = np.concatenate([np.asarray(jax.random.permutation(perm_key, P)),
                               np.arange(P, nb * S)])
        rows[e] = perm.reshape(nb, S)
        for i in range(nb):
            key, step_key = jax.random.split(key)
            _, k_sample = jax.random.split(step_key)
            eps[e, i] = np.asarray(jax.random.normal(k_sample, (S * T, L), dtype=jnp.float64))
    return rows, eps


def test_two_epochs_match_jax_make_epochs_fn():
    ds = cohort()
    jcfg = jth.HensmanConfig(*jkx.split_kernel_spec(id_covariate=2, **SPEC), N_tot=len(ds),
                             **CFG)
    z = np.asarray(tst.init_inducing_points(ds.labels, M, seed=0, dtype=np.float64))
    jtr = jth.HensmanTrainer(jv.SimpleVAE(latent_dim=L, num_dim=D, dtype=jnp.float64), jcfg, ds,
                             jbk.build_subject_blocks(ds.labels, 2), z, subjects_per_batch=S,
                             seed=0, dtype=jnp.float64)
    tr64 = jax.tree.map(lambda x: x.astype(jnp.float64), jtr.state.trainables)
    jtr.state = jtr.state._replace(trainables=tr64, opt_state=jtr.optimizer.init(tr64))
    rows, eps = jax_draws(jtr.state.rng, 2)
    ttr = port_trainer(ds)
    ttr.state = hensman_state_from_jax(jtr.state, ttr.model, dtype=torch.float64)
    ttr._draw = lambda e, inputs: [x.copy_(torch.as_tensor(a[e]))
                                   for x, a in zip(inputs, (rows, eps))]
    want = jtr.run_epochs(2)
    got = ttr.run_epochs(2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(list(g), [float(v) for v in w], rtol=1e-8)
    np.testing.assert_allclose(ttr.state.m_nat.numpy(), np.asarray(jtr.state.m_nat),
                               rtol=1e-8, atol=1e-14)
    np.testing.assert_allclose(ttr.state.H_nat.numpy(), np.asarray(jtr.state.H_nat),
                               rtol=1e-8, atol=1e-14)
    jsd = {k: v.numpy() for k, v in
           vae_state_dict_from_jax(jtr.state.trainables.vae, np.float64).items()}
    for name, p in ttr.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jsd[name], rtol=1e-6, atol=1e-12,
                                   err_msg=name)
    assert ttr.state.step == int(jtr.state.step) == 6
    assert len(ttr.last_steps) == 6 and all(kept for _, kept in ttr.last_steps)


def _run(trainer, how):
    if how in ("run_epochs", "run_epochs_in_parts"):
        trainer.run_epochs(4)
    elif how == "fit_overlap":
        trainer.fit(4, log_every=0, chunk=3, overlap=True)
    elif how == "fit_synced":
        trainer.fit(4, log_every=0, chunk=3, overlap=False)
    else:  # explicit orders, each drawn by the test as the program draws it
        for _ in range(4):
            trainer.run_epoch(order=[trainer._epoch_order(t) for t in trainer.tables])
    return trainer


@pytest.mark.parametrize("how", ["fit_overlap", "fit_synced", "run_epoch_orders",
                                 "run_epochs_in_parts"])
def test_ways_to_run_the_program_are_bit_equal(how, monkeypatch):
    want = _run(port_trainer(), "run_epochs")
    if how == "run_epochs_in_parts":  # each epoch's draws staged and copied on their own
        monkeypatch.setattr(tgraph, "SLAB_BYTES", 1)
    got = _run(port_trainer(), how)
    assert got.history == want.history and len(got.history) == 4
    assert got.last_steps == want.last_steps[-len(got.last_steps):]
    assert got.state.step == want.state.step == 12
    for a, b in zip(state_arrays(got), state_arrays(want)):
        assert torch.equal(a, b)


def test_slab_draws_equal_the_steps_own_draws():
    """The chunk's slab holds, bit for bit, what a generator with the same
    seed gives when each epoch draws its permutation and then each step its
    noise, one ``randn`` at a time."""
    trainer = port_trainer()
    staged = []
    tgraph.run_staged(3, trainer._epoch_specs(), trainer._draw,
                      lambda e, inputs: staged.append(inputs), trainer.device)
    gen = torch.Generator().manual_seed(0)
    for e, (rows, eps) in enumerate(staged):
        perm = torch.cat([torch.randperm(P, generator=gen), torch.arange(P, 6)])
        assert torch.equal(rows, perm.reshape(3, S))
        for i in range(3):
            assert torch.equal(eps[i], torch.randn((S * T, L), generator=gen,
                                                   dtype=torch.float64))
    assert torch.equal(trainer.state.rng.get_state(), gen.get_state())


def test_assigned_state_trains_in_the_next_chunk():
    """After a chunk, an assigned state (new (m, H) tensors) is the one the
    next chunk reads and updates; the tensors it replaced stay as they
    were. The run equals a trainer given that state before its first
    chunk, with its generator in the same place."""
    a, b = port_trainer(), port_trainer()
    a.run_epochs(1)
    old_m, old_h = a.state.m_nat, a.state.H_nat
    kept = old_m.clone(), old_h.clone()
    m_new, h_new = old_m.clone() * 0.5, old_h + 0.1 * torch.eye(M, dtype=torch.float64)
    a.state = a.state._replace(m_nat=m_new, H_nat=h_new)
    a.run_epochs(1)
    assert torch.equal(old_m, kept[0]) and torch.equal(old_h, kept[1])
    assert a.state.m_nat is m_new and not torch.equal(m_new, kept[0] * 0.5)
    b.run_epochs(1)
    b.state = b.state._replace(m_nat=kept[0] * 0.5, H_nat=kept[1] + 0.1 * torch.eye(
        M, dtype=torch.float64))
    b.run_epochs(1)
    assert a.history == b.history
    for x, y in zip(state_arrays(a), state_arrays(b)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("parts", [False, True], ids=["one_slab", "slab_an_epoch"])
def test_pretrain_epoch_program_equals_the_eager_loop(parts, monkeypatch):
    """Two pre-training epochs through the epoch program (their draws in
    one slab, or one slab an epoch) and the same two epochs as a loop of
    eager steps drawing from the generator one step at a time (the loop
    before the program): the same sums and weights."""
    if parts:
        monkeypatch.setattr(tgraph, "SLAB_BYTES", 1)
    ds = cohort()

    def pretrainer():
        model = tv.make_vae("simple", L, D, dtype=torch.float64,
                            generator=torch.Generator().manual_seed(3))
        return tpre.VAEPretrainer(model, ds, loss_function="nll", dropout=False, seed=0,
                                  batch_size=8, dtype=torch.float64, device="cpu")

    prog = pretrainer()
    got = prog.run_epochs(2)
    loop = pretrainer()
    want = []
    for _ in range(2):
        sums = torch.zeros(4, dtype=torch.float64)
        for rows in loop.epoch_order():
            eps = torch.randn((rows.shape[0], L), generator=loop.state.rng, dtype=torch.float64)
            sums = sums + loop._step(rows, eps)
        want.append(tpre.PretrainMetrics(*sums.tolist()))
    assert got == want and prog.state.step == 2 * (len(ds) // 8)
    for a, b in zip(prog.model.parameters(), loop.model.parameters()):
        assert torch.equal(a, b)


def test_collector_is_off_only_inside_a_capture():
    """``train/graph.collector_off``: the garbage collector is off inside the
    block (a graph it freed there would break the capture) and as it was
    after it, an exception included."""
    import gc

    from lvae_torch.train.graph import collector_off

    assert gc.isenabled()
    with pytest.raises(ValueError):
        with collector_off():
            assert not gc.isenabled()
            raise ValueError
    assert gc.isenabled()
    gc.disable()
    try:
        with collector_off():
            pass
        assert not gc.isenabled()
    finally:
        gc.enable()
