"""The port's standard epoch program (``StandardTrainer.fit``/``run_epochs``
over the closed, GPapprox and GPapprox_closed modes and the five-phase
GPPVAE regime) on the CPU, where each step runs eagerly (on the card a
replay of a captured CUDA graph: ``tests/test_torch_cuda.py``).

The program is held against lvae_tpu's scanned ``epochs_fn`` in float64 from
one state (``tests/test_torch_standard.py``'s pair: P=4 subjects × T=3
frames, SimpleVAE on 12 features, L=2, M=6): ``fit`` over 2 chunks of 2
epochs, JAX's noise rebuilt from its key chain (``lvae_tpu/train/
standard.py`` step_fn, full_batch_loss, gppvae_grads) and handed to the
port. The epoch metrics and every trained tensor agree at rtol 1e-8
(summation order only; atol 1e-12 for entries near zero). The ways to run
the program (chunks of 1, 3 and all epochs, with and without the one-chunk
lag, a ``run_epoch`` loop, a chunk staged an epoch at a time, and the noise
drawn one epoch at a time in the eager step's order and injected) give the
same bits, and assigning ``state`` drops the captured step.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvae_torch.parallel import mesh as tpm
from lvae_torch.train import graph as tgraph
from lvae_torch.train import standard as tts
from test_torch_standard import L, P, T, make_pair, trainable_arrays

EPOCHS, CHUNK = 4, 2
# name: (test_torch_standard mode, pseudo_minibatch)
RUNS = {
    "closed": ("closed", False),
    "GPapprox": ("gpapprox_nll", False),
    "GPapprox_closed": ("gpapprox_closed", False),
    "GPPVAE_GPapprox_closed": ("gpapprox_closed", True),
}


def normal(key, shape):
    return np.array(jax.random.normal(key, shape, dtype=jnp.float64))


def jax_noise(cfg, key, epochs: int, pseudo: bool):
    """The noise ``epochs_fn`` draws from the carried key, epoch by epoch:
    per epoch the encoder's ``[N, L]`` and, under GPapprox, the samples'
    ``[num_samples, P, T, L]``. A full-batch step splits its key into
    (dropout, encoder, GP) keys; the GPPVAE step into (dropout, GP, replay,
    dropout), the replay of subject i drawing from ``fold_in(replay, i)``."""
    out = []
    for _ in range(epochs):
        key, sub = jax.random.split(key)
        if pseudo:
            _, k_gp, k_recon, _ = jax.random.split(sub, 4)
            eps = np.concatenate([normal(jax.random.fold_in(k_recon, i), (T, L))
                                  for i in range(P)])
        else:
            _, k_sample, k_gp = jax.random.split(sub, 3)
            eps = normal(k_sample, (P * T, L))
        draws = [eps]
        if cfg.type_KL == "GPapprox":
            draws.append(np.stack([normal(k, (P, T, L))
                                   for k in jax.random.split(k_gp, cfg.num_samples)]))
        out.append(draws)
    return out


def inject(trainer, noise):
    """Replace the drawn noise by ``noise[epoch]`` (one array an input of
    ``_epoch_specs``), consumed in order across chunks."""
    epochs = iter(noise)

    def draw(e, inputs):
        for x, a in zip(inputs, next(epochs)):
            x.copy_(torch.as_tensor(a))

    trainer._draw = draw


@pytest.mark.parametrize("name", sorted(RUNS))
def test_fit_in_chunks_matches_jax_epochs_fn(name):
    mode, pseudo = RUNS[name]
    jtr, ttr = make_pair(mode, pseudo_minibatch=pseudo)
    inject(ttr, jax_noise(jtr.cfg, jtr.state.rng, EPOCHS, pseudo))
    jtr.fit(EPOCHS, log_every=0, chunk=CHUNK, overlap=False)
    ttr.fit(EPOCHS, log_every=0, chunk=CHUNK)
    assert len(ttr.history) == len(jtr.history) == EPOCHS
    for got, want in zip(ttr.history, jtr.history):
        np.testing.assert_allclose(list(got), [float(w) for w in want], rtol=1e-8)
    for pname, want, got in trainable_arrays(jtr.state.trainables, ttr.state.trainables):
        np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-12, err_msg=pname)
    assert ttr.state.step == int(jtr.state.step) == EPOCHS
    assert ttr._graphs == {}  # the CPU steps eagerly: nothing is captured


def run(how, monkeypatch, name="GPapprox"):
    """A port trainer (from one state every call) after EPOCHS epochs run
    ``how``."""
    mode, pseudo = RUNS[name]
    _, trainer = make_pair(mode, pseudo_minibatch=pseudo)
    if how == "run_epoch":
        for _ in range(EPOCHS):
            trainer.run_epoch()
    elif how == "injected":  # the eager step's draws, one epoch at a time
        gen = torch.Generator()
        gen.set_state(trainer.state.rng.get_state())
        for _ in range(EPOCHS):
            eps, gp_eps = (torch.randn(shape, generator=gen, dtype=dtype)
                           for shape, dtype in trainer._epoch_specs())
            trainer.run_epoch(eps=eps, gp_eps=gp_eps)
    elif how == "slab_in_parts":  # each epoch's noise staged and copied on its own
        monkeypatch.setattr(tgraph, "SLAB_BYTES", 1)
        trainer.fit(EPOCHS, log_every=0, chunk=EPOCHS)
    else:
        chunk, overlap = how
        trainer.fit(EPOCHS, log_every=0, chunk=chunk or EPOCHS, overlap=overlap)
    return trainer


@pytest.mark.parametrize("how", [(1, True), (1, False), (3, True), (3, False), (None, True),
                                 "run_epoch", "injected", "slab_in_parts"], ids=str)
def test_ways_to_run_are_bit_equal(how, monkeypatch):
    want = run((None, False), monkeypatch)
    got = run(how, monkeypatch)
    assert got.history == want.history and len(got.history) == EPOCHS
    assert got.state.step == want.state.step == EPOCHS
    for a, b in zip(got.state.trainables.parameters(), want.state.trainables.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(got.state.opt_state.state.values(), want.state.opt_state.state.values()):
        assert all(torch.equal(a[k], b[k]) for k in ("exp_avg", "exp_avg_sq"))
    if how != "injected":  # the injected epochs draw from a copy of the generator
        assert torch.equal(got.state.rng.get_state(), want.state.rng.get_state())


@pytest.mark.parametrize("name", ["closed", "GPPVAE_GPapprox_closed"])
def test_rolled_back_chunks_run_again_with_the_same_bits(name, monkeypatch):
    """A callback that restores the state it saw after chunk 1 (through the
    state setter) at the end of chunk 2 has chunk 2 run again: the run
    reports 3 chunks of epochs and ends as the straight run does."""
    want = run((CHUNK, False), monkeypatch, name)
    _, trainer = make_pair(*RUNS[name])
    saved, calls = {}, []

    def callback(tr, done, last):
        calls.append(done)
        if done == CHUNK:
            saved["state"] = snapshot(tr.state)
        elif calls == [CHUNK, 2 * CHUNK]:
            tr.state = restore(tr.state, saved["state"])
            del tr.history[CHUNK:]
            return "rollback"
        return None

    trainer.fit(EPOCHS, log_every=0, callback=callback, chunk=CHUNK)
    assert calls == [CHUNK, 2 * CHUNK, 2 * CHUNK]
    assert trainer.history == want.history
    for a, b in zip(trainer.state.trainables.parameters(), want.state.trainables.parameters()):
        assert torch.equal(a, b)


def snapshot(state):
    """Copies of the state's tensors, Adam's and the generator's."""
    return (
        [p.detach().clone() for p in state.trainables.parameters()],
        {k: {n: (v.clone() if torch.is_tensor(v) else v) for n, v in s.items()}
         for k, s in enumerate(state.opt_state.state.values())},
        state.rng.get_state(), state.step)


def restore(state, snap):
    """``state`` with ``snap``'s values written in place, as a new state
    object (the setter's input)."""
    params, opt, rng, step = snap
    with torch.no_grad():
        for p, v in zip(state.trainables.parameters(), params):
            p.copy_(v)
    for s, saved in zip(state.opt_state.state.values(), opt.values()):
        for n, v in saved.items():
            if torch.is_tensor(v):
                s[n].copy_(v)
            else:
                s[n] = v
    state.rng.set_state(rng)
    return state._replace(step=step)


def test_assigning_the_state_drops_the_captured_step():
    _, trainer = make_pair("closed")
    graphs = trainer._graphs
    graphs["stale"] = object()  # as a capture on the card would leave it
    trainer.state = trainer.state._replace(step=7)
    assert trainer._graphs == {} and trainer._graphs is not graphs
    trainer.run_epoch()  # stepping keeps the (empty) graphs and counts the step
    assert trainer.state.step == 8 and trainer._graphs == {}


def test_fit_prints_each_epoch_in_order_under_the_lag(capsys):
    _, trainer = make_pair("gpapprox_closed")
    trainer.fit(5, log_every=1, chunk=2, overlap=True)
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("Iter")]
    assert [ln.split()[1] for ln in lines] == [f"{e}/5" for e in range(1, 6)]


def test_the_noise_must_be_given_to_the_loss():
    _, trainer = make_pair("gpapprox_nll")
    st = trainer.state
    eps = torch.zeros(P * T, L, dtype=torch.float64)
    with pytest.raises(ValueError, match="noise must be given"):
        tts.full_batch_loss(trainer.model, trainer.cfg, st.trainables, trainer.tdata,
                            trainer.block_mask, eps=eps)


def test_sharded_fit_passes_overlap_through():
    class Inner:
        device = torch.device("cpu")

        def fit(self, *args, **kwargs):
            self.seen = kwargs
            return []

    inner = Inner()
    sharded = tpm._ShardedTrainer(inner, SimpleNamespace(device=torch.device("cpu")))
    sharded.fit(3, log_every=0, chunk=2, overlap=False)
    assert inner.seen == {"overlap": False, "chunk": 2}
