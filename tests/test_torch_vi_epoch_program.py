"""The port's VI epoch programs (``VITrainer.fit`` for phase 1,
``optimize_prediction_set`` for phase 2) on the CPU, where each step runs
eagerly (on the card a replay of a captured CUDA graph:
``tests/test_torch_cuda.py``).

Both are held against lvae_tpu's scanned programs in float64 from one
state (``tests/test_torch_vi.py``'s pair: JAX's trainer after one step,
carried to the port): phase 1 as ``fit`` over 2 chunks of 2 epochs against
``epochs_fn``, phase 2 as 5 steps in chunks of 2 against ``pred_steps``,
JAX's noise rebuilt from its key chains and handed to the port. The epoch
metrics and every optimised tensor (the moments, the decoder, the GP
parameters) agree at rtol 1e-8 (summation order only; atol 1e-12 for
entries near zero). The ways to run
each program (chunks of 1, 3 and all steps; phase 1 also with and without
the one-chunk lag, as a ``train_step`` loop and with its noise staged an
epoch at a time; phase 2 also with the drawn noise injected) give the same
bits. The cohort is P=4 subjects × T=3
frames, L=2, M=4 (``test_torch_vi.py``'s).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvae_torch.train import graph as tgraph
from test_torch_vi import PRED, L, make_pair, state_arrays

EPOCHS, PRED_STEPS = 4, 5


def phase1_noise(key, shape, steps):
    """The noise ``epochs_fn`` draws from its carried key, step by step
    (lvae_tpu/train/vi.py step_fn: split, then normal of the second key)."""
    out = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, shape, dtype=jnp.float64)))
    return np.stack(out)


def phase2_noise(seed, n_pred, steps, chunk):
    """The noise ``pred_steps`` draws: one split of the key a chunk, then the
    chunk's subkey split into one key a step (lvae_tpu/train/vi.py:354-363)."""
    key, out, done = jax.random.key(seed), [], 0
    while done < steps:
        n = min(chunk, steps - done)
        key, sub = jax.random.split(key)
        out += [np.asarray(jax.random.normal(k, (n_pred, L), dtype=jnp.float64))
                for k in jax.random.split(sub, n)]
        done += n
    return np.stack(out)


def inject(trainer, noise):
    """Replace phase 1's drawn noise by ``noise [epochs, N, L]``, consumed
    in order across chunks."""
    epochs = iter(noise)
    trainer._draw = lambda e, inputs: inputs[0].copy_(torch.as_tensor(next(epochs)))


@pytest.mark.parametrize("regime", ["mse_constrained", "nll_free_noise"])
def test_phase1_fit_in_chunks_matches_jax_epochs_fn(regime):
    jtr, ttr = make_pair(regime)
    inject(ttr, phase1_noise(jtr.state.rng, jtr.state.mu.shape, EPOCHS))
    jtr.fit(EPOCHS, log_every=0, chunk=2, overlap=False)
    ttr.fit(EPOCHS, log_every=0, chunk=2)
    assert len(ttr.history) == len(jtr.history) == EPOCHS
    for got, want in zip(ttr.history, jtr.history):
        np.testing.assert_allclose([got[k] for k in want], list(want.values()), rtol=1e-8)
    for name, want, got in state_arrays(jtr.state, ttr.state):
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-8, atol=1e-12,
                                   err_msg=name)


@pytest.mark.parametrize("regime", ["mse_constrained", "nll_free_noise"])
def test_phase2_in_chunks_matches_jax_pred_steps(regime):
    jtr, ttr = make_pair(regime)
    want_mu, want_lv = jtr.optimize_prediction_set(PRED, epochs=PRED_STEPS, learning_rate=1e-2,
                                                   log_every=0, seed=1, chunk=2)
    eps = phase2_noise(1, len(PRED), PRED_STEPS, chunk=2)
    mu, lv = ttr.optimize_prediction_set(PRED, epochs=PRED_STEPS, learning_rate=1e-2,
                                         log_every=0, chunk=2, eps=torch.tensor(eps))
    np.testing.assert_allclose(mu, want_mu, rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(lv, want_lv, rtol=1e-8, atol=1e-12)
    assert len(ttr.pred_history) == PRED_STEPS
    assert all(np.isfinite(list(m.values())).all() for m in ttr.pred_history)


def phase1_run(how, monkeypatch):
    _, trainer = make_pair("nll_free_noise")
    if how == "train_step":
        rows = [trainer.train_step().tolist() for _ in range(EPOCHS)]
        trainer.history = [dict(zip(("net", "recon", "nll", "gp"), r)) for r in rows]
    elif how == "slab_in_parts":  # each epoch's noise staged and copied on its own
        monkeypatch.setattr(tgraph, "SLAB_BYTES", 1)
        trainer.fit(EPOCHS, log_every=0, chunk=EPOCHS)
    else:
        chunk, overlap = how
        trainer.fit(EPOCHS, log_every=0, chunk=chunk or EPOCHS, overlap=overlap)
    return trainer


@pytest.mark.parametrize("how", [(1, True), (1, False), (3, True), (3, False), (None, True),
                                 "train_step", "slab_in_parts"], ids=str)
def test_phase1_ways_to_run_are_bit_equal(how, monkeypatch):
    want = phase1_run((None, False), monkeypatch)
    got = phase1_run(how, monkeypatch)
    assert got.history == want.history and len(got.history) == EPOCHS
    # mu, log_var, the decoder and the GP parameters, and Adam's moments
    for a, b in zip(got.state.opt_state.state.values(), want.state.opt_state.state.values()):
        assert all(torch.equal(a[k], b[k]) for k in ("exp_avg", "exp_avg_sq"))
    for a, b in zip(got.state.opt_state.param_groups[0]["params"],
                    want.state.opt_state.param_groups[0]["params"]):
        assert torch.equal(a, b)


def phase2_run(how):
    _, trainer = make_pair("mse_constrained")
    kw = dict(epochs=PRED_STEPS, learning_rate=1e-2, log_every=0, seed=3)
    if how == "injected":  # the noise the generator would draw, step by step
        gen = torch.Generator().manual_seed(3)
        kw["eps"] = torch.stack([torch.randn((len(PRED), L), generator=gen,
                                             dtype=torch.float64) for _ in range(PRED_STEPS)])
        how = None
    mu, lv = trainer.optimize_prediction_set(PRED, chunk=how or PRED_STEPS, **kw)
    return mu, lv, trainer.pred_history


@pytest.mark.parametrize("how", [1, 3, "injected"], ids=str)
def test_phase2_ways_to_run_are_bit_equal(how):
    want = phase2_run(None)
    got = phase2_run(how)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2] and len(got[2]) == PRED_STEPS


def test_fit_prints_each_epoch_in_order_under_the_lag(capsys):
    _, trainer = make_pair("mse_constrained")
    trainer.fit(5, log_every=1, chunk=2, overlap=True)
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("Iter")]
    assert [ln.split()[1] for ln in lines] == [f"{e}/5" for e in range(1, 6)]
