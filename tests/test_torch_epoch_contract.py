"""The contract of the epoch program that the port's four trainers share
(``lvae_torch/train/loop.EpochProgram``), held for each of them on the CPU:

* assigning ``state`` drops the captured graphs;
* a callback that restores the state it saw after chunk 1 and returns
  ``"rollback"`` after chunk 2 has chunk 2 run again, and the run ends as
  the straight run does;
* ``fit`` with and without the one-chunk lag gives the same bits;
* a chunk staged one epoch a slab (``graph.SLAB_BYTES = 1``) gives the bits
  of the chunk staged in one slab.

Each trainer is the smallest of its kind on the HealthMNIST-layout cohort
of ``test_torch_epoch_program.py`` (P=5 × T=4, L=3, M=6) in float64.
"""

import numpy as np
import pytest
import torch

from lvae_torch.data import blocks as tbk
from lvae_torch.models import vae as tv
from lvae_torch.ops import kernels as tkx
from lvae_torch.train import graph as tgraph
from lvae_torch.train import pretrain as tpre
from lvae_torch.train import standard as tts
from lvae_torch.train import state as tst
from lvae_torch.train import vi as tvi
from test_torch_epoch_program import D, L, M, P, SPEC, T, cohort, port_trainer

EPOCHS, CHUNK = 4, 2


def _parts():
    ds = cohort()
    model = tv.make_vae("simple", L, D, dtype=torch.float64,
                        generator=torch.Generator().manual_seed(3))
    z = tst.init_inducing_points(ds.labels, M, seed=0, dtype=np.float64)
    return ds, model, tbk.build_subject_blocks(ds.labels, 2), z


def standard():
    ds, model, blocks, z = _parts()
    cfg = tts.StandardConfig(*tkx.split_kernel_spec(id_covariate=2, **SPEC), latent_dim=L,
                             P_tot=P, T=T, weight=0.3, loss_function="nll", type_KL="GPapprox",
                             num_samples=2, constrain_scales=False, eps=1e-5, dropout=False)
    return tts.StandardTrainer(model, cfg, ds, blocks, z, seed=0, dtype=torch.float64,
                               device="cpu")


def vi():
    ds, model, blocks, z = _parts()
    cfg = tvi.VIConfig(*tkx.split_kernel_spec(id_covariate=2, **SPEC), latent_dim=L,
                       weight=0.15, loss_function="nll", constrain_scales=False, eps=1e-5)
    gp = tst.init_gp_params(cfg.spec0, cfg.spec1, L, dtype=torch.float64)
    return tvi.VITrainer(model, cfg, ds, blocks, z, gp, learning_rate=1e-2,
                         dtype=torch.float64, device="cpu")


def pretrain():
    ds, model, _, _ = _parts()
    return tpre.VAEPretrainer(model, ds, loss_function="nll", dropout=False, seed=0,
                              batch_size=8, dtype=torch.float64, device="cpu")


TRAINERS = {"hensman": port_trainer, "standard": standard, "vi": vi, "pretrain": pretrain}


def held(trainer):
    """Every tensor the trainer's steps update: the optimised tensors,
    the optimizer's state and, where the regime has them, (m, H)."""
    st = trainer.state
    opt = st.opt_state
    out = [p for g in opt.param_groups for p in g["params"]]
    out += [v for s in opt.state.values() for v in s.values() if torch.is_tensor(v)]
    return out + [t for t in (getattr(st, "m_nat", None), getattr(st, "H_nat", None))
                  if t is not None]


def assert_same_run(got, want):
    assert got.history == want.history and len(got.history) == EPOCHS
    for a, b in zip(held(got), held(want)):
        assert torch.equal(a, b)
    assert torch.equal(got.state.rng.get_state(), want.state.rng.get_state())


def drops_graphs(make, monkeypatch):
    trainer = make()
    graphs = trainer._graphs
    graphs["stale"] = object()  # as a capture on the card would leave it
    trainer.state = trainer.state
    assert trainer._graphs == {} and trainer._graphs is not graphs
    trainer.run_epochs(1)  # the CPU steps eagerly: nothing is captured
    assert trainer._graphs == {}


def rollback_reruns_the_chunk(make, monkeypatch):
    want = make()
    want.fit(EPOCHS, log_every=0, chunk=CHUNK, overlap=False)
    trainer, saved, calls = make(), {}, []

    def callback(tr, done, last):
        calls.append(done)
        if done == CHUNK:
            saved["tensors"] = [t.detach().clone() for t in held(tr)]
            saved["rng"] = tr.state.rng.get_state()
            saved["step"] = getattr(tr.state, "step", None)
        elif calls == [CHUNK, 2 * CHUNK]:
            with torch.no_grad():
                for t, v in zip(held(tr), saved["tensors"]):
                    t.copy_(v)
            tr.state.rng.set_state(saved["rng"])
            tr.state = (tr.state if saved["step"] is None
                        else tr.state._replace(step=saved["step"]))
            del tr.history[CHUNK:]
            return "rollback"
        return None

    trainer.fit(EPOCHS, log_every=0, callback=callback, chunk=CHUNK)
    assert calls == [CHUNK, 2 * CHUNK, 2 * CHUNK]
    assert_same_run(trainer, want)


def overlap_is_bit_equal(make, monkeypatch):
    got, want = make(), make()
    got.fit(EPOCHS, log_every=0, chunk=CHUNK, overlap=True)
    want.fit(EPOCHS, log_every=0, chunk=CHUNK, overlap=False)
    assert_same_run(got, want)


def slab_an_epoch_is_bit_equal(make, monkeypatch):
    want = make()
    want.run_epochs(EPOCHS)
    monkeypatch.setattr(tgraph, "SLAB_BYTES", 1)
    got = make()
    got.run_epochs(EPOCHS)
    assert_same_run(got, want)


CLAUSES = {f.__name__: f for f in (drops_graphs, rollback_reruns_the_chunk,
                                   overlap_is_bit_equal, slab_an_epoch_is_bit_equal)}


@pytest.mark.parametrize("clause", sorted(CLAUSES))
@pytest.mark.parametrize("trainer", sorted(TRAINERS))
def test_every_trainer_keeps_the_epoch_program_contract(trainer, clause, monkeypatch):
    CLAUSES[clause](TRAINERS[trainer], monkeypatch)
