"""The keys under which the port's trainers capture their steps, on the CPU.

A captured step keeps the algorithms that its warm-up chose, so its key
must carry every switch that changes them: ``train/graph.route_key()``
(the kernel route, cuDNN's ``deterministic`` and both TF32 switches). Each
trainer's steps go through ``StepGraphs.run`` on the CPU too, where they
run eagerly; the test records the keys they pass and finds ``route_key()``
at the end of each, before and after ``cudnn.deterministic`` flips (on the
card, ``tests/test_torch_cuda.py`` sees the second capture).
"""

import pytest
import torch

from lvae_torch.models import vae as tv
from lvae_torch.train import graph as tgraph
from lvae_torch.train import pretrain as tpre
from test_torch_epoch_program import D, L, cohort, port_trainer
from test_torch_standard import make_pair as standard_pair
from test_torch_vi import make_pair as vi_pair


def pretrainer():
    model = tv.make_vae("simple", L, D, dtype=torch.float64,
                        generator=torch.Generator().manual_seed(3))
    return tpre.VAEPretrainer(model, cohort(), loss_function="nll", dropout=False, seed=0,
                              batch_size=8, dtype=torch.float64, device="cpu")


OWNERS = {
    "hensman": (port_trainer, lambda t: t.run_epochs(1)),
    "vi_phase1": (lambda: vi_pair("nll_free_noise")[1], lambda t: t.fit(1, log_every=0)),
    "pretrain": (pretrainer, lambda t: t.run_epochs(1)),
    "standard": (lambda: standard_pair()[1], lambda t: t.run_epochs(1)),
}


@pytest.mark.parametrize("owner", sorted(OWNERS))
def test_captured_steps_key_on_route_key(owner, monkeypatch):
    keys = []
    run = tgraph.StepGraphs.run

    def spy(self, key, *args, **kw):
        keys.append(key)
        return run(self, key, *args, **kw)

    monkeypatch.setattr(tgraph.StepGraphs, "run", spy)
    make, epoch = OWNERS[owner]
    trainer = make()
    for deterministic in (False, True):
        monkeypatch.setattr(torch.backends.cudnn, "deterministic", deterministic)
        route = tgraph.route_key()
        assert route[2] is deterministic
        keys.clear()
        epoch(trainer)
        assert keys and all(tuple(k)[-len(route):] == route for k in keys), (owner, keys)
