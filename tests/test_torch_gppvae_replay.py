"""The GPPVAE step's batched replay (``lvae_torch.train.standard``), on the
CPU in float64.

Phase 4 of ``gppvae_grads`` replays the encoder over the whole cohort in
one pass: the step encodes the cohort's P·T frames twice (the no-grad
encode, then the replay) and decodes them once. The VAE couples no two
subjects' frames and its loss is per frame, so that pass's gradients and
metrics equal those of a replay run subject by subject (the encoder and
decoder called on each subject's T frames apart); the tests hold each
gradient's difference to 1e-10 of its norm, and the metrics to rel 1e-10,
with the ConvVAE, the MLP VAE and the RNN encoder (which couples a
subject's frames), under the DUBO with MSE and GPapprox with the NLL.
"""

import numpy as np
import pytest
import torch

from lvae_torch.data.blocks import build_subject_blocks
from lvae_torch.data.datasets import ArrayDataset
from lvae_torch.models.vae import make_vae
from lvae_torch.ops import kernels as kx
from lvae_torch.train import standard as ts

P, T, L, M, NS = 5, 3, 2, 6, 2
SPEC = dict(cat_kernel=[2], sqexp_kernel=[0],
            cat_int_kernel=[{"cont_covariate": 0, "cat_covariate": 2}], id_covariate=2)
# model: (type_nnet, features a frame)
MODELS = {"conv": ("conv", 36 * 36), "simple": ("simple", 12), "rnn": ("rnn", 12)}
# mode: (type_KL, loss_function)
MODES = {"dubo_mse": ("GPapprox_closed", "mse"), "gpapprox_nll": ("GPapprox", "nll")}


def trainer(model_name, mode):
    """A float64 GPPVAE trainer on 5 subjects × 3 frames."""
    kind, d = MODELS[model_name]
    type_kl, loss = MODES[mode]
    rng = np.random.default_rng(0)
    labels = np.asarray([[i + 0.3 * rng.uniform(), rng.normal(), s, s % 2]
                         for s in range(P) for i in range(T)])
    shape = (P * T, 36, 36, 1) if kind == "conv" else (P * T, d)
    ds = ArrayDataset(data=rng.uniform(size=shape), labels=labels,
                      mask=(rng.uniform(size=(P * T, d)) > 0.2).astype(np.float64))
    cfg = ts.StandardConfig(*kx.split_kernel_spec(**SPEC), latent_dim=L, P_tot=P, T=T,
                            weight=0.3, loss_function=loss, type_KL=type_kl, num_samples=NS,
                            constrain_scales=False, eps=1e-5, dropout=False)
    model = make_vae(kind, L, d, dropout=0.0, generator=torch.Generator().manual_seed(1),
                     dtype=torch.float64, T=T, hidden_dim=8)
    return ts.StandardTrainer(model, cfg, ds, build_subject_blocks(labels, 2), labels[:M],
                              seed=0, dtype=torch.float64, pseudo_minibatch=True,
                              device="cpu")


def step(tr, eps, gp_eps, by_subject):
    """One ``gppvae_grads`` from zero gradients: its metrics, gradients, and
    the rows of each call of ``encode`` and ``decode``. ``by_subject`` runs
    each call on one subject's T frames at a time."""
    tables = tr.state.trainables
    for p in tables.parameters():
        p.grad = None
    rows = {"encode": [], "decode": []}
    real = {name: getattr(tr.model, name) for name in rows}

    def counted(name):
        def call(x):
            rows[name].append(x.shape[0])
            if not by_subject:
                return real[name](x)
            parts = [real[name](x[i:i + T]) for i in range(0, x.shape[0], T)]
            if isinstance(parts[0], tuple):
                return tuple(torch.cat(c) for c in zip(*parts))
            return torch.cat(parts)
        return call

    for name in rows:
        setattr(tr.model, name, counted(name))
    try:
        metrics = ts.gppvae_grads(tr.model, tr.cfg, tables, tr.tdata, tr.block_mask,
                                  eps=eps, gp_eps=gp_eps)
    finally:
        for name in rows:
            delattr(tr.model, name)
    grads = [None if p.grad is None else p.grad.clone() for p in tables.parameters()]
    return metrics, grads, rows


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("model_name", sorted(MODELS))
def test_one_replay_pass_equals_the_per_subject_replays(model_name, mode):
    tr = trainer(model_name, mode)
    gen = torch.Generator().manual_seed(3)
    eps = torch.randn(P * T, L, generator=gen, dtype=torch.float64)
    gp_eps = torch.randn(NS, P, T, L, generator=gen, dtype=torch.float64)
    got_m, got_g, got_rows = step(tr, eps, gp_eps, by_subject=False)
    assert got_rows == {"encode": [P * T, P * T], "decode": [P * T]}
    want_m, want_g, _ = step(tr, eps, gp_eps, by_subject=True)
    assert any(g is not None for g in got_g)
    for g, w in zip(got_g, want_g):
        if w is None:
            assert g is None
            continue
        gap, norm = (g - w).norm().item(), w.norm().item()
        assert gap <= 1e-10 * norm, (gap, norm)
    for a, b in zip(got_m, want_m):
        np.testing.assert_allclose(a.item(), b.item(), rtol=1e-10)
