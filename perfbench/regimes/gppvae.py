"""The GPPVAE pseudo-minibatch regime: every subject in one step of five
phases (a no-grad encode of the cohort, the inducing-point DUBO on the
detached moments, its gradient, one encoder replay a subject that splices
that gradient in, Adam), which with a deterministic encoder gives the
full-batch gradient (``lvae_torch.train.standard.StandardTrainer`` with
``pseudo_minibatch=True``, its step ``standard.gppvae_grads``)."""

from __future__ import annotations

import contextlib

import torch

from perfbench import parts
from perfbench.counts.gppvae import step_flops  # noqa: F401
from perfbench.reference import gppvae as ref
from perfbench.regimes.closed import steps_of, steps_per_epoch, trained  # noqa: F401

WARM_EPOCHS = 1  # its step captures the step
COMPARED_EPOCHS = 3
reference = ref.gppvae_steps


def inputs(maker, cfg: dict, data: dict) -> None:
    data["z"] = maker.inducing(data["labels"], cfg["M"])


def build(cfg: dict, data: dict, model, seed: int, device, dtype):
    from lvae_torch.data.blocks import build_subject_blocks
    from lvae_torch.train.standard import StandardConfig, StandardTrainer

    spec0, spec1 = parts.kernel_spec(cfg)
    scfg = StandardConfig(
        spec0=spec0, spec1=spec1, latent_dim=cfg["latent_dim"], P_tot=cfg["P"], T=cfg["T"],
        weight=cfg["weight"], loss_function=cfg["loss_function"], type_KL=cfg["type_KL"],
        num_samples=cfg["num_samples"], constrain_scales=cfg["constrain_scales"],
        eps=cfg["eps"], dropout=cfg["dropout"] > 0)
    return StandardTrainer(
        model, scfg, parts.Cohort(data), build_subject_blocks(data["labels"], cfg["id_covariate"]),
        data["z"], dtype=dtype, learning_rate=cfg["learning_rate"], seed=seed,
        pseudo_minibatch=True, device=device)


@contextlib.contextmanager
def half_batch(replay_only: bool):
    """The five phases on the first half of the subjects alone, each
    gradient and the loss doubled: the mean over the rest."""
    from lvae_torch.train import standard

    real = standard.gppvae_grads

    def grads(model, cfg, trainables, tdata, block_mask, eps=None, gp_eps=None):
        if replay_only and not torch.cuda.is_current_stream_capturing():
            return real(model, cfg, trainables, tdata, block_mask, eps=eps, gp_eps=gp_eps)
        half = block_mask.shape[0] // 2
        rows = half * block_mask.shape[1]
        kept = tdata._replace(data=tdata.data[:rows], labels=tdata.labels[:rows],
                              pixmask=tdata.pixmask[:rows])
        metrics = real(model, cfg, trainables, kept, block_mask[:half], eps=eps[:rows],
                       gp_eps=gp_eps)
        with torch.no_grad():
            for p in trainables.parameters():
                if p.grad is not None:
                    p.grad.mul_(2.0)
        return metrics._replace(**{k: 2.0 * v for k, v in metrics._asdict().items()})

    standard.gppvae_grads = grads
    try:
        yield
    finally:
        standard.gppvae_grads = real
