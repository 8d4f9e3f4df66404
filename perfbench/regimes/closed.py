"""The standard regime with the closed KL: every subject in one full-batch
step, the exact N×N KL against the whole additive prior, Adam
(``lvae_torch.train.standard.StandardTrainer``)."""

from __future__ import annotations

import contextlib

import torch

from perfbench import counts, parts
from perfbench.reference import steps as rs

WARM_EPOCHS = 1  # its step captures the step
COMPARED_EPOCHS = 3
reference = rs.closed_steps


def step_flops(cfg: dict) -> float:
    return counts.closed_step_flops(cfg)


def inputs(maker, cfg: dict, data: dict) -> None:
    pass


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
        None, dtype=dtype, learning_rate=cfg["learning_rate"], seed=seed, device=device)


def trained(trainer) -> dict:
    return parts.leaves(trainer.state.trainables)


def steps_of(trainer, epochs: int) -> list:
    return trainer.history[-epochs:]


def steps_per_epoch(trainer) -> int:
    return 1


@contextlib.contextmanager
def half_batch(replay_only: bool):
    from lvae_torch.train import standard

    real = standard.full_batch_loss

    def loss(model, cfg, trainables, tdata, block_mask, *args, **kwargs):
        if replay_only and not torch.cuda.is_current_stream_capturing():
            return real(model, cfg, trainables, tdata, block_mask, *args, **kwargs)
        kept = block_mask.clone()
        kept[kept.shape[0] // 2:] = 0.0
        net, metrics = real(model, cfg, trainables, tdata, kept, *args, **kwargs)
        return 2.0 * net, metrics._replace(net=2.0 * metrics.net)

    standard.full_batch_loss = loss
    try:
        yield
    finally:
        standard.full_batch_loss = real
