"""Hensman SVI: minibatches of subjects, the sparse KL against M inducing
points, Adam on the network and the GP hyperparameters, natural gradients on
q(u) = N(m, H⁻¹) (``lvae_torch.train.hensman.HensmanTrainer``)."""

from __future__ import annotations

import contextlib

import torch

from perfbench import counts, parts
from perfbench.reference import steps as rs

WARM_EPOCHS = 1  # its first step captures the step
COMPARED_EPOCHS = 1
reference = rs.hensman_steps


def step_flops(cfg: dict) -> float:
    return counts.hensman_step_flops(cfg)


def inputs(maker, cfg: dict, data: dict) -> None:
    data["z"] = maker.inducing(data["labels"], cfg["M"])


def build(cfg: dict, data: dict, model, seed: int, device, dtype):
    from lvae_torch.data.blocks import build_subject_blocks
    from lvae_torch.train.hensman import HensmanConfig, HensmanTrainer

    spec0, spec1 = parts.kernel_spec(cfg)
    hcfg = HensmanConfig(
        spec0=spec0, spec1=spec1, latent_dim=cfg["latent_dim"], P_tot=cfg["P"],
        N_tot=cfg["P"] * cfg["T"], weight=cfg["weight"], loss_function=cfg["loss_function"],
        natural_gradient=cfg["natural_gradient"],
        natural_gradient_lr=cfg["natural_gradient_lr"], constrain_scales=cfg["constrain_scales"],
        eps=cfg["eps"], dropout=cfg["dropout"] > 0)
    return HensmanTrainer(
        model, hcfg, parts.Cohort(data), build_subject_blocks(data["labels"], cfg["id_covariate"]),
        data["z"], subjects_per_batch=cfg["subjects_per_batch"], dtype=dtype,
        learning_rate=cfg["learning_rate"], seed=seed, device=device)


def trained(trainer) -> dict:
    st = trainer.state
    return {**parts.leaves(st.trainables), "m": st.m_nat, "H": st.H_nat}


def steps_of(trainer, epochs: int) -> list:
    return [m for m, _ in trainer.last_steps]


def steps_per_epoch(trainer) -> int:
    return trainer.steps_per_epoch


@contextlib.contextmanager
def half_batch(replay_only: bool):
    from lvae_torch.train.hensman import HensmanTrainer

    real = HensmanTrainer._step

    def step(self, table, rows, eps):
        if replay_only and not torch.cuda.is_current_stream_capturing():
            return real(self, table, rows, eps)
        half = rows.shape[0] // 2  # the loss is scaled by the subjects it sees
        return real(self, table, rows[:half], eps[: half * table.index.shape[1]])

    HensmanTrainer._step = step
    try:
        yield
    finally:
        HensmanTrainer._step = real
