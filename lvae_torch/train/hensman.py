"""Hensman/SVI training with natural gradients (port of lvae_tpu.train.hensman).

One step: a subject batch through the VAE and its masked reconstruction
loss, the GP operators (kernel K1 builds the per-subject B chain on the
card), the minibatch KL bound, one Adam step on the trainables and one
natural-gradient step on (m, H). The JAX package scans steps and epochs
inside one compiled program; here they are a Python loop.

* Fixed-T and ragged cohorts share one path through padded blocks and
  validity masks; ghost subjects pad the final batch, contribute exactly
  zero, and the true subject count drives the ``P_tot / P_batch`` scaling.
* Randomness (the subject permutation of each epoch and bucket, and the
  reparameterisation noise of each step) is drawn from a CPU
  ``torch.Generator`` seeded from ``seed`` and moved to the device, so a run
  on the card and one on the CPU consume the same numbers.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from lvae_torch.data import blocks as bk
from lvae_torch.models import vae as mv
from lvae_torch.ops import elbo as eb
from lvae_torch.ops import kernels as kx
from lvae_torch.train import state as st
from lvae_torch.utils.device import resolve_device


class HensmanConfig(NamedTuple):
    """Static configuration of the step."""

    spec0: kx.KernelSpec
    spec1: kx.KernelSpec
    latent_dim: int
    P_tot: int
    N_tot: int
    weight: float
    loss_function: str  # 'mse' | 'nll'
    natural_gradient: bool
    natural_gradient_lr: float
    constrain_scales: bool
    eps: float
    dropout: bool  # dropout in the training forward passes
    vy_fixed: bool = False  # freeze the observation noise
    learn_inducing: bool = False  # optimise the inducing points


class StepMetrics(NamedTuple):
    net: torch.Tensor
    recon: torch.Tensor
    nll: torch.Tensor
    kld: torch.Tensor


class BlockTable(NamedTuple):
    """Padded subject-block table on the run's device (P padded to a multiple
    of the batch size; ghost rows carry a zero mask)."""

    index: torch.Tensor  # [P_pad, T] int64
    mask: torch.Tensor  # [P_pad, T]
    num_real: int  # true subject count P


def build_block_table(blocks: bk.SubjectBlocks, subjects_per_batch: int,
                      dtype=torch.float32, device="cpu") -> BlockTable:
    """Pad the host block table to a batch multiple and move it to ``device``."""
    p = blocks.num_subjects
    s = subjects_per_batch
    p_pad = (p + s - 1) // s * s
    index = np.zeros((p_pad, blocks.t_max), np.int64)
    mask = np.zeros((p_pad, blocks.t_max), np.float32)
    index[:p] = blocks.index
    mask[:p] = blocks.mask
    return BlockTable(
        index=torch.as_tensor(index, device=device),
        mask=torch.as_tensor(mask, dtype=dtype, device=device),
        num_real=p,
    )


def _noise_from(gp: st.GPParams, cfg: HensmanConfig) -> torch.Tensor:
    if cfg.constrain_scales:
        # likelihood noise pinned to 1; raw_noise never reaches the loss, so
        # its gradient is zero and Adam leaves it at its init
        return torch.ones_like(gp.raw_noise)
    return kx.constrain(gp.raw_noise)


def batch_loss(
    model,
    cfg: HensmanConfig,
    trainables: st.Trainables,
    m_nat: Optional[torch.Tensor],
    H_nat: Optional[torch.Tensor],
    tdata: st.TrainData,
    idx: torch.Tensor,  # [S, T] rows of tdata
    bmask: torch.Tensor,  # [S, T]
    p_batch: torch.Tensor,  # scalar: real subjects in the batch
    eps: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, Tuple[StepMetrics, Optional[eb.NaturalGradients]]]:
    """Net loss of one subject batch, differentiable in the trainables.

    ``eps [S·T, L]`` is the reparameterisation noise; when it is None it is
    drawn from ``generator`` (a CPU generator) and moved to the device.
    Returns ``(net, (metrics, natural gradients or None))``.
    """
    s, t = idx.shape
    flat = idx.reshape(-1)
    x = tdata.data[flat]
    labels = tdata.labels[flat]
    pixmask = tdata.pixmask[flat]
    valid = bmask.reshape(-1)

    model.train(cfg.dropout)
    mu, log_var = model.encode(x)
    if eps is None:
        if generator is None:
            raise ValueError("batch_loss needs eps or a generator to draw it from")
        eps = torch.randn(mu.shape, generator=generator, dtype=mu.dtype)
    z_lat = mu + eps.to(mu.device, mu.dtype) * torch.exp(0.5 * log_var)
    recon = model.decode(z_lat)
    raw_log_vy = model.raw_log_vy.detach() if cfg.vy_fixed else model.raw_log_vy
    mse_i, nll_i = mv.vae_loss(raw_log_vy, recon, x, pixmask)
    recon_loss = torch.sum(mse_i * valid)
    nll_loss = torch.sum(nll_i * valid)

    gp = trainables.gp
    noise = _noise_from(gp, cfg)
    z_pts = trainables.z if (cfg.learn_inducing and trainables.z is not None) else tdata.z
    xb = (labels * valid[:, None]).reshape(s, t, -1)
    mu_b = mu.reshape(s, t, cfg.latent_dim)
    lv_b = log_var.reshape(s, t, cfg.latent_dim)
    if cfg.natural_gradient:
        m_var, psd_h = m_nat, H_nat
    else:
        m_var = trainables.m
        psd_h = st.psd_from_factor(trainables.h_factor)

    # K0zz and H factor in one stacked call
    ops = eb.gp_block_operators(
        cfg.spec0, cfg.spec1, gp.kp0, gp.kp1, noise, xb, z_pts,
        mask=bmask, eps=cfg.eps, extra_spd=psd_h,
    )
    kld, ng = eb.minibatch_kld(
        ops, m_var, psd_h, mu_b, lv_b,
        P_tot=cfg.P_tot, P_batch=p_batch, N_tot=cfg.N_tot,
        natural_gradient=cfg.natural_gradient,
        H_factor=(ops.extra_chol, ops.extra_inv),
    )

    scale = cfg.P_tot / p_batch.to(recon_loss.dtype)
    recon_loss = recon_loss * scale
    nll_loss = nll_loss * scale
    if cfg.loss_function == "nll":
        net = nll_loss + kld
        kld_rep = kld
    else:
        kld_rep = kld / cfg.latent_dim
        net = recon_loss + cfg.weight * kld_rep
    metrics = StepMetrics(
        net=net.detach(), recon=recon_loss.detach(), nll=nll_loss.detach(),
        kld=kld_rep.detach(),
    )
    return net, (metrics, ng)


class HensmanTrainer:
    """Epochs of Hensman training on one device.

    ``model`` is a port VAE (``models/vae.make_vae``) carrying its initial
    weights; ``dataset`` any object with numpy ``data [N, ...]``,
    ``labels [N, Q]`` and ``mask [N, D]``; ``blocks`` its
    ``data/blocks.SubjectBlocks``; ``z [M, Q]`` the inducing points. The GP
    hyperparameters and (m, H) are initialised as the JAX package does, from
    ``seed``. ``device`` is ``"cuda"`` unless the caller asks for the CPU.
    """

    def __init__(
        self,
        model,
        cfg: HensmanConfig,
        dataset,
        blocks: bk.SubjectBlocks,
        z: np.ndarray,
        subjects_per_batch: int,
        learning_rate: float = 1e-3,
        seed: int = 0,
        dtype=torch.float32,
        t_buckets: int = 1,
        device="cuda",
    ):
        t_model = int(getattr(model, "T", 0) or 0)
        lens = np.unique(np.asarray(blocks.t_lens))
        if t_model and (lens.size != 1 or int(lens[0]) != t_model):
            # the recurrence has no validity mask: a short subject's padded
            # slots would carry row 0's frames into its real timesteps
            raise ValueError(
                f"RNN encoder (T={t_model}) requires a fixed-T cohort with exactly T rows per "
                f"subject; got subject lengths {sorted(set(lens.tolist()))}. Use the MLP/conv "
                "encoders for ragged (varying_T) cohorts.")
        self.device = resolve_device(device)
        self.model = model.to(device=self.device, dtype=dtype)
        self.cfg = cfg
        self.blocks = blocks
        self.subjects_per_batch = subjects_per_batch
        self.learning_rate = learning_rate
        self.dtype = dtype
        bucket_blocks = bk.bucket_subject_blocks(blocks, t_buckets) if t_buckets > 1 else [blocks]
        self.tables = tuple(
            build_block_table(b, subjects_per_batch, dtype, self.device) for b in bucket_blocks
        )

        def dev(a):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

        self.tdata = st.TrainData(
            data=dev(dataset.data), labels=dev(dataset.labels),
            pixmask=dev(dataset.mask), z=dev(z),
        )

        gp = st.init_gp_params(
            cfg.spec0, cfg.spec1, cfg.latent_dim,
            constrain_scales=cfg.constrain_scales, dtype=dtype, device=self.device,
        )
        m0, h0 = st.init_variational(
            cfg.latent_dim, z.shape[0], cfg.natural_gradient, seed, dtype, self.device
        )
        z_train = self.tdata.z.clone() if cfg.learn_inducing else None
        if cfg.natural_gradient:
            trainables = st.Trainables(vae=self.model, gp=gp, m=None, h_factor=None, z=z_train)
            m_nat, H_nat = m0, h0
        else:
            trainables = st.Trainables(vae=self.model, gp=gp, m=m0, h_factor=h0, z=z_train)
            m_nat = H_nat = None
        for p in trainables.parameters():
            p.requires_grad_(True)
        self.state = st.HensmanState(
            trainables=trainables,
            m_nat=m_nat,
            H_nat=H_nat,
            opt_state=st.make_optimizer(trainables.parameters(), learning_rate),
            rng=torch.Generator().manual_seed(seed),
            step=0,
        )
        self.history: list = []

    # ------------------------------------------------------------- one step
    def train_step(self, table: BlockTable, order_rows: torch.Tensor,
                   eps: Optional[torch.Tensor] = None) -> StepMetrics:
        """One step on the batch of table rows ``order_rows [S]`` (rows at
        or past ``table.num_real`` are ghosts): Adam on the trainables, then
        the natural-gradient update of (m, H). ``eps [S·T, L]`` is drawn from
        the state's generator when not given. Returns device metrics."""
        state = self.state
        order_rows = order_rows.to(self.device)
        b_idx = table.index[order_rows]
        b_mask = table.mask[order_rows]
        p_batch = torch.sum(order_rows < table.num_real).to(b_mask.dtype)
        opt = state.opt_state
        opt.zero_grad(set_to_none=True)
        net, (metrics, ng) = batch_loss(
            self.model, self.cfg, state.trainables, state.m_nat, state.H_nat,
            self.tdata, b_idx, b_mask, p_batch, eps=eps, generator=state.rng,
        )
        net.backward()
        params = list(state.trainables.parameters())
        for p in params:
            # a trainable the loss does not reach (raw_noise under
            # constrain_scales) gets a zero gradient, as in optax: its Adam
            # moments and step count advance with the others
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        opt.step()
        m_nat, H_nat = state.m_nat, state.H_nat
        if self.cfg.natural_gradient:
            m_nat, H_nat = eb.natural_gradient_update(
                m_nat, H_nat, ng, self.cfg.natural_gradient_lr
            )
        if self.cfg.learn_inducing and state.trainables.z is not None:
            self.tdata = self.tdata._replace(z=state.trainables.z.detach())
        self.state = state._replace(m_nat=m_nat, H_nat=H_nat, step=state.step + 1)
        return metrics

    # --------------------------------------------------------------- epochs
    def _epoch_order(self, table: BlockTable) -> torch.Tensor:
        """This epoch's batches of table rows ``[n_batches, S]``: a
        permutation of the real subjects from the state's generator, then
        the ghost rows."""
        p_pad = table.index.shape[0]
        perm = torch.randperm(table.num_real, generator=self.state.rng)
        perm = torch.cat([perm, torch.arange(table.num_real, p_pad)])
        return perm.reshape(p_pad // self.subjects_per_batch, self.subjects_per_batch)

    def run_epoch(self, order: Optional[Sequence] = None) -> StepMetrics:
        """One epoch over every bucket; returns the epoch's mean metrics as
        host floats. ``order`` (one ``[n_batches, S]`` array of table rows per
        bucket) replaces the drawn permutations."""
        step_ms: List[StepMetrics] = []
        for b, table in enumerate(self.tables):
            rows = self._epoch_order(table) if order is None else torch.as_tensor(order[b])
            for batch in rows:
                step_ms.append(self.train_step(table, batch))
        mean = torch.stack([torch.stack(m) for m in step_ms]).mean(0).tolist()
        m = StepMetrics(*mean)
        self.history.append(m)
        return m

    def run_epochs(self, n: int) -> List[StepMetrics]:
        """Run ``n`` epochs; returns their metrics."""
        return [self.run_epoch() for _ in range(n)]

    def _log_chunk(self, ms, done: int, epochs: int, log_every: int):
        for i, m in enumerate(ms):
            epoch = done + i + 1
            if log_every and (epoch % log_every == 0):
                print(
                    "Iter %d/%d - Loss: %.3f  - GP loss: %.3f"
                    "  - NLL Loss: %.3f  - Recon Loss: %.3f"
                    % (epoch, epochs, m.net, m.kld, m.nll, m.recon),
                    flush=True,
                )

    def fit(self, epochs: int, log_every: int = 1, callback=None, chunk: int = 25):
        """Train ``epochs`` epochs, calling ``callback(trainer, done, last
        metrics)`` after every ``chunk`` epochs. A callback that returns
        ``"rollback"`` has restored an earlier state: the chunk's epochs are
        then run again, so the run trains as many epochs as it reports."""
        done = 0
        while done < epochs:
            n = min(max(chunk, 1), epochs - done)
            ms = self.run_epochs(n)
            self._log_chunk(ms, done, epochs, log_every)
            done += n
            if callback is not None and callback(self, done, ms[-1]) == "rollback":
                done -= n
        return self.history
