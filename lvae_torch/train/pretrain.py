"""Standalone VAE pre-training with a standard-normal latent prior (port of
lvae_tpu.train.pretrain).

Adam (lr 1e-3, optax's form) on ``Σ(recon|nll + KL(q‖N(0, I)))`` over
shuffled batches of ``min(N, 256)`` frames (for an RNN encoder, whole
subjects, rounded down to a multiple of T), the ragged tail dropped; the
trained weights seed an L-VAE run. An epoch is a Python loop of steps.

The epoch's permutation and each step's reparameterisation noise are drawn
from a CPU ``torch.Generator`` seeded from ``seed`` and moved to the device
(or injected), so the card and the CPU consume the same numbers. Dropout,
where on, draws its masks from torch's own generator, as in the trainers.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from lvae_torch.models import vae as mv
from lvae_torch.train.state import make_optimizer
from lvae_torch.utils.device import resolve_device


class PretrainState(NamedTuple):
    model: nn.Module
    opt_state: torch.optim.Optimizer
    rng: torch.Generator  # on the CPU
    step: int


class PretrainMetrics(NamedTuple):
    loss: float
    recon: float
    nll: float
    kld: float


def std_normal_kld(mu: torch.Tensor, log_var: torch.Tensor) -> torch.Tensor:
    """Per-sample analytic KL(q‖N(0, I))."""
    return -0.5 * torch.sum(1.0 + log_var - mu * mu - torch.exp(log_var), dim=1)


def pretrain_loss(model: nn.Module, x, pixmask, eps, loss_function: str,
                  dropout: bool, vy_fixed: bool = False):
    """One batch's summed loss and its metrics ``(loss, recon, nll, kld)``
    as device scalars; ``eps`` is the reparameterisation noise ``[B, L]``."""
    model.train(dropout)
    mu, log_var = model.encode(x)
    recon = model.decode(mu + eps.to(mu.device, mu.dtype) * torch.exp(0.5 * log_var))
    raw_log_vy = model.raw_log_vy.detach() if vy_fixed else model.raw_log_vy
    mse_i, nll_i = mv.vae_loss(raw_log_vy, recon, x, pixmask)
    kld_i = std_normal_kld(mu, log_var)
    rec_i = nll_i if loss_function == "nll" else mse_i
    loss = torch.sum(rec_i + kld_i)
    return loss, torch.stack([loss.detach(), mse_i.sum().detach(), nll_i.sum().detach(),
                              kld_i.sum().detach()])


class VAEPretrainer:
    """The pre-training loop. ``model`` is a port VAE carrying its initial
    weights; ``dataset`` any object with numpy ``data [N, ...]`` and
    ``mask [N, D]``. ``device`` is ``"cuda"`` unless the caller asks for the
    CPU."""

    def __init__(
        self,
        model: nn.Module,
        dataset,
        loss_function: str = "nll",
        learning_rate: float = 1e-3,
        dropout: bool = True,
        seed: int = 0,
        batch_size: int = 256,
        dtype=torch.float32,
        vy_fixed: bool = False,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.model = model.to(device=self.device, dtype=dtype)
        self.loss_function = loss_function
        self.dropout = dropout
        self.vy_fixed = vy_fixed
        self.data = torch.as_tensor(np.asarray(dataset.data), dtype=dtype, device=self.device)
        self.pixmask = torch.as_tensor(np.asarray(dataset.mask), dtype=dtype,
                                       device=self.device)
        self.n = len(dataset)
        self.batch_size = min(self.n, batch_size)
        # a recurrent encoder consumes whole subject sequences: batches are
        # subject-major multiples of T
        self.seq_len = int(getattr(model, "T", 0) or 0)
        if self.seq_len:
            if self.n % self.seq_len:
                raise ValueError(
                    f"RNN pre-training needs subject-major data with N divisible by "
                    f"T={self.seq_len}; got N={self.n}")
            self.batch_size = max(self.seq_len, self.batch_size // self.seq_len * self.seq_len)
        params = list(self.model.parameters())
        for p in params:
            p.requires_grad_(True)
        self.state = PretrainState(
            model=self.model, opt_state=make_optimizer(params, learning_rate, kind="adam"),
            rng=torch.Generator().manual_seed(seed), step=0,
        )
        self.history: List[PretrainMetrics] = []

    @property
    def params(self) -> nn.Module:
        """The trained model (the JAX package's params tree)."""
        return self.state.model

    def epoch_order(self) -> torch.Tensor:
        """This epoch's batches ``[n_batches, batch_size]`` of frame rows: a
        permutation from the state's generator (of whole subjects for an
        RNN encoder), its ragged tail dropped."""
        n_batches = self.n // self.batch_size
        if self.seq_len:  # whole subjects, each a run of T consecutive rows
            subjects = torch.randperm(self.n // self.seq_len, generator=self.state.rng)
            perm = (subjects[:, None] * self.seq_len + torch.arange(self.seq_len)).reshape(-1)
        else:
            perm = torch.randperm(self.n, generator=self.state.rng)
        return perm[: n_batches * self.batch_size].reshape(n_batches, self.batch_size)

    def run_epoch(self, order: Optional[torch.Tensor] = None,
                  eps: Optional[torch.Tensor] = None) -> PretrainMetrics:
        """One epoch; returns its summed metrics as host floats. ``order``
        (``[n_batches, B]`` rows) and ``eps`` (``[n_batches, B, L]``)
        replace the drawn permutation and noise."""
        state = self.state
        if order is None:
            order = self.epoch_order()
        opt = state.opt_state
        params = list(self.model.parameters())
        sums = torch.zeros(4, dtype=self.data.dtype, device=self.device)
        for b, rows in enumerate(torch.as_tensor(order)):
            rows = rows.to(self.device)
            x, mk = self.data[rows], self.pixmask[rows]
            if eps is None:
                e = torch.randn((rows.shape[0], self.model.latent_dim), generator=state.rng,
                                dtype=self.data.dtype)
            else:
                e = eps[b]
            opt.zero_grad(set_to_none=True)
            loss, metrics = pretrain_loss(self.model, x, mk, e, self.loss_function,
                                          self.dropout, self.vy_fixed)
            loss.backward()
            for p in params:  # a frozen raw_log_vy advances Adam as in optax
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            opt.step()
            sums = sums + metrics
        self.state = state._replace(step=state.step + len(order))
        m = PretrainMetrics(*sums.tolist())
        self.history.append(m)
        return m

    def run_epochs(self, n: int) -> List[PretrainMetrics]:
        return [self.run_epoch() for _ in range(n)]

    def fit(self, epochs: int, log_every: int = 1, callback=None, chunk: int = 25):
        """Train ``epochs`` epochs, calling ``callback(trainer, done, last
        metrics)`` after every ``chunk`` epochs."""
        done = 0
        while done < epochs:
            n = min(max(chunk, 1), epochs - done)
            ms = self.run_epochs(n)
            for i, m in enumerate(ms):
                epoch = done + i + 1
                if log_every and epoch % log_every == 0:
                    # "Average loss" is the raw epoch sum, as the reference prints it
                    print(
                        "====> Epoch: %d - Average loss: %.4f  - KLD loss: %.3f"
                        "  - NLL loss: %.3f  - Recon loss: %.3f"
                        % (epoch, m.loss, m.kld, m.nll, m.recon),
                        flush=True,
                    )
            done += n
            if callback is not None:
                callback(self, done, ms[-1])
        return self.history
