"""Standalone VAE pre-training with a standard-normal latent prior (port of
lvae_tpu.train.pretrain).

Adam (lr 1e-3, optax's form) on ``Σ(recon|nll + KL(q‖N(0, I)))`` over
shuffled batches of ``min(N, 256)`` frames (for an RNN encoder, whole
subjects, rounded down to a multiple of T), the ragged tail dropped; the
trained weights seed an L-VAE run.

The trainer runs the epoch program of ``train/loop.py`` (the JAX package's
``make_pretrain_epoch_fn``): an epoch draws its permutation, then each
step's reparameterisation noise, from a CPU ``torch.Generator`` seeded from
``seed`` (or takes them injected). Every batch has one shape, so on the
card the step is captured once as a CUDA graph and replayed. Unlike the
other trainers, ``fit`` reads each chunk before it dispatches the next
(``OVERLAP``), as the JAX package's does. Dropout, where on, draws its
masks from torch's own generator, as in the trainers.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from lvae_torch.models import vae as mv
from lvae_torch.train.loop import EpochProgram
from lvae_torch.train.state import make_optimizer, zero_missing_grads
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
    kld_i = std_normal_kld(mu, log_var)  # in the moments' dtype, as the JAX package's
    rec_i = nll_i if loss_function == "nll" else mse_i
    loss = torch.sum(rec_i + kld_i)
    return loss, torch.stack([loss.detach(), mse_i.sum().detach(), nll_i.sum().detach(),
                              kld_i.sum().detach()])


class VAEPretrainer(EpochProgram):
    """The pre-training loop. ``model`` is a port VAE carrying its initial
    weights; ``dataset`` any object with numpy ``data [N, ...]`` and
    ``mask [N, D]``. ``device`` is ``"cuda"`` unless the caller asks for the
    CPU."""

    # "Average loss" is the raw epoch sum, as the reference prints it
    LOG = ("====> Epoch: {epoch} - Average loss: {m.loss:.4f}  - KLD loss: {m.kld:.3f}"
           "  - NLL loss: {m.nll:.3f}  - Recon loss: {m.recon:.3f}")
    OVERLAP = False

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
        self.dtype = dtype
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
        self._out_shape = (self.n // self.batch_size, 4)
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

    def _step(self, rows: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
        """The step function on device buffers: Adam on the batch of frame
        ``rows [B]`` with noise ``eps [B, L]``, in place; returns its
        ``[loss, recon, nll, kld]``. Safe to capture."""
        opt = self.state.opt_state
        opt.zero_grad(set_to_none=True)
        loss, metrics = pretrain_loss(self.model, self.data[rows], self.pixmask[rows], eps,
                                      self.loss_function, self.dropout, self.vy_fixed)
        loss.backward()
        zero_missing_grads(self.model.parameters())  # a frozen raw_log_vy
        opt.step()
        return metrics

    def _epoch_specs(self) -> List[Tuple[tuple, torch.dtype]]:
        """An epoch's batches of frame rows ``[n_batches, B]`` and their
        noise ``[n_batches, B, L]``."""
        nb, b = self._out_shape[0], self.batch_size
        return [((nb, b), torch.int64), ((nb, b, self.model.latent_dim), self.dtype)]

    def _draw(self, e: int, inputs: List[torch.Tensor], order=None, eps=None) -> None:
        """Epoch ``e``'s permutation, then one ``randn`` a step; ``order``
        ``[n_batches, B]`` and ``eps`` ``[n_batches, B, L]`` replace them."""
        rows, noise = inputs
        rows.copy_(self.epoch_order() if order is None else torch.as_tensor(order))
        for j, x in enumerate(noise):
            if eps is None:
                x.normal_(generator=self.state.rng)  # torch.randn's draw
            else:
                x.copy_(torch.as_tensor(eps[j]))

    def _epoch(self, inputs: List[torch.Tensor], out: torch.Tensor) -> None:
        rows, noise = inputs
        for j in range(rows.shape[0]):
            self._run_step(rows[j], noise[j], out[j])

    def _reduce(self, host: torch.Tensor, n: int) -> List[PretrainMetrics]:
        """Each epoch's sums over its steps, added in step order."""
        return [PretrainMetrics(*functools.reduce(torch.add, host[e]).tolist())
                for e in range(n)]

    def run_epoch(self, order: Optional[torch.Tensor] = None,
                  eps: Optional[torch.Tensor] = None) -> PretrainMetrics:
        """One epoch; returns its summed metrics as host floats. ``order``
        (``[n_batches, B]`` rows) and ``eps`` (``[n_batches, B, L]``)
        replace the drawn permutation and noise."""
        return self._run_one(lambda e, inputs: self._draw(e, inputs, order, eps))
