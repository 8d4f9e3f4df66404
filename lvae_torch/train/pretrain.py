"""Standalone VAE pre-training with a standard-normal latent prior (port of
lvae_tpu.train.pretrain).

Adam (lr 1e-3, optax's form) on ``Σ(recon|nll + KL(q‖N(0, I)))`` over
shuffled batches of ``min(N, 256)`` frames (for an RNN encoder, whole
subjects, rounded down to a multiple of T), the ragged tail dropped; the
trained weights seed an L-VAE run.

The epoch program is the Hensman trainer's (``train/hensman.py``; the JAX
package's ``make_pretrain_epoch_fn``): a chunk's permutations and noise are
drawn on the host and copied to the device once, every step updates the
state in place, and the chunk's metrics are read once. Every batch has one
shape, so on the card the step is captured once as a CUDA graph
(``train/graph.CapturedStep``) and replayed; on the CPU it runs eagerly.
Assigning ``state`` drops the graph.

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
from lvae_torch.train.graph import (
    StepGraphs, finish_host_copy, route_key, run_chunks, run_staged, start_host_copy,
)
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
    kld_i = std_normal_kld(mu, log_var)  # in the moments' dtype, as the JAX package's
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
    def state(self) -> PretrainState:
        return self._state

    @state.setter
    def state(self, value: PretrainState) -> None:
        """A new state drops the captured step (it reads the old tensors)."""
        self._state = value
        self._graphs = StepGraphs()

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
        for p in self.model.parameters():  # a frozen raw_log_vy advances Adam as in optax
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        opt.step()
        return metrics

    def _run_step(self, rows: torch.Tensor, eps: torch.Tensor, out: torch.Tensor) -> None:
        # captured at the first batch of a shape and of the switches, which runs as the warm-up
        self._graphs.run((tuple(rows.shape), *route_key()), self._step, (rows, eps), out,
                         eager=self.device.type != "cuda")
        self._state = self._state._replace(step=self._state.step + 1)

    def _dispatch_epochs(self, n: int, order=None, eps=None):
        """Run an ``n``-epoch chunk; returns its per-step metrics
        ``[n, n_batches, 4]`` (on the card, their host copy in flight and the
        event that marks it done). The draws follow the steps' own order:
        per epoch the permutation, then one ``randn`` a step, staged on the
        host and copied to the card at once (``graph.run_staged``). ``order``
        ``[n, n_batches, B]`` and ``eps`` ``[n, n_batches, B, L]`` replace
        them."""
        n_batches, b, n_lat = self.n // self.batch_size, self.batch_size, self.model.latent_dim
        out = torch.empty((n, n_batches, 4), dtype=self.data.dtype, device=self.device)
        perm = None

        def fill(i: int, inputs) -> None:
            nonlocal perm
            e, j = divmod(i, n_batches)
            rows, noise = inputs
            if j == 0:
                perm = self.epoch_order() if order is None else torch.as_tensor(order[e])
            rows.copy_(perm[j])
            if eps is None:
                noise.normal_(generator=self.state.rng)  # torch.randn's draw
            else:
                noise.copy_(torch.as_tensor(eps[e][j]))

        run_staged(n * n_batches, [((b,), torch.int64), ((b, n_lat), self.data.dtype)], fill,
                   lambda i, inputs: self._run_step(*inputs, out.view(-1, 4)[i]), self.device)
        return start_host_copy(out)

    def _materialize_metrics(self, chunk, n: int) -> List[PretrainMetrics]:
        """Wait for a chunk's metrics; each epoch's sums over its steps,
        added in step order, as host floats (appended to ``history``)."""
        host = finish_host_copy(chunk)
        out = []
        for e in range(n):
            sums = host[e, 0]
            for row in host[e, 1:]:
                sums = sums + row
            m = PretrainMetrics(*sums.tolist())
            self.history.append(m)
            out.append(m)
        return out

    def run_epoch(self, order: Optional[torch.Tensor] = None,
                  eps: Optional[torch.Tensor] = None) -> PretrainMetrics:
        """One epoch; returns its summed metrics as host floats. ``order``
        (``[n_batches, B]`` rows) and ``eps`` (``[n_batches, B, L]``)
        replace the drawn permutation and noise."""
        chunk = self._dispatch_epochs(1, None if order is None else [order],
                                      None if eps is None else [eps])
        return self._materialize_metrics(chunk, 1)[0]

    def run_epochs(self, n: int) -> List[PretrainMetrics]:
        """``n`` epochs as one chunk; returns their metrics."""
        return self._materialize_metrics(self._dispatch_epochs(n), n)

    def fit(self, epochs: int, log_every: int = 1, callback=None, chunk: int = 25):
        """Train ``epochs`` epochs, calling ``callback(trainer, done, last
        metrics)`` after every ``chunk`` epochs."""
        def read(done: int, n: int, ms: List[PretrainMetrics]) -> None:
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
            if callback is not None:
                callback(self, done + n, ms[-1])

        run_chunks(epochs, chunk, self.run_epochs, read, overlap=False)
        return self.history
