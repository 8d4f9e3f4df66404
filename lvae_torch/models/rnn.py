"""Recurrent VAE encoder family (port of lvae_tpu.models.rnn).

A subject's time series ``[S, T, D]`` goes through a dense embedding with
tanh, then an LSTM or GRU in each time direction; at position t the forward
state over frames 0..t and the backward state over frames t..T-1 are
summed, and two dense heads give the per-frame (mu, log_var). The decoder
is an MLP, latent → 30 → 300 → num_dim with a sigmoid. Inputs arrive flat
``[S·T, ...]`` in subject-major order, and the model reshapes by its ``T``.

The two directions are one ``bidirectional`` ``nn.LSTM``/``nn.GRU``: its
output's second half is the reversed pass already put back in forward time
order, which is what the JAX package's ``keep_order=True`` pass gives.

torch's cells carry two bias vectors where flax's carry one: the LSTM's
input-side bias (flax's input kernels have none) and the GRU's hidden-side
r and z biases add to another bias of the same gate. Those entries are
pinned at zero: a gradient hook zeroes their gradient, so Adam, from zero
moments, never moves them, and the model has the JAX model's parameters.
A copy of the module (``copy.deepcopy`` drops tensor hooks) gets its hooks
again at its first ``encode``.
The encoder runs under ``full_precision()``; on the card cuDNN runs the
recurrence, and its gradient pass follows ``torch.backends.cudnn.allow_tf32``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from lvae_torch.models.vae import _vy_init_raw, sample_latent
from lvae_torch.ops.linalg import full_precision

RNN_CELLS = {"lstm": nn.LSTM, "gru": nn.GRU}


def pinned_bias_mask(type_rnn: str, hidden_dim: int) -> dict:
    """``{bias name: 0/1 mask}`` of the torch biases flax's cells lack
    (0 where the entry is pinned at zero), for both directions."""
    h = hidden_dim
    if type_rnn == "lstm":
        masks = {"bias_ih": torch.zeros(4 * h)}
    else:
        masks = {"bias_hh": torch.cat([torch.zeros(2 * h), torch.ones(h)])}
    return {f"{name}_l0{sfx}": m for name, m in masks.items() for sfx in ("", "_reverse")}


class RNNVAE(nn.Module):
    """Bidirectional LSTM/GRU encoder and MLP decoder; flat batches must be
    subject-major with a row count divisible by ``T``."""

    is_conv = False

    def __init__(
        self,
        latent_dim: int,
        num_dim: int,
        T: int,
        hidden_dim: int = 64,
        type_rnn: str = "lstm",
        vy_init: float = 1.0,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if type_rnn not in RNN_CELLS:
            raise ValueError(f"Unknown type_rnn {type_rnn!r}")
        self.latent_dim = latent_dim
        self.num_dim = num_dim
        self.T = T
        self.hidden_dim = hidden_dim
        self.type_rnn = type_rnn
        kw = {"dtype": dtype}
        self.embed = nn.Linear(num_dim, hidden_dim, **kw)
        self.rnn = RNN_CELLS[type_rnn](hidden_dim, hidden_dim, batch_first=True,
                                       bidirectional=True, **kw)
        self.fc_mu = nn.Linear(hidden_dim, latent_dim, **kw)
        self.fc_lv = nn.Linear(hidden_dim, latent_dim, **kw)
        self.fc3 = nn.Linear(latent_dim, 30, **kw)
        self.fc31 = nn.Linear(30, 300, **kw)
        self.fc4 = nn.Linear(300, num_dim, **kw)
        self.raw_log_vy = nn.Parameter(_vy_init_raw(vy_init, num_dim, dtype))
        with torch.no_grad():
            for name, mask in pinned_bias_mask(type_rnn, hidden_dim).items():
                getattr(self.rnn, name).mul_(mask.to(dtype))
        self._pin_biases()

    def _pin_biases(self) -> None:
        """Zero the gradient of the pinned bias entries (once a tensor)."""
        for name, mask in pinned_bias_mask(self.type_rnn, self.hidden_dim).items():
            bias = getattr(self.rnn, name)
            if not getattr(bias, "_pinned", False):
                bias.register_hook(lambda g, m=mask: g * m.to(g.device, g.dtype))
                bias._pinned = True

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """flat frames ``[S·T, ...]`` → (mu, log_var), each ``[S·T, L]``."""
        n = x.shape[0]
        if n % self.T:
            raise ValueError(
                f"RNN encoder needs subject-major batches divisible by T={self.T}; got {n}")
        self._pin_biases()
        # the recurrence has no dropout, so its mode changes no value; but
        # cuDNN differentiates only a forward run in training mode
        self.rnn.train(torch.is_grad_enabled())
        with full_precision():
            seq = x.reshape(n // self.T, self.T, -1)
            h = torch.tanh(self.embed(seq))
            out, _ = self.rnn(h)  # [S, T, 2H]: forward, then backward in forward order
            h = (out[..., :self.hidden_dim] + out[..., self.hidden_dim:]).reshape(n, -1)
            return self.fc_mu(h), self.fc_lv(h)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """latents ``[N, L]`` → frames ``[N, num_dim]``."""
        with full_precision():
            h = F.relu(self.fc31(F.relu(self.fc3(z))))
            return torch.sigmoid(self.fc4(h))

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        mu, log_var = self.encode(x)
        z = mu if generator is None else sample_latent(mu, log_var, generator)
        return self.decode(z), mu, log_var
