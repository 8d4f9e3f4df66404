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
Under a ``compute_dtype`` (``models/vae.py``) the dense layers and the
recurrence compute in it, the parameters keep their type.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
from torch import nn

from lvae_torch.models.vae import _vy_init_raw, layer, mlp_decode, sample_latent
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


@functools.lru_cache(maxsize=None)
def cudnn_layout(type_rnn: str, hidden_dim: int, dtype: torch.dtype,
                 device: torch.device) -> Tuple[Tuple[int, ...], int]:
    """Where cuDNN keeps the weights of a bidirectional one-layer cell of
    width ``hidden_dim`` in ``dtype`` on ``device``: each weight's offset in
    elements (in ``_flat_weights`` order) and the buffer's length. Read from
    ``torch._cudnn_rnn_flatten_weight``, the call of
    ``nn.LSTM.flatten_parameters``, which skips bf16 weights itself."""
    from torch.backends.cudnn import rnn as cudnn_rnn

    cell = RNN_CELLS[type_rnn](hidden_dim, hidden_dim, batch_first=True, bidirectional=True,
                               device="meta")
    flat = [torch.empty(w.shape, device=device, dtype=dtype) for w in cell._flat_weights]
    with torch.no_grad():
        buf = torch._cudnn_rnn_flatten_weight(
            flat, 4, hidden_dim, cudnn_rnn.get_cudnn_mode(cell.mode), hidden_dim, 0, 1, True,
            True)
    size = buf.element_size()
    return tuple((w.data_ptr() - buf.data_ptr()) // size for w in flat), buf.numel()


def cast_flat_weights(flat: list, dtype: torch.dtype, layout=None) -> list:
    """The recurrence's weights (``_flat_weights``, in their order) cast to
    ``dtype`` as views of one buffer laid out as ``layout`` says
    (:func:`cudnn_layout`; None: one after another): cuDNN reads such a
    buffer in place, where it copies separately cast weights into one at
    every call."""
    sizes = [w.numel() for w in flat]
    if layout is None:
        offsets = [sum(sizes[:i]) for i in range(len(flat))]
        length = sum(sizes)
    else:
        offsets, length = layout
    pieces, end = [], 0
    for off, w in sorted(zip(offsets, flat), key=lambda p: p[0]):
        if off > end:
            pieces.append(w.new_zeros(off - end))
        pieces.append(w.reshape(-1))
        end = off + w.numel()
    if length > end:
        pieces.append(flat[0].new_zeros(length - end))
    buf = torch.cat(pieces).to(dtype)
    return [buf[o:o + n].view_as(w) for o, n, w in zip(offsets, sizes, flat)]


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
        compute_dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        if type_rnn not in RNN_CELLS:
            raise ValueError(f"Unknown type_rnn {type_rnn!r}")
        self.latent_dim = latent_dim
        self.num_dim = num_dim
        self.T = T
        self.hidden_dim = hidden_dim
        self.type_rnn = type_rnn
        self.compute_dtype = compute_dtype
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
                # moves with the module, so that the hook reads it on the
                # gradient's device (a copy there would break a CUDA graph's
                # capture); not in the state_dict
                self.register_buffer(f"pin_mask_{name}", mask.to(dtype), persistent=False)
        self._pin_biases()

    def _pin_biases(self) -> None:
        """Zero the gradient of the pinned bias entries (once a tensor)."""
        for name in pinned_bias_mask(self.type_rnn, self.hidden_dim):
            bias = getattr(self.rnn, name)
            if not getattr(bias, "_pinned", False):
                bias.register_hook(lambda g, n=name: g * getattr(self, f"pin_mask_{n}"))
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
        cd = self.compute_dtype
        with full_precision():
            seq = x.reshape(n // self.T, self.T, -1)
            h = torch.tanh(layer(self.embed, seq, cd))
            out = self._recurrence(h)  # [S, T, 2H]: forward, then backward in forward order
            h = (out[..., :self.hidden_dim] + out[..., self.hidden_dim:]).reshape(n, -1)
            return layer(self.fc_mu, h, cd), layer(self.fc_lv, h, cd)

    def _recurrence(self, h: torch.Tensor) -> torch.Tensor:
        """Both directions over ``h [S, T, H]``. In a compute dtype the cell
        runs on a copy of the weights in that dtype (the hooks act on the
        parameters, which the gradients reach through the cast), by the call
        ``nn.LSTM``/``nn.GRU.forward`` makes; its carry is in that dtype
        too, where flax's cells keep theirs in f32 (the measured gap of both
        against the JAX package is in PERF.md)."""
        cd = self.compute_dtype
        if cd is None:
            return self.rnn(h)[0]
        flat = self.rnn._flat_weights
        layout = (cudnn_layout(self.type_rnn, self.hidden_dim, cd, h.device)
                  if h.is_cuda and torch.backends.cudnn.enabled else None)
        weights = cast_flat_weights(flat, cd, layout)
        h0 = h.new_zeros((2, h.shape[0], self.hidden_dim))
        if self.type_rnn == "lstm":
            fn, hx = torch._VF.lstm, (h0, h0)
        else:
            fn, hx = torch._VF.gru, h0
        # (input, hx, weights, has_biases, num_layers, dropout, train,
        # bidirectional, batch_first)
        return fn(h, hx, weights, True, 1, 0.0, torch.is_grad_enabled(), True, True)[0]

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """latents ``[N, L]`` → frames ``[N, num_dim]``."""
        return mlp_decode(self, z)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        mu, log_var = self.encode(x)
        z = mu if generator is None else sample_latent(mu, log_var, generator)
        return self.decode(z), mu, log_var
