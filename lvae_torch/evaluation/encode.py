"""Chunked dataset encoding and decoding (port of lvae_tpu.evaluation.encode).

A dataset is cut into fixed-size chunks of row indices, the tail padded with
row 0 (the JAX package's pad rule), and each chunk goes through the model in
``eval()`` mode without autograd; the input is in the parameters' dtype
and the model casts it to its compute dtype. Results come back to the host
as numpy in the parameters' dtype (a bf16 model's outputs upcast to f32:
numpy has no bfloat16); :func:`vae_forward` keeps its tensors on the
device, in the model's compute dtype.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from lvae_torch.utils.device import resolve_device


def _chunk_indices(n: int, batch_size: int) -> np.ndarray:
    bs = min(batch_size, n)
    n_chunks = (n + bs - 1) // bs
    pad = n_chunks * bs - n
    idx = np.concatenate([np.arange(n), np.zeros(pad, np.int64)])
    return idx.reshape(n_chunks, bs)


def _on(model: nn.Module, device) -> Tuple[nn.Module, torch.device]:
    dev = resolve_device(device)
    return model.to(dev).eval(), dev


@torch.inference_mode()
def vae_forward(model: nn.Module, x: torch.Tensor, eps: Optional[torch.Tensor] = None):
    """The full VAE forward in ``eval()`` mode without autograd:
    ``(reconstruction, mu, log_var)`` of the tensor ``x`` on the model's
    device. ``z = mu`` when ``eps`` is None, else the reparameterised
    sample ``mu + eps·exp(½ log_var)`` with the given noise ``[N, L]``."""
    model.eval()
    mu, log_var = model.encode(x)
    z = mu if eps is None else mu + eps.to(mu.device, mu.dtype) * torch.exp(0.5 * log_var)
    return model.decode(z), mu, log_var


@torch.inference_mode()
def encode_dataset(
    model: nn.Module, data, batch_size: int = 1000, device="cuda"
) -> Tuple[np.ndarray, np.ndarray]:
    """Encode every sample: ``(mu [N, L], log_var [N, L])``. For an RNN
    encoder the rows must be subject-major, N a multiple of its ``T``.

    The model is moved to ``device`` (in place, as ``nn.Module.to`` does)."""
    model, dev = _on(model, device)
    dtype = model.raw_log_vy.dtype
    data = np.asarray(data)
    n = data.shape[0]
    if n == 0:
        empty = np.zeros((0, model.latent_dim), np.float32)
        return empty, empty.copy()
    t = getattr(model, "T", None)
    if t:
        # a recurrent encoder consumes whole subject sequences: chunks are
        # multiples of T, and the row-0 tail padding forms whole fake
        # subjects that never mix into a real one's recurrence
        if n % t:
            raise ValueError(
                f"RNN encoder needs subject-major data with N divisible by T={t}; got N={n}")
        batch_size = max(t, min(batch_size, n) // t * t)
    idx = _chunk_indices(n, batch_size)
    x = torch.as_tensor(data, dtype=dtype, device=dev)
    mus, lvs = [], []
    for chunk in torch.from_numpy(idx).to(dev):
        mu, lv = model.encode(x[chunk])
        mus.append(mu)
        lvs.append(lv)
    mu = torch.cat(mus)[:n].to(dtype).cpu().numpy()
    lv = torch.cat(lvs)[:n].to(dtype).cpu().numpy()
    return mu, lv


@torch.inference_mode()
def decode_latents(model: nn.Module, z, batch_size: int = 1000, device="cuda") -> np.ndarray:
    """Decode latents ``[N, L]`` to data space in fixed-size chunks."""
    model, dev = _on(model, device)
    dtype = model.raw_log_vy.dtype
    z = np.asarray(z)
    n = z.shape[0]
    if n == 0:  # one zero row through the decoder fixes the output shape
        out = model.decode(torch.zeros((1, z.shape[1]), dtype=dtype, device=dev))
        return out.to(dtype).cpu().numpy()[:0]
    idx = _chunk_indices(n, batch_size)  # the same pad/chunk rule as encode
    zt = torch.as_tensor(z, dtype=dtype, device=dev)
    outs = [model.decode(zt[chunk]) for chunk in torch.from_numpy(idx).to(dev)]
    return torch.cat(outs)[:n].to(dtype).cpu().numpy()
